"""The port's graphed serving forward and its bench on the CPU.

A CUDA graph exists only on the card, so here ``GraphedForward`` and
``StreamingSR`` run their eager path (a CPU model), held against the JAX
package's ``StreamingSR`` and forward; the graph bookkeeping (capture on a
shape's first call, all graphs dropped when a weight changes) is driven
through a stand-in for the capture. The bench's chain step is held against
the same step written with the JAX forward. f32 tolerance 1e-5: the two
packages sum in other orders (tests/test_torch_port_model.py's bound).
Inputs and weights come from numpy seeds and the JAX init, bridged by
``train/jax_params.py``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2trans_tpu.config import Config as JaxConfig
from m2trans_tpu.models import init_m2trans as jax_init
from m2trans_tpu.models import m2trans_apply as jax_apply
from m2trans_tpu.models.m2trans import ComputePolicy as JaxPolicy
from m2trans_tpu.parallel.streaming import StreamingSR as JaxStreamingSR
from m2trans_tpu_torch import bench
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models import graphed
from m2trans_tpu_torch.models.graphed import GraphedForward, serving_forward, weights_key
from m2trans_tpu_torch.models.m2trans import (
    ComputePolicy,
    _ff_wb,
    init_m2trans,
    m2trans_apply_microbatched,
)
from m2trans_tpu_torch.parallel.streaming import StreamingSR
from m2trans_tpu_torch.train.jax_params import module_from_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _pair(scale=2, n_feats=8, n_blocks=1, seed=3):
    """The same weights in both packages."""
    fields = dict(scale=scale, n_feats=n_feats, n_blocks=n_blocks)
    jcfg, cfg = JaxConfig(**fields), Config(**fields)
    params = jax_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, params, cfg, module_from_params(params, cfg)


def _frames(n, shape, seed=0):
    return [np.random.default_rng(seed + i).uniform(0, 1, shape).astype(np.float32)
            for i in range(n)]


@pytest.mark.parametrize("depth", [1, 2])
def test_streaming_cpu_matches_jax_streaming(depth):
    """A CPU model's stream takes the eager path (no graph): its frames are
    the eager forward's, bit for bit, and the JAX StreamingSR's in f32."""
    jcfg, params, cfg, model = _pair()
    run = StreamingSR(model, cfg, policy=ComputePolicy(), depth=depth)
    assert run.graphed is None
    jrun = JaxStreamingSR(params, jcfg, policy=JaxPolicy(), depth=depth)
    frames = _frames(3, (1, 16, 24, 3)) + _frames(1, (2, 8, 16, 3), seed=7)
    outs = list(run.stream(frames))
    want = list(jrun.stream(frames))
    assert len(outs) == len(want) == 4
    for f, got, ref in zip(frames, outs, want):
        with torch.inference_mode():
            eager = m2trans_apply_microbatched(model, torch.from_numpy(f), cfg,
                                               ComputePolicy()).float().numpy()
        np.testing.assert_array_equal(got, eager)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("output_u8", [False, True])
def test_graphed_forward_on_cpu_runs_eager(output_u8):
    """On a CPU model GraphedForward is the eager serving forward: f32, or
    u8 as round(y * 255); nothing is captured or replayed."""
    _, _, cfg, model = _pair()
    gf = GraphedForward(model, cfg, ComputePolicy(), output_u8=output_u8)
    x = torch.from_numpy(_frames(1, (2, 16, 24, 3))[0])
    got = gf(x)
    with torch.inference_mode():
        y = m2trans_apply_microbatched(model, x, cfg, ComputePolicy())
        want = (torch.round(y.float() * 255.0).to(torch.uint8) if output_u8
                else y.float())
        assert torch.equal(serving_forward(model, x, cfg, ComputePolicy(), output_u8),
                           want)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    assert (gf.captures, gf.replays) == (0, 0)


def test_weights_key_changes_on_in_place_writes():
    """The key moves on an in-place copy into one weight and on
    load_state_dict, and not on a forward."""
    _, _, cfg, model = _pair()
    key = weights_key(model)
    assert len(key) == len(list(model.parameters()))
    with torch.inference_mode():
        m2trans_apply_microbatched(model, torch.zeros(1, 8, 8, 3), cfg,
                                   ComputePolicy())
    assert weights_key(model) == key
    with torch.no_grad():
        model.body[0].attn2.rel_h.copy_(model.body[0].attn2.rel_h * 2)
    moved = weights_key(model)
    assert moved != key
    model.load_state_dict(init_m2trans(cfg, seed=9).state_dict())
    assert weights_key(model) != moved


def test_weights_key_of_a_model_made_under_inference_mode():
    """Parameters made under inference_mode have no version counter: the
    key (the one ``numerics.prepared`` keeps its operands by) is taken all the same,
    the model serves through GraphedForward, and a parameter replaced by
    another tensor moves the key and rebuilds the cached operand."""
    _, _, cfg, ref = _pair()
    with torch.inference_mode():
        model = init_m2trans(cfg, seed=0)
        model.load_state_dict(ref.state_dict())
    assert all(p.is_inference() for p in model.parameters())
    key = weights_key(model)
    x = torch.from_numpy(_frames(1, (1, 16, 24, 3))[0])
    got = GraphedForward(model, cfg, ComputePolicy())(x)
    with torch.inference_mode():
        assert torch.equal(got, serving_forward(ref, x, cfg, ComputePolicy(), False))
    assert weights_key(model) == key
    blk = model.body[0]
    with torch.inference_mode():
        w0 = _ff_wb(blk, torch.float32)[0]
        ff = blk.feed_forward[0]
        ff.weight = torch.nn.Parameter(ff.weight * 2, requires_grad=False)
        w1 = _ff_wb(blk, torch.float32)[0]
    assert weights_key(model) != key
    assert torch.equal(w1, 2 * w0)


class _FakeGraph:
    """Replays by running the function again into the static output."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        self.out.copy_(self.fn())


def test_graphs_are_captured_per_shape_and_dropped_when_a_weight_changes(monkeypatch):
    """The bookkeeping of GraphedForward, with a stand-in for the capture
    that runs the function twice (the side-stream run, then the captured
    call) as the real one does: a shape is captured on its first call only,
    the launches counted are the captured call's; an in-place write to a
    weight keeps every graph (the replay reads the weights by pointer, as
    JAX's executable reads its arguments), while a weight replaced by
    another tensor drops them all, so the next call captures again and
    gives the new weights' output."""
    captured = []

    def fake_capture(fn, pool):
        assert pool == "pool"
        fn()
        out = fn()
        captured.append(tuple(out.shape))
        return _FakeGraph(fn, out), out

    monkeypatch.setattr(graphed, "capture", fake_capture)
    # the real handle needs a card
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    _, _, cfg, model = _pair()
    gf = GraphedForward(model, cfg, ComputePolicy())
    a, b = (torch.from_numpy(f) for f in _frames(2, (1, 16, 24, 3)))
    c = torch.from_numpy(_frames(1, (1, 8, 16, 3))[0])
    with torch.inference_mode():
        first = gf._entry(tuple(a.shape))
        assert gf._entry(tuple(a.shape)) is first and gf.captures == 1
        gf._entry(tuple(c.shape))
        assert gf.captures == 2 and len(gf._graphs) == 2
        assert gf.capture_launches[tuple(a.shape)] == {
            "cftm_branch": 0, "ff_conv": 0, "tail_band": 0, "in_stats": 0}  # f32: no kernel
    with torch.no_grad():
        model.head.bias.add_(0.25)
    with torch.inference_mode():
        entry = gf._entry(tuple(b.shape))
        assert entry is first and gf.captures == 2 and len(gf._graphs) == 2
        entry.inputs[0].copy_(b)
        entry.graph.replay()
        want = m2trans_apply_microbatched(model, b, cfg, ComputePolicy()).float()
    assert torch.equal(entry.out, want)
    model.head.bias = torch.nn.Parameter(model.head.bias.detach() * 2)
    with torch.inference_mode():
        entry = gf._entry(tuple(b.shape))
        assert entry is not first and gf.captures == 3 and len(gf._graphs) == 1
        entry.inputs[0].copy_(b)
        entry.graph.replay()
        want = m2trans_apply_microbatched(model, b, cfg, ComputePolicy()).float()
    assert torch.equal(entry.out, want)
    assert captured == [(1, 32, 48, 3), (1, 16, 32, 3), (1, 32, 48, 3)]


def test_bench_chain_step_matches_jax():
    """Two steps of the bench's chain, x <- x * 0.999 + mean(forward(x)) *
    1e-3, with the serving forward the bench replays on the card (eager on
    the CPU), at x4, n_feats 16, one block, f32, against the same two steps
    written with the JAX forward."""
    jcfg, params, cfg, model = _pair(scale=4, n_feats=16, seed=5)
    x0 = np.random.default_rng(4).uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    step = bench.chain_step(GraphedForward(model, cfg, ComputePolicy()))
    x = torch.from_numpy(x0)
    xj = jnp.asarray(x0)
    with torch.inference_mode():
        for _ in range(2):
            x = step(x)
            y = jax_apply(params, xj, jcfg, policy=JaxPolicy())
            xj = xj * 0.999 + y.astype(jnp.float32).mean() * 1e-3
    assert not np.array_equal(x.numpy(), x0)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=TOL, rtol=0)


def test_bench_cli_on_cpu_prints_one_json_line():
    """``python -m m2trans_tpu_torch.bench --device cpu`` at a small size:
    one JSON line with bench.py's keys, the measured baseline and the
    device, no device time on the CPU."""
    res = subprocess.run(
        [sys.executable, "-m", "m2trans_tpu_torch.bench", "--device", "cpu",
         "--n-blocks", "1", "--batch", "1", "--hw", "32"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "method", "ms_per_step_device",
                         "wall_mps", "ms_per_step_wall", "baseline_mps",
                         "vs_baseline", "device", "power_limit_w"}
    assert line["metric"] == "x4_sr_output_megapixels_per_sec_per_chip"
    assert line["method"] == "eager_slope" and line["unit"] == "MP/s"
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["ms_per_step_device"] is None
    assert line["value"] == line["wall_mps"]
    assert line["baseline_mps"] > 0


def test_bench_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--n-blocks", "1", "--batch", "1", "--hw", "32"])


@pytest.mark.parametrize("depth", [1, 2])
def test_infer_cli_on_cpu_runs_eager(tmp_path, capsys, depth):
    """The infer CLI on the CPU runs the forward eagerly: its PNGs are the
    eager forward's, rounded, and its report gives kernel launches (no
    graph fields)."""
    from PIL import Image

    from m2trans_tpu_torch import infer
    from m2trans_tpu_torch.train.convert import reference_state_dict

    _, _, cfg, model = _pair()
    pt = tmp_path / "model.pt"
    torch.save({"model_state_dict": reference_state_dict(model, True)}, pt)
    yml = tmp_path / "cfg.yml"
    yml.write_text("scale: 2\nn_feats: 8\nn_blocks: 1\ndtype: float32\n")
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(1)
    for name, hw in (("a.png", (20, 28)), ("b.png", (24, 24))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(frames / name)
    out = tmp_path / "out"
    infer.main(["--config", str(yml), "--model_path", str(pt), "--input",
                str(frames), "--output", str(out), "--device", "cpu", "--f32",
                "--depth", str(depth)])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "cuda_graphs" not in report and report["depth"] == depth
    assert report["kernel_launches"] == {"cftm_branch": 0, "ff_conv": 0,
                                         "tail_band": 0, "in_stats": 0}
    for name in ("a.png", "b.png"):
        with Image.open(frames / name) as img:
            x = torch.from_numpy(np.asarray(img, np.float32)[None] / 255.0)
        with torch.inference_mode():
            y = serving_forward(model, x, cfg, ComputePolicy(), False).numpy()
        want = np.clip(y[0] * 255.0 + 0.5, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(np.asarray(Image.open(out / name)), want)
