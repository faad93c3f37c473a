"""The port's validation graphs and metrics graphs, on the CPU.

A CUDA graph exists only on the card, so here the pieces that let the eval
graphs outlive a weight update and let the metrics run as a graph are
held to what they replace and to the JAX package: ``numerics.prepared``'s in-place
refresh of the kept operands (same storage, the values a fresh layout
gives); ``GraphedForward`` keeping its graphs across an in-place write
(the operands refreshed before the replay) and dropping them when a
parameter's storage moves, and running shapes beyond ``max_graphs``
eagerly, through a stand-in capture (a replay reruns the captured
function); the Trainer's validations over three epochs capturing each
frame shape once, their lines those of an eager validation of the same
weights; ``frame_metrics`` (the function a metrics graph runs) against
the eager metrics bit for bit and the JAX metrics (SSIM 1e-3, the others
as ``tests/test_torch_port_eval.py``: FSIM and GMSD atol 1e-5, PSNR rtol
1e-5), the metrics graphs' rows and the FSIM bank they hold; and the
set-end f64 sums against per-frame host sums, bit for bit.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from m2trans_tpu.metrics import fsim as jax_fsim
from m2trans_tpu.metrics import gmsd as jax_gmsd
from m2trans_tpu.train.evaluate import _psnr_ssim as jax_psnr_ssim
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data.benchmark import BenchmarkDataset
from m2trans_tpu_torch.metrics import fsim, frame_metrics, gmsd, sr_eval_metrics
from m2trans_tpu_torch.metrics.fsim import _pc_bank, bank_for_frame
from m2trans_tpu_torch.models import graphed
from m2trans_tpu_torch.models.graphed import GraphedForward, serving_forward
from m2trans_tpu_torch.models.m2trans import (
    ComputePolicy,
    _ff_wb,
    _qkv_w,
    init_m2trans,
    policy_from_config,
)
from m2trans_tpu_torch.models.numerics import cached_operands
from m2trans_tpu_torch.ops.kernels.ff_conv import ff_weight_hwio
from m2trans_tpu_torch.train.evaluate import (
    GraphedMetrics,
    eval_runner,
    evaluate_all,
    evaluate_dataset,
    metrics_runner,
    set_means,
)
from m2trans_tpu_torch.train.loop import Trainer

from test_torch_port_eval import SSIM_TOL, _pair
from test_torch_port_train import tree_kw, write_tree

BF16 = ComputePolicy(torch.bfloat16, False)


class _FakeGraph:
    """Replays by running the captured function again into its static
    output, after ``check`` (what must hold when a replay starts)."""

    def __init__(self, fn, out, check):
        self.fn, self.out, self.check = fn, out, check

    def replay(self):
        self.check()
        self.out.copy_(self.fn())


def _operands_fresh(model):
    """Every kept operand equals a fresh layout of its parameters."""
    for op in cached_operands(model):
        for o, v in zip(op.ops, op.layout(*(p.detach() for p in op.params))):
            assert torch.equal(o, v.to(op.dtype).contiguous())


@pytest.fixture
def stand_in(monkeypatch):
    """A capture that runs the function twice (the side-stream run, then
    the captured call) and returns a graph whose replay checks the kept
    operands of the models in ``models`` and reruns it."""
    models = []

    def fake_capture(fn, pool):
        fn()
        out = fn()

        def check():
            for m in models:
                _operands_fresh(m)
        return _FakeGraph(fn, out, check), out

    monkeypatch.setattr(graphed, "capture", fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    return models


# ---------------------------------------------------------------------------
# operands refreshed in place
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_prepared_refreshes_operands_in_place(mode):
    """After a write into the weights in place the kept operands (bf16 qkv
    weight, K3's HWIO weight and bias) keep their storage and hold the
    layout of the new weights, built under ``no_grad`` or
    ``inference_mode`` alike (they are plain tensors); a replaced
    parameter gets new storage."""
    cfg = Config(scale=2, n_feats=16, n_blocks=1)
    model = init_m2trans(cfg, seed=0)
    blk, tb = model.body[0], model.body[0].attn3
    ctx = torch.no_grad if mode == "no_grad" else torch.inference_mode
    with ctx():
        q0, (w0, b0) = _qkv_w(tb, torch.bfloat16), _ff_wb(blk, torch.bfloat16)
    assert not any(t.is_inference() for t in (q0, w0, b0))
    ptrs = [t.data_ptr() for t in (q0, w0, b0)]
    with torch.no_grad():
        tb.qkv_conv.weight.mul_(1.5)
        blk.feed_forward[0].weight.add_(0.125)
        blk.feed_forward[0].bias.sub_(0.5)
    with ctx():
        q1, (w1, b1) = _qkv_w(tb, torch.bfloat16), _ff_wb(blk, torch.bfloat16)
    assert [t.data_ptr() for t in (q1, w1, b1)] == ptrs
    assert q1 is q0 and w1 is w0 and b1 is b0
    w = tb.qkv_conv.weight.detach()
    assert torch.equal(q1, w.reshape(w.shape[0], w.shape[1]).t().to(torch.bfloat16)
                       .contiguous())
    ff = blk.feed_forward[0]
    assert torch.equal(w1, ff_weight_hwio(ff.weight.detach(), torch.bfloat16))
    assert torch.equal(b1, ff.bias.detach().to(torch.bfloat16))
    ff.weight = torch.nn.Parameter(ff.weight.detach() * 2)
    with ctx():
        w2, _ = _ff_wb(blk, torch.bfloat16)
    assert w2.data_ptr() != ptrs[1]
    assert torch.equal(w2, ff_weight_hwio(ff.weight.detach(), torch.bfloat16))


def test_graphs_outlive_in_place_writes_and_not_a_moved_weight(stand_in):
    """bf16 (plain kernels on the CPU): after an optimizer-like write and
    an in-place ``load_state_dict`` the graphs are replayed, not captured
    again, their operands refreshed before the replay (the stand-in checks
    it) and the output the new weights' eager forward; a parameter
    replaced by another tensor drops every graph."""
    cfg = Config(scale=2, n_feats=16, n_blocks=1)
    model = init_m2trans(cfg, seed=0)
    stand_in.append(model)
    gf = GraphedForward(model, cfg, BF16)
    gf.graphs = True
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 16, 24, 3))
                         .astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 8, 16, 3))
                         .astype(np.float32))

    def check(inp):
        with torch.inference_mode():
            got = gf(inp).clone()
            assert torch.equal(got, serving_forward(model, inp, cfg, BF16, False))

    check(x)
    check(y)
    held = [op for e in gf._graphs.values() for op in e.held]
    assert gf.captures == 2 and held and all(op.dtype == torch.bfloat16 for op in held)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.01)
    check(x)
    model.load_state_dict(init_m2trans(cfg, seed=5).state_dict())
    check(y)
    check(x)
    assert (gf.captures, gf.replays, gf.refreshes) == (2, 5, 2)
    model.body[0].attn1.rel_h = torch.nn.Parameter(model.body[0].attn1.rel_h.detach() + 1)
    check(x)
    assert gf.captures == 3 and len(gf._graphs) == 1


def test_shapes_beyond_max_graphs_run_eagerly(stand_in):
    cfg = Config(scale=2, n_feats=16, n_blocks=1)
    model = init_m2trans(cfg, seed=0)
    gf = GraphedForward(model, cfg, ComputePolicy(), max_graphs=1)
    gf.graphs = True
    a, b = (torch.from_numpy(np.random.default_rng(i).uniform(0, 1, s).astype(np.float32))
            for i, s in enumerate([(1, 16, 16, 3), (1, 8, 24, 3)]))
    with torch.inference_mode():
        for x in (a, b, b, a, b):
            assert torch.equal(gf(x), serving_forward(model, x, cfg, ComputePolicy(), False))
    assert (gf.captures, gf.replays, gf.eager_calls) == (1, 2, 3)


# ---------------------------------------------------------------------------
# validations in a training run
# ---------------------------------------------------------------------------


class _Writer:
    def __init__(self):
        self.images, self.scalars = [], []

    def add_image(self, tag, img, step, dataformats="HWC"):
        self.images.append((tag, img.shape, step))

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_validations_capture_each_shape_once_in_a_run(tmp_path, monkeypatch, capsys,
                                                      stand_in, dtype):
    """A CPU Trainer of three epochs with ``test_every`` 1 on a set of two
    frame shapes, its eval and metrics runners graphed through the stand-in
    capture: the first validation captures each shape's forward and
    metrics (and the training panel its shape), later ones capture
    nothing and replay; each validation's numbers are those of an eager
    validation of the same weights, and so are its printed lines."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # the trainer tees stdout
    root = write_tree(tmp_path / "data", np.random.default_rng(3))
    hr = np.random.default_rng(4).integers(0, 256, (48, 32, 3), dtype=np.uint8)
    Image.fromarray(hr).save(root / "benchmark/UI5/HR/b1.jpg")
    Image.fromarray(hr[::2, ::2]).save(root / "benchmark/UI5/LR_bicubic/X2/b1x2.jpg")
    cfg = Config(**dict(tree_kw(root, tmp_path), epochs=3, dtype=dtype,
                        use_pallas=dtype == "bfloat16", cutmix=True))
    trainer = Trainer(cfg, device="cpu", writer=_Writer())
    stand_in.append(trainer.model)
    runner = eval_runner(trainer.model, cfg, policy_from_config(cfg))
    metrics = metrics_runner(trainer.model, cfg, False)
    runner.graphs = metrics.graphs = True
    counts, eager = [], []
    validate = trainer._validate

    def recorded(epoch):
        validate(epoch)
        counts.append((runner.captures, runner.replays, metrics.captures, metrics.replays))
        eager.append(evaluate_all(trainer.model, cfg, trainer.eval_sets, graphs=False))

    trainer._validate = recorded
    stat = trainer.run()
    assert counts == [(3, 3, 2, 2), (3, 6, 2, 4), (3, 9, 2, 6)]
    assert runner.eager_calls == metrics.eager_calls == 0
    name = "CCA-US"
    assert stat[name]["psnrs"] == [e[name]["psnr"] for e in eager]
    assert stat[name]["ssims"] == [e[name]["ssim"] for e in eager]
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[")]
    assert len(lines) == 3
    for ln, e in zip(lines, eager):
        assert ln.startswith(f"[{name}-X2], PSNR/SSIM: {e[name]['psnr']:.4f}/"
                             f"{e[name]['ssim']:.4f} ")


# ---------------------------------------------------------------------------
# the metrics graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 48, 48, 3), (1, 34, 46, 3)])
@pytest.mark.parametrize("sr_dtype", [torch.float32, torch.bfloat16])
def test_frame_metrics_equal_eager_and_jax(shape, sr_dtype):
    """The row a metrics graph computes equals the eager metrics bit for
    bit, and the JAX jitted metrics (``_psnr_ssim``, ``fsim``, ``gmsd``) on
    the same arrays within the eval tests' tolerances."""
    hr_np, sr_np = _pair(shape, seed=shape[2])
    hr = torch.from_numpy(hr_np)
    sr = torch.from_numpy(sr_np).to(sr_dtype)
    kw = dict(scale=2, colors=3, rgb_range=1.0)
    row = frame_metrics(sr, hr, full_metrics=True, **kw)
    m = sr_eval_metrics(sr, hr, **kw)
    want = torch.stack([m["psnr"], m["ssim"], fsim(hr, sr)[0], gmsd(hr, sr)[0]])
    assert row.dtype == torch.float32 and torch.equal(row, want)
    short = frame_metrics(sr, hr, full_metrics=False, **kw)
    assert torch.equal(short[:2], row[:2]) and not short[2:].any()
    jsr = jnp.asarray(sr.float().numpy()).astype(
        jnp.bfloat16 if sr_dtype == torch.bfloat16 else jnp.float32)
    jhr = jnp.asarray(hr_np)
    jm = jax_psnr_ssim(jsr, jhr, **kw)
    assert float(row[0]) == pytest.approx(float(jm["psnr"]), rel=1e-5)
    assert abs(float(row[1]) - float(jm["ssim"])) <= SSIM_TOL
    assert abs(float(row[2]) - float(jax_fsim(jhr, jsr)[0])) <= 1e-5
    assert abs(float(row[3]) - float(jax_gmsd(jhr, jsr)[0])) <= 1e-5


def test_metrics_graphs_give_the_eager_rows_and_hold_their_bank(stand_in):
    """Through the stand-in capture: a graph an HR shape gives the eager
    row (bf16 SR copied into its f32 static SR), holds the FSIM filter
    bank it reads, which the cache may drop, and shapes beyond
    ``max_graphs`` run eagerly."""
    cfg = Config(scale=2)
    gm = GraphedMetrics(cfg, True, "cpu", max_graphs=2)
    gm.graphs = True
    shapes = [(1, 40, 40, 3), (1, 36, 44, 3), (1, 40, 40, 3), (1, 30, 30, 3)]
    for i, shape in enumerate(shapes):
        hr_np, sr_np = _pair(shape, seed=i)
        hr, sr = torch.from_numpy(hr_np), torch.from_numpy(sr_np).bfloat16()
        want = frame_metrics(sr, hr, scale=2, full_metrics=True)
        assert torch.equal(gm(sr, hr), want), shape
    assert (gm.captures, gm.replays, gm.eager_calls) == (2, 3, 1)
    entry = gm._graphs[(1, 40, 40, 3)]
    assert entry.held[0] is bank_for_frame(40, 40, "cpu")[0]
    _pc_bank.cache_clear()
    assert entry.held[0].shape == (4, 4, 40, 40)


def test_set_end_sums_equal_per_frame_host_sums():
    """The rows summed at the set's end in f64, frame by frame, are the
    sums of per-frame host reads, bit for bit; and ``evaluate_dataset``
    prints what the earlier per-frame form computed."""
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(rng.normal(30, 5, (37, 4)).astype(np.float32))
    sums = [0.0] * 4
    for r in rows:
        for k in range(4):
            sums[k] += float(r[k])
    assert set_means(rows) == {k: s / 37 for k, s in
                               zip(("psnr", "ssim", "fsim", "gmsd"), sums)}


def test_evaluate_dataset_equals_the_per_frame_form(tmp_path):
    root = tmp_path / "UI5"
    (root / "HR").mkdir(parents=True)
    (root / "LR_bicubic" / "X2").mkdir(parents=True)
    for i, (h, w) in enumerate([(24, 20), (16, 28), (24, 20)]):
        x, _ = _pair((1, 2 * h, 2 * w, 3), seed=10 + i)
        u8 = (x[0] * 255).astype(np.uint8)
        Image.fromarray(u8).save(root / "HR" / f"e{i}.jpg", quality=95)
        Image.fromarray(u8[::2, ::2]).save(root / "LR_bicubic" / "X2" / f"e{i}x2.jpg",
                                           quality=95)
    ds = BenchmarkDataset(str(root / "HR"), str(root / "LR_bicubic"), scale=2)
    cfg = Config(scale=2, n_feats=16, n_blocks=1)
    model = init_m2trans(cfg, seed=2)
    got = evaluate_dataset(model, cfg, ds, full_metrics=True)
    sums = {"psnr": 0.0, "ssim": 0.0, "fsim": 0.0, "gmsd": 0.0}
    with torch.inference_mode():
        for lr, hr, _ in ds:
            from m2trans_tpu_torch.models.m2trans import m2trans_apply

            sr = m2trans_apply(model, torch.from_numpy(lr), cfg)
            hr_t = torch.from_numpy(hr)
            sums["fsim"] += float(fsim(hr_t, sr)[0])
            sums["gmsd"] += float(gmsd(hr_t, sr)[0])
            m = sr_eval_metrics(sr, hr_t, scale=2)
            sums["psnr"] += float(m["psnr"])
            sums["ssim"] += float(m["ssim"])
    n = len(ds)
    assert got == {"psnr": round(sums["psnr"] / n + 5e-3, 2),
                   "ssim": round(sums["ssim"] / n + 5e-5, 4),
                   "fsim": round(sums["fsim"] / n + 5e-5, 4),
                   "gmsd": round(sums["gmsd"] / n + 5e-5, 4)}
