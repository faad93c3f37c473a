"""HAT in the port (``models/hat.py``, ``ops/kernels/hat_attn.py``) against
the benchmark's plain reference (``h100bench/reference/hat.py``) on the CPU,
at a small size with seeded weights in the released layout: embed_dim 24, 2
heads (head dim 12), window 4 (OCA key window 6), two groups of two HABs,
frames that are no multiple of the window.

Tolerances: the port's f32 path and the reference make the same f32
products in another order and layout (the qkv and output projections on the
map rather than on windows, the windows gathered by index rather than
rolled and partitioned), so they agree to a few f32 ulps of the output
(2e-6, as ``h100bench/tests/test_bench_reference.py`` holds M2Trans) and of
an attention's output (1e-6). The CUDA kernels' index arithmetic
(``csrc/hat_attn.cu``) is mirrored by ``hat_attn.bias_rows`` and held here
to the released indices; the kernels themselves run only on the card
(``tests/test_torch_port_cuda.py``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from h100bench.reference import hat as ref
from m2trans_tpu_torch.config import Config, load_config
from m2trans_tpu_torch.models import hat as port
from m2trans_tpu_torch.models import served
from m2trans_tpu_torch.models.numerics import ComputePolicy
from m2trans_tpu_torch.ops.kernels import hat_attn, row_norm
from m2trans_tpu_torch.ops.kernels.swin_attn import window_attention_plain
from m2trans_tpu_torch.parallel.streaming import StreamingSR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 33 + 7
TINY = {"scale": 4, "colors": 3, "n_feats": 24, "n_blocks": 2, "num_heads": 2,
        "depths": [2, 2], "window_size": 4, "squeeze_factor": 6, "num_feat": 16}
PORT_FIELDS = ("scale", "colors", "n_feats", "n_blocks", "num_heads")


def _cfg(**kw):
    return Config(model="HAT", **{k: TINY[k] for k in PORT_FIELDS},
                  extras={k: v for k, v in TINY.items() if k not in PORT_FIELDS}, **kw)


def _port(sd):
    with torch.device("meta"):
        net = port.HAT(_cfg())
    return port.load_hat_state_dict(net.to_empty(device="cpu"), sd)


def _maps(seed, shape, n=3):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen) for _ in range(n)]


def test_forward_matches_the_reference():
    """The f32 path, with the reflect pad to a multiple of the window and
    the crop, on a 10 x 13 frame."""
    sd = ref.state_dict(TINY, SEED, "cpu")
    net = _port(sd)
    x = torch.rand(2, 10, 13, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = port.hat_apply(net, x, _cfg(), ComputePolicy())
        want = ref.forward(sd, x, TINY)
    assert got.shape == want.shape == (2, 40, 52, 3)
    assert (got - want).abs().max() < 2e-6


@pytest.mark.parametrize("shift", [0, 2])
def test_window_attention_matches_the_reference(shift):
    """SW-MSA's plain version (the windows gathered by index) against the
    reference's roll / window_partition / calculate_mask."""
    q, k, v = _maps(shift, (2, 8, 12, 24))
    table = torch.randn(49, 2, generator=torch.Generator().manual_seed(9))
    got = window_attention_plain(q, k, v, table, 2, 4, shift)
    want = ref.sw_msa(q, k, v, table, 2, 4, shift, ref.F32)
    assert (got - want).abs().max() < 1e-6


@pytest.mark.parametrize("hw", [(8, 12), (4, 4)])
def test_overlapping_attention_matches_the_reference(hw):
    """OCA's plain version against F.unfold's zero padding: every window
    of these maps lies on the border, so part of each key window is zero
    keys and values that stay in the softmax."""
    q, k, v = _maps(hw[1], (2, *hw, 24))
    table = torch.randn(81, 2, generator=torch.Generator().manual_seed(8))
    got = hat_attn.overlap_attention_plain(q, k, v, table, 2, 4, 6)
    want = ref.oca(q, k, v, table, 2, 4, 6, ref.F32)
    assert (got - want).abs().max() < 1e-6
    assert torch.equal(hat_attn.overlap_attention(q, k, v, table, 2, 4, 6), got)  # CPU: plain


@pytest.mark.parametrize("window,key_window", [(16, 16), (16, 24), (4, 6)])
def test_kernel_bias_layout_is_the_released_index(window, key_window):
    """``bias_rows`` (the kernels' shared-memory bias column, indexed by (kr
    - qr + w - 1) * P + (kc - qc + w - 1)) gives each (query, key) pair the
    table row of the released index: Swin's for SW-MSA, calculate_rpi_oca
    wrapped for OCA."""
    p = window + key_window - 1
    qr, qc = np.divmod(np.arange(window ** 2), window)
    kr, kc = np.divmod(np.arange(key_window ** 2), key_window)
    entry = (kr[None] - qr[:, None] + window - 1) * p + (kc[None] - qc[:, None] + window - 1)
    got = hat_attn.bias_rows(window, key_window)[entry]
    released = (ref.rpi_sa(window) if key_window == window
                else ref.rpi_oca(window, key_window) % (p * p)).numpy()
    assert np.array_equal(got, released)
    if key_window != window:
        assert np.array_equal(hat_attn.oca_relative_position_index(window, key_window), released)
        assert sorted(set(released.reshape(-1))) == list(range(p * p))  # a bijection


def test_release_state_dict_round_trip(tmp_path):
    """A ``.pth`` in the release layout (``params_ema``, the two index
    buffers) loads through ``load_params_any`` and writes back the same
    tensors; a wrong index buffer is refused."""
    from m2trans_tpu_torch.train.checkpoint import load_params_any

    sd = ref.state_dict(TINY, SEED, "cpu")
    path = tmp_path / "HAT_tiny.pth"
    torch.save({"params_ema": sd}, path)
    net = load_params_any(str(path), _cfg())
    back = port.release_state_dict(net)
    assert set(back) == set(sd) == {n for n, _, _ in ref.param_shapes(TINY)}
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    assert back["relative_position_index_OCA"].min() < 0  # as released, unwrapped
    bad = dict(sd, relative_position_index_OCA=sd["relative_position_index_OCA"] % 81)
    torch.save({"params": bad}, path)
    with pytest.raises(ValueError, match="relative_position_index_OCA"):
        load_params_any(str(path), _cfg())


def test_init_hat_follows_the_release_init():
    net = port.init_hat(_cfg(), seed=3)
    blk = net.layers[0].residual_group.blocks[1]
    assert blk.shift == 2 and net.layers[0].residual_group.blocks[0].shift == 0
    assert float(blk.attn.qkv.bias.detach().abs().max()) == 0.0
    assert float(blk.norm1.weight.detach().min()) == 1.0
    assert float(blk.attn.relative_position_bias_table.detach().abs().max()) <= 2.0
    assert torch.equal(net.relative_position_index_SA, ref.rpi_sa(4))


def test_streaming_serves_hat_on_the_cpu():
    """``StreamingSR`` with HAT: the stream's frames are the eager
    forward's (bf16 with the kernels' wrappers, their plain versions on the
    CPU); a mesh is refused; HAT's kernels and the LayerNorm's are what a
    capture counts."""
    sd = ref.state_dict(TINY, SEED, "cpu")
    net, cfg = _port(sd), _cfg()
    frames = [np.random.default_rng(i).random((2, 8, 12, 3), np.float32) for i in range(3)]
    server = StreamingSR(net, cfg, depth=2)
    assert server.graphed is None
    got = list(server.stream(frames))
    policy = StreamingSR.default_policy()
    with torch.no_grad():
        for f, g in zip(frames, got):
            want = port.hat_apply(net, torch.from_numpy(f), cfg, policy).float().numpy()
            assert g.shape == (2, 32, 48, 3) and np.array_equal(g, want)
            ref_out = ref.forward(sd, torch.from_numpy(f), TINY).numpy()
            assert np.abs(g - ref_out).mean() < 5e-3  # bf16 against f32
    assert served.of(net) is served.SERVED["HAT"]
    assert served.of(net).counted == {"hat_wattn": hat_attn.window_attention_16,
                                      "hat_oca": hat_attn.overlap_attention,
                                      "row_norm": row_norm.row_norm}
    from m2trans_tpu_torch.parallel.mesh import SpaceMesh

    with pytest.raises(ValueError, match="HAT runs on one device"):
        StreamingSR(net, cfg, mesh=SpaceMesh(n=2, rank=0))


def test_config_keys_and_yml():
    """The yml beside the port selects HAT with the published sizes; sizes
    the port does not serve are refused."""
    cfg = load_config(os.path.join(ROOT, "m2trans_tpu_torch", "configs", "HAT_SRx4.yml"))
    s = port.HATSizes.from_config(cfg)
    assert (cfg.model, s.embed_dim, s.groups, s.depth, s.heads, s.window, s.key_window,
            s.compress_ratio, s.squeeze_factor, s.num_feat) == (
        "HAT", 180, 6, 6, 6, 16, 24, 3, 30, 64)
    with pytest.raises(ValueError, match="depths"):
        port.HATSizes.from_config(cfg.replace(extras=dict(cfg.extras, depths=[6, 4])))
    with pytest.raises(ValueError, match="embed_dim"):
        port.HATSizes.from_config(cfg.replace(extras=dict(cfg.extras, embed_dim=96)))


def test_infer_cli_serves_hat(tmp_path):
    """``python -m m2trans_tpu_torch.infer`` on a HAT yml and a released-
    layout ``.pth`` on the CPU: PNGs of 4x the frames, the eager forward's."""
    from PIL import Image

    sd = ref.state_dict(TINY, SEED, "cpu")
    torch.save({"params_ema": sd}, tmp_path / "hat.pth")
    yml = tmp_path / "hat.yml"
    yml.write_text("model: HAT\n" + "".join(f"{k}: {json.dumps(v)}\n" for k, v in TINY.items())
                   + "dtype: bfloat16\nuse_pallas: true\n")
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(9, 11), (9, 11)]):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(src / f"{i}.png")
    res = subprocess.run(
        [sys.executable, "-m", "m2trans_tpu_torch.infer", "--config", str(yml), "--model_path",
         str(tmp_path / "hat.pth"), "--input", str(src), "--output", str(tmp_path / "out"),
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["frames"] == 2 and report["kernel_launches"] == {"hat_wattn": 0, "hat_oca": 0,
                                                                     "row_norm": 0}
    net, cfg = _port(sd), _cfg(dtype="bfloat16", use_pallas=True)
    x = np.asarray(Image.open(src / "0.png"), np.float32)[None] / 255.0
    with torch.no_grad():
        y = port.hat_apply(net, torch.from_numpy(x), cfg).float().numpy()[0]
    want = np.clip(y * 255.0 + 0.5, 0, 255).astype(np.uint8)
    got = np.asarray(Image.open(tmp_path / "out" / "0.png"))
    assert got.shape == (36, 44, 3) and np.array_equal(got, want)
