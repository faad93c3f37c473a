"""MambaIR in the port (``models/mambair.py``, ``ops/kernels/ss2d_scan.py``)
against the benchmark's plain reference (``h100bench/reference/mambair.py``)
on the CPU, at a small size with seeded weights in the released layout:
embed_dim 36 (d_inner 72, dt rank 3, d_state 16), two groups of two
VSSBlocks, frames that are not square.

Tolerances: the port's f32 path and the reference make the same f32
products in another order and layout (x_proj once over the map rather than
over four permuted copies, dt_proj inside the scan, the directions gathered
by index rather than flipped and transposed, another chunking of the scan),
so they agree to a few f32 ulps of the output (2e-6, as the HAT and M2Trans
tests hold their ports). The bf16 path rounds every activation between ops
to bf16 (``models/mambair.py``'s docstring), so it is held to the mean
|difference| of bf16 paths against f32 (5e-3, as HAT's stream test holds
its bf16 frames). The scans are held to 1e-5 of their largest output: f32
recurrences over a few hundred steps, summed in another order. The CUDA
kernel runs only on the card (``tests/test_torch_port_cuda.py``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from h100bench.reference import mambair as ref
from m2trans_tpu_torch.config import Config, load_config
from m2trans_tpu_torch.models import mambair as port
from m2trans_tpu_torch.models import served
from m2trans_tpu_torch.models.numerics import ComputePolicy
from m2trans_tpu_torch.ops.kernels import row_norm, ss2d_scan
from m2trans_tpu_torch.parallel.streaming import StreamingSR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 33 + 7
TINY = {"scale": 4, "colors": 3, "n_feats": 36, "n_blocks": 2, "depths": [2, 2],
        "d_state": 16, "squeeze_factor": 6, "num_feat": 16}
PORT_FIELDS = ("scale", "colors", "n_feats", "n_blocks")


def _cfg(**kw):
    return Config(model="MambaIR", **{k: TINY[k] for k in PORT_FIELDS},
                  extras={k: v for k, v in TINY.items() if k not in PORT_FIELDS}, **kw)


def _port(sd):
    with torch.device("meta"):
        net = port.MambaIR(_cfg())
    return port.load_mambair_state_dict(net.to_empty(device="cpu"), sd)


@pytest.fixture(scope="module")
def seeded():
    sd = ref.state_dict(TINY, SEED, "cpu")
    return sd, _port(sd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_matches_the_reference(seeded, dtype):
    """The f32 path to f32 ulps, the bf16 path (plain scan) to bf16's mean
    error, on a 10 x 13 frame."""
    sd, net = seeded
    x = torch.rand(2, 10, 13, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = port.mambair_apply(net, x, _cfg(), ComputePolicy(dtype, True)).float()
        want = ref.forward(sd, x, TINY)
    assert got.shape == want.shape == (2, 40, 52, 3)
    d = (got - want).abs()
    if dtype == torch.float32:
        assert float(d.max()) < 2e-6
    else:
        assert float(d.mean()) < 5e-3


def _case(seed, b, h, w, d, rank, n=16):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, d, generator=g)
    xdbl = torch.randn(b, h, w, 4, rank + 2 * n, generator=g)
    dt_w = torch.randn(4, d, rank, generator=g) * rank ** -0.5
    dt_b = torch.randn(4, d, generator=g) - 3.0
    a = -torch.exp(torch.randn(4, d, n, generator=g))
    ds = torch.randn(4, d, generator=g)
    return x, xdbl, dt_w, dt_b, a, ds


def _loop(x, xdbl, dt_w, dt_b, a, ds):
    """The four-way scan one token at a time, each order made by flipping
    and transposing the map, each output put back the same way."""
    b, h, w, d = x.shape
    n, rank = a.shape[-1], dt_w.shape[-1]
    seqs = [lambda t: t.reshape(b, h * w, -1),
            lambda t: t.transpose(1, 2).reshape(b, h * w, -1)]
    backs = [lambda y: y.reshape(b, h, w, d),
             lambda y: y.reshape(b, w, h, d).transpose(1, 2)]
    out = torch.zeros(b, h, w, d)
    for k in range(4):
        o, rev = k % 2, k >= 2
        u, p = seqs[o](x), seqs[o](xdbl[..., k, :])
        if rev:
            u, p = u.flip(1), p.flip(1)
        delta = F.softplus(p[..., :rank] @ dt_w[k].T + dt_b[k])
        bm, cm = p[..., rank:rank + n], p[..., rank + n:]
        hs = torch.zeros(b, d, n)
        ys = []
        for t in range(h * w):
            hs = torch.exp(delta[:, t, :, None] * a[k]) * hs + \
                (delta[:, t] * u[:, t])[..., None] * bm[:, t, None]
            ys.append((hs * cm[:, t, None]).sum(-1) + ds[k] * u[:, t])
        y = torch.stack(ys, 1)
        out += backs[o](y.flip(1) if rev else y)
    return out


@pytest.mark.parametrize("chunk", [64, 7])
def test_scan_plain_matches_a_loop_in_all_four_orders(chunk):
    """The plain version (tokens gathered by index, chunked with a carried
    state) against a token-by-token loop over flipped and transposed maps, on
    a 5 x 7 frame (H != W: a swapped transpose would not be seen on a square
    one), with a chunk that divides no order's L = 35 and one longer than it."""
    args = _case(11, 2, 5, 7, 24, 3)
    got = ss2d_scan.ss2d_scan_plain(*args, chunk=chunk)
    want = _loop(*args)
    assert got.shape == (2, 5, 7, 24)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(ss2d_scan.ss2d_scan(*args), ss2d_scan.ss2d_scan_plain(*args))  # CPU: plain


def test_each_order_reads_its_own_pixels():
    """Only direction k's projections nonzero: the output is that order's
    scan alone, different for each k on a non-square frame."""
    x, xdbl, dt_w, dt_b, a, ds = _case(12, 1, 3, 5, 24, 2)
    outs = []
    for k in range(4):
        mask = torch.zeros(4, 1)
        mask[k] = 1.0
        got = ss2d_scan.ss2d_scan_plain(x, xdbl * mask, dt_w, dt_b, a, ds * mask, chunk=4)
        want = _loop(x, xdbl * mask, dt_w, dt_b, a, ds * mask)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        outs.append(got)
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.allclose(outs[i], outs[j])


def test_direction_pixels():
    """Row-major, column-major and both reversed, on a 2 x 3 frame."""
    got = ss2d_scan.direction_pixels(2, 3)
    assert got.tolist() == [[0, 1, 2, 3, 4, 5], [0, 3, 1, 4, 2, 5],
                            [5, 4, 3, 2, 1, 0], [5, 2, 4, 1, 3, 0]]


def test_reference_chunked_scan_matches_its_loop():
    """The reference's chunked selective scan against its token-by-token
    loop, with a chunk (10) that does not divide L (37)."""
    g = torch.Generator().manual_seed(3)
    b, kd, length, n = 2, 8, 37, 16
    u, dl = torch.randn(b, kd, length, generator=g), torch.randn(b, kd, length, generator=g)
    a = -torch.exp(torch.randn(kd, n, generator=g))
    bs, cs = torch.randn(b, 4, n, length, generator=g), torch.randn(b, 4, n, length, generator=g)
    d, db = torch.randn(kd, generator=g), torch.randn(kd, generator=g)
    got = ref.selective_scan(u, dl, a, bs, cs, d, db, chunk=10)
    want = ref.scan_loop(u, dl, a, bs, cs, d, db)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_kernel_refuses_what_it_does_not_take():
    """The wrapper's checks (they run before any launch): bf16, D a
    multiple of 24, N = 16, R a multiple of 4 up to 16, forward only."""
    x, xdbl, dt_w, dt_b, a, ds = _case(13, 1, 4, 4, 24, 4)
    xb, pb = x.bfloat16(), xdbl.bfloat16()
    ss2d_scan._check(xb, pb, dt_w, dt_b, a, ds)
    with pytest.raises(ValueError, match="bf16"):
        ss2d_scan._check(x, pb, dt_w, dt_b, a, ds)
    with pytest.raises(ValueError, match="multiple of 24"):
        ss2d_scan._check(xb[..., :16].contiguous(), pb, dt_w[:, :16].contiguous(),
                         dt_b[:, :16].contiguous(), a[:, :16].contiguous(),
                         ds[:, :16].contiguous())
    with pytest.raises(ValueError, match="A must be"):
        ss2d_scan._check(xb, pb, dt_w, dt_b, a[..., :8], ds)
    with pytest.raises(ValueError, match="multiple of 4"):
        ss2d_scan._check(xb, pb, torch.zeros(4, 24, 20), dt_b, a, ds)
    with pytest.raises(ValueError, match="forward only"):
        ss2d_scan._check(xb, pb, dt_w.requires_grad_(True), dt_b, a, ds)


def test_release_state_dict_round_trip(tmp_path):
    """A ``.pth`` in the release layout (``params``, ``params_ema`` or a
    bare dict, with or without ``module.``) loads through
    ``load_params_any`` and writes back the same tensors."""
    from m2trans_tpu_torch.models.sr_blocks import release_state_dict
    from m2trans_tpu_torch.train.checkpoint import load_params_any

    sd = ref.state_dict(TINY, SEED, "cpu")
    path = tmp_path / "MambaIR_tiny.pth"
    for ckpt in ({"params": sd}, {"params_ema": sd}, {f"module.{k}": v for k, v in sd.items()}):
        torch.save(ckpt, path)
        back = release_state_dict(load_params_any(str(path), _cfg()))
        assert set(back) == set(sd) == {n for n, _, _ in ref.param_shapes(TINY)}
        assert all(torch.equal(back[k], sd[k]) for k in sd)
    torch.save({"params_ema": {k: v + 1.0 for k, v in sd.items()}, "params": sd}, path)
    back = release_state_dict(load_params_any(str(path), _cfg()))  # params first, as released
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_init_mambair_follows_the_release_init():
    net = port.init_mambair(_cfg(), seed=3)
    ss = net.layers[0].residual_group.blocks[1].self_attention
    n, di, rank = 16, 72, 3
    assert torch.equal(ss.A_logs[5], torch.log(torch.arange(1, n + 1, dtype=torch.float32)))
    assert torch.equal(ss.Ds.detach(), torch.ones(4 * di))
    assert float(ss.x_proj_weight.detach().abs().max()) <= di ** -0.5
    assert float(ss.dt_projs_weight.detach().abs().max()) <= rank ** -0.5
    dt = F.softplus(ss.dt_projs_bias.detach())
    assert 1e-4 - 1e-7 <= float(dt.min()) and float(dt.max()) <= 0.1 + 1e-6
    assert ss.in_proj.bias is None and ss.out_proj.bias is None
    assert ss.conv2d.groups == di and ss.conv2d.bias is not None


def test_streaming_serves_mambair_on_the_cpu(seeded):
    """``StreamingSR`` with MambaIR: the stream's frames are the eager
    forward's (bf16 with the scan wrapper, its plain version on the CPU); a
    mesh is refused; the scan and the LayerNorm are what a capture counts."""
    sd, net = seeded
    cfg = _cfg()
    frames = [np.random.default_rng(i).random((2, 8, 12, 3), np.float32) for i in range(3)]
    server = StreamingSR(net, cfg, depth=2)
    got = list(server.stream(frames))
    policy = StreamingSR.default_policy()
    with torch.no_grad():
        for f, g in zip(frames, got):
            want = port.mambair_apply(net, torch.from_numpy(f), cfg, policy).float().numpy()
            assert g.shape == (2, 32, 48, 3) and np.array_equal(g, want)
    assert served.by_name("MambaIR") is served.of(net) is served.SERVED["MambaIR"]
    assert served.of(net).counted == {"ss2d_scan": ss2d_scan.ss2d_scan,
                                      "row_norm": row_norm.row_norm}
    assert not served.of(net).row_sharded
    from m2trans_tpu_torch.parallel.mesh import SpaceMesh

    with pytest.raises(ValueError, match="MambaIR runs on one device"):
        StreamingSR(net, cfg, mesh=SpaceMesh(n=2, rank=0))


def test_config_keys_and_yml():
    """The yml beside the port selects MambaIR with the published sizes;
    sizes the port does not serve are refused."""
    cfg = load_config(os.path.join(ROOT, "m2trans_tpu_torch", "configs", "MambaIR_SRx4.yml"))
    s = port.MambaIRSizes.from_config(cfg)
    assert (cfg.model, s.embed_dim, s.groups, s.depth, s.d_state, s.d_inner, s.dt_rank,
            s.num_feat) == ("MambaIR", 180, 6, 6, 16, 360, 12, 64)
    with pytest.raises(ValueError, match="depths"):
        port.MambaIRSizes.from_config(cfg.replace(extras=dict(cfg.extras, depths=[6, 4])))
    with pytest.raises(ValueError, match="upsampler"):
        port.MambaIRSizes.from_config(cfg.replace(extras=dict(cfg.extras,
                                                              upsampler="pixelshuffledirect")))


def test_infer_cli_serves_mambair(tmp_path, seeded):
    """``python -m m2trans_tpu_torch.infer`` on a MambaIR yml and a
    released-layout ``.pth`` on the CPU: PNGs of 4x the frames, the eager
    forward's."""
    from PIL import Image

    sd, net = seeded
    torch.save({"params": sd}, tmp_path / "mambair.pth")
    yml = tmp_path / "mambair.yml"
    yml.write_text("model: MambaIR\n" + "".join(f"{k}: {json.dumps(v)}\n"
                                                for k, v in TINY.items())
                   + "dtype: bfloat16\nuse_pallas: true\n")
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (9, 11, 3), dtype=np.uint8)).save(src / f"{i}.png")
    res = subprocess.run(
        [sys.executable, "-m", "m2trans_tpu_torch.infer", "--config", str(yml), "--model_path",
         str(tmp_path / "mambair.pth"), "--input", str(src), "--output", str(tmp_path / "out"),
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["frames"] == 2 and report["kernel_launches"] == {"ss2d_scan": 0, "row_norm": 0}
    cfg = _cfg(dtype="bfloat16", use_pallas=True)
    x = np.asarray(Image.open(src / "0.png"), np.float32)[None] / 255.0
    with torch.no_grad():
        y = port.mambair_apply(net, torch.from_numpy(x), cfg).float().numpy()[0]
    want = np.clip(y * 255.0 + 0.5, 0, 255).astype(np.uint8)
    got = np.asarray(Image.open(tmp_path / "out" / "0.png"))
    assert got.shape == (36, 44, 3) and np.array_equal(got, want)


def test_counts_from_shapes():
    """The scan's bound at the cell's shape is its FP32 work (6 operations
    an update at 67 TFLOP/s: 0.152 ms a launch, 36 launches), and the
    reference's products are counted on the meta device."""
    from h100bench.core import mambair_counts

    model = json.load(open(os.path.join(ROOT, "h100bench", "configs", "mambair-x4.json")))["model"]
    per_launch = 6 * 8 * 4 * 360 * 16 * 96 * 96 / 67e12 * 1e3
    assert mambair_counts.scan_bound_ms(model, 8, 96, 96) == pytest.approx(36 * per_launch)
    assert mambair_counts.forward_flops(TINY, 1, 8, 8) > 0
