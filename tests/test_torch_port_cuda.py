"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU (``cuda`` marker) and skip elsewhere. The
file imports neither jax nor the JAX package, so it runs where the port
runs:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

(``--noconftest``: the suite's conftest.py sets up JAX, which the GPU
machine need not have). Tolerances are those of the CPU tests: K1 max
5e-2 / mean 5e-3 (tests/test_cftm_fused.py), K2 max 8e-3
(tests/test_tail_band.py); K1b and K2b, every gradient
``max|a - b| <= max(2e-3, 2e-2 * max|b|)`` against the plain VJP (the
bound of their gradient tests); K3 ``max|a - b| <= max(2e-3, 2e-2 *
max|b|)`` (it differs from its plain version in the f32 order of the tap
sums), its gradients to the same bound; K1n as K1; K4 exactly. K1's
bodies of base width 16 (a window to a warp at L = 0, to four warps at
L = 1, to a cluster at L = 2), K2's 8x16 tile walk and K3's persistent grid
have cases of their own at shapes that do not fill their rounds or tiles; so
have K1b's bodies (a window to four warps at L = 0 / L = 1, to a cluster at
L = 2, the general body at base width 32) and K2b's roles, each also run
twice and held to the same bits. The serving forward replayed from a CUDA
graph (``models/graphed.py``) is held to the eager forward's bits.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data.benchmark import BenchmarkDataset
from m2trans_tpu_torch.models import m2trans as port_model
from m2trans_tpu_torch.models.m2trans import ComputePolicy, init_m2trans, m2trans_apply
from m2trans_tpu_torch.ops.kernels import build, relayout
from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv, ff_conv_plain, ff_weight_hwio
from m2trans_tpu_torch.ops.kernels.in_stats import in_stats_affine, in_stats_affine_plain
from m2trans_tpu_torch.ops.kernels.halo_attn import (
    cftm_branch,
    cftm_branch_bwd,
    cftm_branch_bwd_variant,
    cftm_branch_plain,
    cftm_branch_plain_vjp,
    cftm_branch_variant,
    variant_by_shape,
    halo_attention_qkv,
    halo_attention_qkv_plain,
)
from m2trans_tpu_torch.ops.kernels.tail_band import (
    TILE,
    tail_band_apply,
    tail_band_bwd,
    tail_band_fused,
    tail_band_operands,
    tail_band_plain,
    tail_band_plain_vjp,
)
from m2trans_tpu_torch.models.graphed import GraphedForward, serving_forward
from m2trans_tpu_torch.parallel.streaming import StreamingSR
from m2trans_tpu_torch.train.evaluate import evaluate_dataset
from m2trans_tpu_torch.train.loop import make_optimizer, make_train_step


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, shape, std=1.0, dtype=torch.float32):
    return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32)).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [0, 1, 2])
@pytest.mark.parametrize("with_add", [False, True])
def test_k1_matches_plain(dev, levels, with_add):
    rng = np.random.default_rng(levels)
    cb, c = 16, 16 * 4 ** levels
    body = _randn(rng, (2, 32, 32, 4 * cb), dtype=torch.bfloat16)
    args = [body[..., cb:2 * cb], _randn(rng, (c, 3 * c), c ** -0.5, torch.bfloat16),
            _randn(rng, (10, c // 2)), _randn(rng, (10, c // 2)),
            torch.from_numpy(rng.uniform(0.5, 1.5, (2, cb)).astype(np.float32)),
            _randn(rng, (2, cb), 0.2)]
    add = _randn(rng, (2, 32, 32, cb), dtype=torch.bfloat16) if with_add else None
    want = cftm_branch_plain(*args, x_add=add, levels=levels).float()
    n0 = cftm_branch.launches
    got = cftm_branch(*[a.to(dev) for a in args],
                      x_add=None if add is None else add.to(dev),
                      levels=levels).float().cpu()
    assert cftm_branch.launches == n0 + 1
    d = (got - want).abs()
    assert float(d.max()) < 5e-2 and float(d.mean()) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 32, 32), (2, 64, 96), (3, 96, 32)])
@pytest.mark.parametrize("mode", ["affine", "affine+add", "bare"])
def test_k1_cluster_body_matches_plain(dev, shape, mode):
    """L = 2 at base width 16 (C = 256) runs the body that splits a window
    over a cluster of four CTAs: one window alone, several windows and
    images, with and without the cascade add, and as K1n."""
    assert cftm_branch_variant(16, 2) == "c256_cluster4"
    assert cftm_branch_variant(16, 1) == "w64_warpgroup"
    assert cftm_branch_variant(4, 2) == "general"
    rng = np.random.default_rng(shape[1] + len(mode))
    bsz, h, w = shape
    body = _randn(rng, (bsz, h, w, 64), dtype=torch.bfloat16)
    wq = _randn(rng, (256, 768), 1 / 16, torch.bfloat16)
    rel_h, rel_w = _randn(rng, (10, 128)), _randn(rng, (10, 128))
    s = torch.from_numpy(rng.uniform(0.5, 1.5, (bsz, 16)).astype(np.float32))
    t = _randn(rng, (bsz, 16), 0.2)
    add = _randn(rng, (bsz, h, w, 16), dtype=torch.bfloat16)
    x, xd = body[..., 32:48], body.to(dev)[..., 32:48]
    if mode == "bare":
        want = halo_attention_qkv_plain(x, wq, rel_h, rel_w, levels=2)
        n0 = halo_attention_qkv.launches
        got = halo_attention_qkv(xd, wq.to(dev), rel_h.to(dev), rel_w.to(dev), levels=2)
        assert halo_attention_qkv.launches == n0 + 1
    else:
        x_add = add if mode == "affine+add" else None
        want = cftm_branch_plain(x, wq, rel_h, rel_w, s, t, x_add=x_add, levels=2)
        n0 = cftm_branch.launches
        got = cftm_branch(xd, wq.to(dev), rel_h.to(dev), rel_w.to(dev), s.to(dev),
                          t.to(dev), x_add=None if x_add is None else x_add.to(dev),
                          levels=2)
        assert cftm_branch.launches == n0 + 1
    d = (got.float().cpu() - want.float()).abs()
    assert float(d.max()) < 5e-2 and float(d.mean()) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8, 8), (2, 64, 96), (3, 96, 32)])
@pytest.mark.parametrize("mode", ["affine", "affine+add", "bare"])
@pytest.mark.parametrize("levels", [0, 1])
def test_k1_window_bodies_match_plain(dev, levels, shape, mode):
    """L = 0 and L = 1 at base width 16 run the bodies that give a window to
    a warp and to a group of four warps: one window alone, several windows
    and images, with and without the cascade add, and as K1n."""
    assert cftm_branch_variant(16, levels) == ("w16_warp", "w64_warpgroup")[levels]
    rng = np.random.default_rng(shape[1] + len(mode) + levels)
    bsz, h, w = shape[0], shape[1] * 2 ** levels, shape[2] * 2 ** levels
    c = 16 * 4 ** levels
    body = _randn(rng, (bsz, h, w, 64), dtype=torch.bfloat16)
    wq = _randn(rng, (c, 3 * c), c ** -0.5, torch.bfloat16)
    rel_h, rel_w = _randn(rng, (10, c // 2)), _randn(rng, (10, c // 2))
    s = torch.from_numpy(rng.uniform(0.5, 1.5, (bsz, 16)).astype(np.float32))
    t = _randn(rng, (bsz, 16), 0.2)
    add = _randn(rng, (bsz, h, w, 16), dtype=torch.bfloat16)
    x, xd = body[..., 48:64], body.to(dev)[..., 48:64]
    if mode == "bare":
        want = halo_attention_qkv_plain(x, wq, rel_h, rel_w, levels=levels)
        got = halo_attention_qkv(xd, wq.to(dev), rel_h.to(dev), rel_w.to(dev),
                                 levels=levels)
    else:
        x_add = add if mode == "affine+add" else None
        want = cftm_branch_plain(x, wq, rel_h, rel_w, s, t, x_add=x_add, levels=levels)
        n0 = cftm_branch.launches
        got = cftm_branch(xd, wq.to(dev), rel_h.to(dev), rel_w.to(dev), s.to(dev),
                          t.to(dev), x_add=None if x_add is None else x_add.to(dev),
                          levels=levels)
        assert cftm_branch.launches == n0 + 1
    d = (got.float().cpu() - want.float()).abs()
    assert float(d.max()) < 5e-2 and float(d.mean()) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [0, 1])
def test_k1_other_widths_run_the_general_body(dev, levels):
    """Base width 32 is taken by no body of width 16: the general body is
    launched, by shape alone, and agrees with the plain version."""
    assert cftm_branch_variant(32, levels) == "general"
    for cb in (4, 16, 32, 64):
        for lv in (0, 1, 2):
            assert cftm_branch_variant(cb, lv) == variant_by_shape(cb, lv)
    rng = np.random.default_rng(50 + levels)
    cb, c = 32, 32 * 4 ** levels
    x = _randn(rng, (2, 32, 32, cb), dtype=torch.bfloat16)
    args = [x, _randn(rng, (c, 3 * c), c ** -0.5, torch.bfloat16),
            _randn(rng, (10, c // 2)), _randn(rng, (10, c // 2)),
            torch.from_numpy(rng.uniform(0.5, 1.5, (2, cb)).astype(np.float32)),
            _randn(rng, (2, cb), 0.2)]
    want = cftm_branch_plain(*args, levels=levels).float()
    got = cftm_branch(*[a.to(dev) for a in args], levels=levels).float().cpu()
    d = (got - want).abs()
    assert float(d.max()) < 5e-2 and float(d.mean()) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [0, 1])
def test_k1_window_bodies_raise_on_a_misaligned_slice(dev, levels):
    rng = np.random.default_rng(9)
    c = 16 * 4 ** levels
    body = _randn(rng, (1, 32, 32, 24), dtype=torch.bfloat16).to(dev)
    wq = _randn(rng, (c, 3 * c), 0.25, torch.bfloat16).to(dev)
    rel = _randn(rng, (10, c // 2)).to(dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        halo_attention_qkv(body[..., 4:20], wq, rel, rel, levels=levels)


@pytest.mark.cuda
def test_k1_cluster_body_raises_on_a_misaligned_slice(dev):
    """The cluster body reads x with vector loads; a slice that does not
    start on 16 bytes raises instead of running another body."""
    rng = np.random.default_rng(9)
    body = _randn(rng, (1, 32, 32, 24), dtype=torch.bfloat16).to(dev)
    wq = _randn(rng, (256, 768), 1 / 16, torch.bfloat16).to(dev)
    rel = _randn(rng, (10, 128)).to(dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        halo_attention_qkv(body[..., 4:20], wq, rel, rel, levels=2)


@pytest.mark.cuda
@pytest.mark.parametrize("scale,hw", [(2, (16, 24)), (3, (16, 16)), (4, (24, 40))])
def test_k2_matches_plain(dev, scale, hw):
    nf = 64
    rng = np.random.default_rng(scale)

    def u(shape, fan_in):
        b = fan_in ** -0.5
        return torch.from_numpy(rng.uniform(-b, b, shape).astype(np.float32))

    cp0 = 4 * nf if scale == 4 else nf * scale * scale
    p = {"c0": {"w": u((cp0, nf, 1, 1), nf), "b": u((cp0,), nf)}}
    if scale == 4:
        p["c1"] = {"w": u((4 * nf, nf, 1, 1), nf), "b": u((4 * nf,), nf)}
        p["c2"] = {"w": u((3, nf, 3, 3), 9 * nf)}
    else:
        p["c1"] = {"w": u((3, nf, 3, 3), 9 * nf)}
    x = _randn(rng, (2, *hw, nf), dtype=torch.bfloat16)
    want = tail_band_apply(p, x, scale=scale, rgb_range=1.0).float()
    pd = {k: {n: v.to(dev) for n, v in sp.items()} for k, sp in p.items()}
    n0 = tail_band_fused.launches
    got = tail_band_apply(pd, x.to(dev), scale=scale, rgb_range=1.0).float().cpu()
    assert tail_band_fused.launches == n0 + 1
    assert got.shape == (2, hw[0] * scale, hw[1] * scale, 3)
    assert float((got - want).abs().max()) < 8e-3


@pytest.mark.cuda
@pytest.mark.parametrize("scale,shape,nf", [(4, (1, 512, 512), 64), (4, (2, 100, 76), 64),
                                            (3, (1, 50, 37), 64), (2, (1, 7, 5), 64),
                                            (4, (2, 20, 36), 32), (2, (1, 24, 40), 16)])
def test_k2_tile_walk_matches_plain(dev, scale, shape, nf):
    """The single-frame shape (more tiles than the grid has blocks), frames
    that are no multiple of the 8x16 tile in either direction, a frame
    smaller than one tile, and the narrower widths."""
    rng = np.random.default_rng(scale + shape[1])

    def u(shp, fan_in):
        b = fan_in ** -0.5
        return torch.from_numpy(rng.uniform(-b, b, shp).astype(np.float32))

    cp0 = 4 * nf if scale == 4 else nf * scale * scale
    p = {"c0": {"w": u((cp0, nf, 1, 1), nf), "b": u((cp0,), nf)}}
    if scale == 4:
        p["c1"] = {"w": u((4 * nf, nf, 1, 1), nf), "b": u((4 * nf,), nf)}
        p["c2"] = {"w": u((3, nf, 3, 3), 9 * nf)}
    else:
        p["c1"] = {"w": u((3, nf, 3, 3), 9 * nf)}
    x = _randn(rng, (*shape, nf), dtype=torch.bfloat16)
    pd = {k: {n: v.to(dev) for n, v in sp.items()} for k, sp in p.items()}
    ops = tail_band_operands(pd, x.to(dev), scale=scale)
    lib = build.lib()
    assert (lib.m2t_tail_band_tile(0), lib.m2t_tail_band_tile(1)) == TILE
    n0 = tail_band_fused.launches
    got = tail_band_fused(*ops, scale=scale, rgb_range=1.0)
    assert tail_band_fused.launches == n0 + 1
    want = tail_band_plain(*ops, scale=scale, rgb_range=1.0)
    assert bool(torch.isfinite(got.float()).all())
    assert float((got.float() - want.float()).abs().max()) < 8e-3


@pytest.mark.cuda
def test_k2b_mask_is_k2s(dev):
    """K2b takes its clip mask from K2's own kernel: wherever K2's output is
    strictly inside (0, rgb_range) the masked cotangent passes, and wherever
    the plain pre-clamp output is clearly outside it is zero. Seen through
    dy with a one-hot cotangent being costly, it is checked on the edge
    gradients' finiteness and on a frame that is no multiple of either tile."""
    rng = np.random.default_rng(31)

    def u(shp, fan_in):
        b = fan_in ** -0.5
        return torch.from_numpy(rng.uniform(-b, b, shp).astype(np.float32)).to(dev)

    nf = 64
    p = {"c0": {"w": u((4 * nf, nf, 1, 1), nf), "b": u((4 * nf,), nf)},
         "c1": {"w": u((4 * nf, nf, 1, 1), nf), "b": u((4 * nf,), nf)},
         "c2": {"w": u((3, nf, 3, 3), 9 * nf)}}
    ops = tail_band_operands(p, _randn(rng, (1, 20, 36, nf), dtype=torch.bfloat16).to(dev),
                             scale=4)
    g = _randn(rng, (1, 20, 36, 48), dtype=torch.bfloat16).to(dev)
    got = tail_band_bwd(*ops, g, scale=4, rgb_range=1.0)
    want = tail_band_plain_vjp(*ops, g, scale=4, rgb_range=1.0)
    for i, (a, b) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(a.float()).all()), i
        _grad_close(a, b, i)


@pytest.mark.cuda
def test_forward_through_kernels(dev):
    """One CFTM at the flagship width: 4 K1 launches, 1 K3 launch and 1 K2
    launch, and the output agrees with the plain bf16 path on the card."""
    cfg = Config(scale=4, n_feats=64, n_blocks=1)
    model = init_m2trans(cfg, seed=0, device=dev)
    x = torch.rand(2, 40, 36, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    n1, n2, n3 = cftm_branch.launches, tail_band_fused.launches, ff_conv.launches
    with torch.inference_mode():
        got = m2trans_apply(model, x, cfg, ComputePolicy(torch.bfloat16, True)).float()
        assert (cftm_branch.launches - n1, tail_band_fused.launches - n2,
                ff_conv.launches - n3) == (4, 1, 1)
        want = m2trans_apply(model, x, cfg, ComputePolicy(torch.bfloat16, False)).float()
    assert got.shape == (2, 160, 144, 3)
    d = (got - want).abs()
    assert float(d.max()) < 1e-1 and float(d.mean()) < 5e-3


def _in_stats_map(seed, shape):
    """A seeded bf16 NHWC map whose channels have their own offset and
    scale, so that no mean sits near zero and E[x]^2 stays within four times
    the variance (as in tests/test_torch_port_in_stats.py)."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    off = rng.uniform(0.2, 1.0, c) * rng.choice([-1.0, 1.0], c)
    scale = rng.uniform(0.5, 1.5, c)
    return torch.from_numpy((rng.standard_normal(shape, dtype=np.float32) * scale
                             + off).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 96, 96, 64), (1, 512, 512, 64), (1, 256, 256, 64),
                                   (2, 192, 192, 64), (3, 40, 72, 64), (2, 33, 17, 32),
                                   (2, 24, 40, 96), (3, 20, 28, 128), (2, 12, 20, 2048)])
def test_in_stats_kernel_matches_plain(dev, shape):
    """The statistics kernel against its plain version on the card: s and t
    of every branch within 1e-5 relative (the f32 sums differ in order
    only), two launches a call, and a second call gives the same bits. The
    widths take each launch geometry: C = 32 (64 pixels a round), 64, 96
    (12 vectors a pixel, which do not divide 256 threads: 252), 128 and
    2048 (one pixel a round, the shared rows full)."""
    x = _in_stats_map(shape[1] + shape[0], shape).to(dev)
    want = in_stats_affine_plain(x)
    n0 = in_stats_affine.launches
    got = in_stats_affine(x)
    again = in_stats_affine(x)
    assert in_stats_affine.launches == n0 + 4
    assert got.shape == want.shape == (2, 4, shape[0], shape[-1] // 4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_in_stats_kernel_raises_on_what_it_does_not_take(dev):
    x = _in_stats_map(0, (2, 16, 16, 64)).to(dev)
    n0 = in_stats_affine.launches
    for bad, match in ((x.float(), "bf16"), (x[:, :, ::2], "contiguous"),
                       (_in_stats_map(0, (2, 16, 16, 48)).to(dev), "multiple of 32")):
        with pytest.raises(ValueError, match=match):
            in_stats_affine(bad)
    assert in_stats_affine.launches == n0


@pytest.mark.cuda
def test_served_forward_capture_counts_the_statistics(dev):
    """A capture of the x4 serving forward (8 blocks) counts 32 K1, 8 K3, 1
    K2 and 16 statistics launches (two a CFTM), and replays the eager bits."""
    cfg, model = _graphed_case(dev, n_blocks=8)
    kern = ComputePolicy(torch.bfloat16, True)
    x = torch.rand(1, 96, 96, 3, generator=torch.Generator().manual_seed(6)).to(dev)
    gf = GraphedForward(model, cfg, kern)
    with torch.inference_mode():
        got = gf(x).clone()
        assert torch.equal(got, serving_forward(model, x, cfg, kern, False))
    assert gf.capture_launches[tuple(x.shape)] == {"cftm_branch": 32, "ff_conv": 8,
                                                   "tail_band": 1, "in_stats": 16}


def _grad_close(got, want, name):
    want = want.float().cpu()
    tol = max(2e-3, 2e-2 * float(want.abs().max()))
    assert float((got.float().cpu() - want).abs().max()) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [0, 1, 2])
@pytest.mark.parametrize("with_add", [False, True])
def test_k1b_matches_plain_vjp(dev, levels, with_add):
    rng = np.random.default_rng(10 + levels)
    cb, c = 16, 16 * 4 ** levels
    body = _randn(rng, (2, 32, 32, 4 * cb), dtype=torch.bfloat16).to(dev)
    args = [body[..., cb:2 * cb],
            _randn(rng, (c, 3 * c), c ** -0.5, torch.bfloat16).to(dev),
            _randn(rng, (10, c // 2)).to(dev), _randn(rng, (10, c // 2)).to(dev),
            torch.from_numpy(rng.uniform(0.5, 1.5, (2, cb)).astype(np.float32)).to(dev),
            _randn(rng, (2, cb), 0.2).to(dev)]
    add = _randn(rng, (2, 32, 32, cb), dtype=torch.bfloat16).to(dev) if with_add else None
    g = _randn(rng, (2, 32, 32, cb), dtype=torch.bfloat16).to(dev)
    n0 = cftm_branch_bwd.launches
    got = cftm_branch_bwd(*args, g, x_add=add, levels=levels)
    assert cftm_branch_bwd.launches == n0 + 1
    want = cftm_branch_plain_vjp(*args, g, x_add=add, levels=levels)
    names = ("dx", "dx_add", "ds", "dt", "dw_qkv", "drel_h", "drel_w")
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        _grad_close(a, b, name)


@pytest.mark.cuda
@pytest.mark.parametrize("scale,hw", [(2, (16, 24)), (3, (16, 16)), (4, (24, 40))])
def test_k2b_matches_plain_vjp(dev, scale, hw):
    nf = 64
    rng = np.random.default_rng(20 + scale)

    def u(shape, fan_in):
        b = fan_in ** -0.5
        return torch.from_numpy(rng.uniform(-b, b, shape).astype(np.float32)).to(dev)

    cp0 = 4 * nf if scale == 4 else nf * scale * scale
    p = {"c0": {"w": u((cp0, nf, 1, 1), nf), "b": u((cp0,), nf)}}
    if scale == 4:
        p["c1"] = {"w": u((4 * nf, nf, 1, 1), nf), "b": u((4 * nf,), nf)}
        p["c2"] = {"w": u((3, nf, 3, 3), 9 * nf)}
    else:
        p["c1"] = {"w": u((3, nf, 3, 3), 9 * nf)}
    ops = tail_band_operands(p, _randn(rng, (2, *hw, nf), dtype=torch.bfloat16).to(dev),
                             scale=scale)
    g = _randn(rng, (2, *hw, scale * scale * 3), dtype=torch.bfloat16).to(dev)
    n0 = tail_band_bwd.launches
    got = tail_band_bwd(*ops, g, scale=scale, rgb_range=1.0)
    assert tail_band_bwd.launches == n0 + 1
    want = tail_band_plain_vjp(*ops, g, scale=scale, rgb_range=1.0)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        _grad_close(a, b, i)


def _k1b_case(dev, levels, shape, cb, seed):
    rng = np.random.default_rng(seed)
    bsz, h, w = shape
    c = cb * 4 ** levels
    body = _randn(rng, (bsz, h, w, 4 * cb), dtype=torch.bfloat16).to(dev)
    args = [body[..., cb:2 * cb],
            _randn(rng, (c, 3 * c), c ** -0.5, torch.bfloat16).to(dev),
            _randn(rng, (10, c // 2)).to(dev), _randn(rng, (10, c // 2)).to(dev),
            torch.from_numpy(rng.uniform(0.5, 1.5, (bsz, cb)).astype(np.float32)).to(dev),
            _randn(rng, (bsz, cb), 0.2).to(dev)]
    add = _randn(rng, (bsz, h, w, cb), dtype=torch.bfloat16).to(dev)
    g = _randn(rng, (bsz, h, w, cb), dtype=torch.bfloat16).to(dev)
    return args, add, g


def _k1b_check(args, add, g, levels):
    got = cftm_branch_bwd(*args, g, x_add=add, levels=levels)
    again = cftm_branch_bwd(*args, g, x_add=add, levels=levels)
    want = cftm_branch_plain_vjp(*args, g, x_add=add, levels=levels)
    names = ("dx", "dx_add", "ds", "dt", "dw_qkv", "drel_h", "drel_w")
    for name, a, a2, b in zip(names, got, again, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a.float()).all()), name
        assert torch.equal(a, a2), f"{name}: two runs differ"
        _grad_close(a, b, name)


# one window, frames that do not fill a round, the single-frame shape
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [None, (2, 64, 96), (3, 96, 32), (1, 512, 512)])
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("levels", [0, 1, 2])
def test_k1b_bodies_match_plain_vjp(dev, levels, with_add, shape):
    """Every body of base width 16 against the plain VJP, two runs bit for
    bit."""
    if shape is None:
        shape = (1, 8 * 2 ** levels, 8 * 2 ** levels)
    assert cftm_branch_bwd_variant(16, levels) == (
        "w16_group", "w64_group", "c256_cluster4")[levels]
    args, add, g = _k1b_case(dev, levels, shape, 16, 40 + levels)
    _k1b_check(args, add if with_add else None, g, levels)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [0, 1])
@pytest.mark.parametrize("with_add", [False, True])
def test_k1b_other_widths_run_the_general_body(dev, levels, with_add):
    assert cftm_branch_bwd_variant(32, levels) == "general"
    args, add, g = _k1b_case(dev, levels, (2, 32, 48), 32, 50 + levels)
    _k1b_check(args, add if with_add else None, g, levels)


@pytest.mark.cuda
@pytest.mark.parametrize("nf", [16, 32, 64])
@pytest.mark.parametrize("scale", [2, 3, 4])
def test_k2b_roles_match_plain_vjp(dev, scale, nf):
    """A frame that is no multiple of the 8x16 tile, every width, two runs
    bit for bit."""
    rng = np.random.default_rng(60 + scale + nf)

    def u(shape, fan_in):
        b = fan_in ** -0.5
        return torch.from_numpy(rng.uniform(-b, b, shape).astype(np.float32)).to(dev)

    cp0 = 4 * nf if scale == 4 else nf * scale * scale
    p = {"c0": {"w": u((cp0, nf, 1, 1), nf), "b": u((cp0,), nf)}}
    if scale == 4:
        p["c1"] = {"w": u((4 * nf, nf, 1, 1), nf), "b": u((4 * nf,), nf)}
        p["c2"] = {"w": u((3, nf, 3, 3), 9 * nf)}
    else:
        p["c1"] = {"w": u((3, nf, 3, 3), 9 * nf)}
    ops = tail_band_operands(
        p, _randn(rng, (2, 100, 76, nf), dtype=torch.bfloat16).to(dev), scale=scale)
    g = _randn(rng, (2, 100, 76, scale * scale * 3), dtype=torch.bfloat16).to(dev)
    # no cotangent where rounding decides the clamp's mask: the kernel's and
    # the plain version's pre-clamp outputs differ by an f32 sum order
    out = tail_band_plain(*ops, scale=scale, rgb_range=1.0).float()
    g = g * ((out > 0.02) & (out < 0.98)).to(g.dtype)
    got = tail_band_bwd(*ops, g, scale=scale, rgb_range=1.0)
    again = tail_band_bwd(*ops, g, scale=scale, rgb_range=1.0)
    want = tail_band_plain_vjp(*ops, g, scale=scale, rgb_range=1.0)
    for i, (a, a2, b) in enumerate(zip(got, again, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert bool(torch.isfinite(a.float()).all()), i
        assert torch.equal(a, a2), f"gradient {i}: two runs differ"
        _grad_close(a, b, i)


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
def test_train_step_gradients_within_the_bf16_bound(dev):
    """The step's gradients through the kernels against the plain bf16 step:
    relative L2 per parameter <= max(5e-2, 1.5 e), e the plain bf16
    gradient's distance from f32."""
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    hr = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    grads = {}
    for name, kw in (("kernels", dict(dtype="bfloat16", use_pallas=True)),
                     ("plain", dict(dtype="bfloat16", use_pallas=False)),
                     ("f32", dict(dtype="float32", use_pallas=False))):
        cfg = Config(scale=4, n_feats=64, n_blocks=1, **kw)
        model = init_m2trans(cfg, seed=0, device=dev)
        make_train_step(cfg, model, make_optimizer(cfg, model), graphs=False)(x, hr)
        grads[name] = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    for n, gk in grads["kernels"].items():
        e = _rel_l2(grads["plain"][n], grads["f32"][n])
        assert _rel_l2(gk, grads["plain"][n]) <= max(5e-2, 1.5 * e), n


@pytest.mark.cuda
def test_streaming_depth_2_pipelines(dev):
    """On a CUDA model a slot's buffers are pinned, pop() waits on the frame's
    own event, depth 2 yields depth 1's frames, and neither its p50 latency
    nor its stream is above depth 1's (best of three runs each, by more than
    25%)."""
    import time

    cfg = Config(scale=4, n_feats=64, n_blocks=2)
    model = init_m2trans(cfg, seed=0, device=dev)
    frames = [np.random.default_rng(i).uniform(0, 1, (1, 96, 96, 3)).astype(np.float32)
              for i in range(12)]
    outs, secs, p50 = {}, {1: [], 2: []}, {1: [], 2: []}
    runs = {depth: StreamingSR(model, cfg, depth=depth) for depth in (1, 2)}
    for depth, run in runs.items():
        run.warmup(frames[0].shape)
        list(run.stream(frames[:3]))
    for _ in range(3):  # in turns; the best of three a depth (host timing is noisy)
        for depth, run in runs.items():
            t0 = time.perf_counter()
            outs[depth] = list(run.stream(frames, collect_stats=True))
            secs[depth].append(time.perf_counter() - t0)
            p50[depth].append(run.latency_percentiles()["p50_s"])
            assert len(run._slots) == depth and len(run.latencies_s) == len(frames)
            assert all(buf.is_pinned() for pair in run._slots.values() for buf in pair)
    for a, b in zip(outs[1], outs[2]):
        np.testing.assert_array_equal(a, b)
    assert min(secs[2]) <= 1.25 * min(secs[1]), secs
    assert min(p50[2]) <= 1.25 * min(p50[1]), p50


def _graphed_case(dev, n_blocks=2):
    cfg = Config(scale=4, n_feats=64, n_blocks=n_blocks)
    return cfg, init_m2trans(cfg, seed=0, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("output_u8", [False, True])
@pytest.mark.parametrize("shape", [(8, 96, 96, 3), (1, 256, 256, 3)])
def test_graph_replay_equals_eager_bit_for_bit(dev, shape, output_u8):
    """bf16 with the kernels: the replayed graph gives the eager forward's
    bits, on its first call (capture, then replay) and after; the capture
    itself counts 4 K1, 1 K3, 2 statistics launches a block and 1 K2."""
    cfg, model = _graphed_case(dev)
    kern = ComputePolicy(torch.bfloat16, True)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1)).to(dev)
    gf = GraphedForward(model, cfg, kern, output_u8=output_u8)
    with torch.inference_mode():
        first = gf(x).clone()
        want = serving_forward(model, x, cfg, kern, output_u8)
        again = gf(x)
        assert torch.equal(first, want) and torch.equal(again, want)
    assert (gf.captures, gf.replays) == (1, 2)
    assert gf.capture_launches[shape] == {"cftm_branch": 8, "ff_conv": 2,
                                          "tail_band": 1, "in_stats": 4}


@pytest.mark.cuda
def test_graph_of_a_new_shape_is_captured_on_its_first_call(dev):
    cfg, model = _graphed_case(dev, n_blocks=1)
    kern = ComputePolicy(torch.bfloat16, True)
    gf = GraphedForward(model, cfg, kern)
    gen = torch.Generator().manual_seed(2)
    a = torch.rand(2, 64, 96, 3, generator=gen).to(dev)
    b = torch.rand(1, 40, 36, 3, generator=gen).to(dev)
    with torch.inference_mode():
        for x, captures in ((a, 1), (a, 1), (b, 2), (a, 2), (b, 2)):
            got = gf(x)
            assert gf.captures == captures
            assert torch.equal(got, serving_forward(model, x, cfg, kern, False))


@pytest.mark.cuda
def test_weights_loaded_in_place_force_a_new_capture(dev):
    """Weights loaded in place (``load_state_dict`` into the captured
    model's parameters) keep the graph: the next call refreshes the kept
    operands in place and replays, giving a fresh eager forward's output.
    Weights loaded by replacing the parameters (``assign=True``) move
    their storage and force a new capture."""
    cfg, model = _graphed_case(dev, n_blocks=1)
    kern = ComputePolicy(torch.bfloat16, True)
    gf = GraphedForward(model, cfg, kern)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(3)).to(dev)
    with torch.inference_mode():
        before = gf(x).clone()
    model.load_state_dict(init_m2trans(cfg, seed=1, device=dev).state_dict())
    with torch.inference_mode():
        got = gf(x).clone()
        want = serving_forward(model, x, cfg, kern, False)
    assert (gf.captures, gf.refreshes) == (1, 1)
    assert torch.equal(got, want) and not torch.equal(got, before)
    model.load_state_dict(init_m2trans(cfg, seed=2, device=dev).state_dict(), assign=True)
    with torch.inference_mode():
        got = gf(x).clone()
        want = serving_forward(model, x, cfg, kern, False)
    assert gf.captures == 2 and torch.equal(got, want)


@pytest.mark.cuda
def test_recapture_while_a_returned_output_is_held(dev):
    """The caller keeps the static output of a dropped graph: the next
    capture (a parameter replaced, so every graph is dropped) takes a new
    pool, and gives the fresh eager forward; with ``max_graphs`` 1 the
    other shape then runs eagerly."""
    cfg, model = _graphed_case(dev, n_blocks=1)
    kern = ComputePolicy(torch.bfloat16, True)
    gf = GraphedForward(model, cfg, kern, max_graphs=1)
    gen = torch.Generator().manual_seed(5)
    a = torch.rand(1, 64, 64, 3, generator=gen).to(dev)
    b = torch.rand(1, 32, 64, 3, generator=gen).to(dev)
    with torch.inference_mode():
        held = gf(a)
        want_a = held.clone()
    model.head.bias = torch.nn.Parameter(model.head.bias.detach() + 0.01)
    with torch.inference_mode():
        held_b = gf(b)
        assert torch.equal(held_b, serving_forward(model, b, cfg, kern, False))
        assert torch.equal(gf(a), serving_forward(model, a, cfg, kern, False))
        assert (gf.captures, gf.eager_calls, len(gf._graphs)) == (2, 1, 1)
    assert held.shape == want_a.shape


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16 plain", "f32"])
def test_graph_of_the_other_policies_equals_eager(dev, policy):
    """The policies without the kernels are captured too: bf16's plain tail
    copies its phase selector to the card once (``ops.on_device``), not on
    every call; f32 captures with TF32 off."""
    cfg, model = _graphed_case(dev, n_blocks=1)
    pol = (ComputePolicy(torch.bfloat16, False) if policy == "bf16 plain"
           else ComputePolicy())
    gf = GraphedForward(model, cfg, pol)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(4)).to(dev)
    with torch.inference_mode():
        got = gf(x).clone()
        assert torch.equal(got, serving_forward(model, x, cfg, pol, False))
    assert gf.capture_launches[tuple(x.shape)] == {"cftm_branch": 0, "ff_conv": 0,
                                                   "tail_band": 0, "in_stats": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_streaming_with_graphs_yields_the_eager_frames(dev, depth):
    """StreamingSR on a CUDA model replays a graph per frame shape: its
    frames equal the eager stream's at depth 1 and 2, frame shapes mixed."""
    cfg, model = _graphed_case(dev)
    frames = [np.random.default_rng(i).uniform(0, 1, (1, 96 - 32 * (i % 2), 96, 3))
              .astype(np.float32) for i in range(6)]
    graphs = StreamingSR(model, cfg, depth=depth)
    eager = StreamingSR(model, cfg, depth=depth, graphs=False)
    assert graphs.graphed is not None and eager.graphed is None
    got = list(graphs.stream(frames, collect_stats=True))
    want = list(eager.stream(frames))
    assert (graphs.graphed.captures, graphs.graphed.replays) == (2, 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


HANDOFF_CASES = [((8, 96, 96, 3), False), ((1, 256, 256, 3), True)]


def _handoff_frames(shape, n=12):
    return [np.random.default_rng(i).uniform(0, 1, shape).astype(np.float32)
            for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("shape, output_u8", HANDOFF_CASES)
def test_held_results_are_handed_out_pinned_and_unaliased(dev, depth, shape, output_u8):
    """Every result of a 12-request stream, all held to its end: each is
    the pinned buffer its copy back landed in (no host copy), and each
    equals the eager stream's frame bit for bit once the stream is over."""
    cfg, model = _graphed_case(dev)
    frames = _handoff_frames(shape)
    eager = StreamingSR(model, cfg, depth=depth, output_u8=output_u8, graphs=False)
    want = [a.copy() for a in eager.stream(frames)]
    run = StreamingSR(model, cfg, depth=depth, output_u8=output_u8)
    run.warmup(shape)
    before = run.handed_out
    held = list(run.stream(frames))
    assert (run.handed_out - before, run.copied_out) == (12, 0)
    assert all(torch.from_numpy(a).is_pinned() for a in held)
    assert len({a.ctypes.data for a in held}) == 12
    for a, b in zip(held, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, output_u8", HANDOFF_CASES)
def test_past_the_limit_results_are_copied_out_with_the_same_bits(dev, shape, output_u8,
                                                                  monkeypatch):
    """With the pool's limit at two results, a stream whose results are all
    held lends two buffers and copies the other ten out of the slots."""
    from m2trans_tpu_torch.parallel import streaming

    cfg, model = _graphed_case(dev)
    frames = _handoff_frames(shape)
    eager = StreamingSR(model, cfg, depth=2, output_u8=output_u8, graphs=False)
    want = [a.copy() for a in eager.stream(frames)]
    nbytes = want[0].nbytes
    monkeypatch.setattr(streaming, "HANDOFF_LIMIT_BYTES", 2 * nbytes)
    run = StreamingSR(model, cfg, depth=2, output_u8=output_u8)
    held = list(run.stream(frames))
    assert (run.handed_out, run.copied_out) == (2, 10)
    assert [torch.from_numpy(a).is_pinned() for a in held] == [True] * 2 + [False] * 10
    for a, b in zip(held, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_dropped_results_pin_no_new_memory(dev):
    """Results dropped as they come: after a short warm-up the pool makes
    no buffer and the caching host allocator pins no block."""
    cfg, model = _graphed_case(dev)
    frames = _handoff_frames((8, 96, 96, 3), n=6)
    run = StreamingSR(model, cfg, depth=2)
    for _ in run.stream(frames):
        pass
    made, pinned = run.results.made, torch.cuda.host_memory_stats()["num_host_alloc"]
    for _ in range(4):
        for out in run.stream(frames):
            out[0, 0, 0, 0] += 1.0  # the consumer's to write
    assert run.results.made == made <= 4
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == pinned
    assert run.handed_out == 30 and run.copied_out == 0


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_stream_spans_on_the_card(dev, depth):
    """On the card a request is submitted, waited for, then copied out, and
    every copy-out holds one ``m2t::stream.handoff``."""
    from torch.profiler import ProfilerActivity, profile

    from m2trans_tpu_torch.utils import spans

    cfg, model = _graphed_case(dev)
    frames = _handoff_frames((1, 96, 96, 3), n=5)
    run = StreamingSR(model, cfg, depth=depth)
    run.warmup(frames[0].shape)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        assert len(list(run.stream(frames))) == 5
    got = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.name.startswith("m2t::stream.")
                 and e.device_type == torch.autograd.DeviceType.CPU)
    want = [spans.STREAM_SUBMIT] * depth
    for i in range(5):
        want += [spans.STREAM_WAIT, spans.STREAM_COPY_OUT]
        if i + depth < 5:
            want.append(spans.STREAM_SUBMIT)
    outer = [g for g in got if g[2] != spans.STREAM_HANDOFF]
    inner = [g for g in got if g[2] == spans.STREAM_HANDOFF]
    assert [n for _, _, n in outer] == want
    copies = [(s, e) for s, e, n in outer if n == spans.STREAM_COPY_OUT]
    assert len(inner) == len(copies)
    for (s, e), (hs, he, _) in zip(copies, inner):
        assert s <= hs <= he <= e


@pytest.mark.cuda
def test_train_step_through_kernels(dev):
    """One eager bf16 step of the training loop's ``make_train_step`` at the
    flagship width (one block): 4 K1 + 1 K3 + 1 K2 forward and 4 K1b + 1 K2b
    backward launches, finite gradients for every trainable parameter."""
    cfg = Config(scale=4, n_feats=64, n_blocks=1, dtype="bfloat16", use_pallas=True)
    model = init_m2trans(cfg, seed=0, device=dev)
    step = make_train_step(cfg, model, make_optimizer(cfg, model), graphs=False)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    hr = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    fns = (cftm_branch, ff_conv, tail_band_fused, cftm_branch_bwd, tail_band_bwd)
    counts = [f.launches for f in fns]
    step(x, hr)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, counts)] == [4, 1, 1, 4, 1]
    for name, p in model.named_parameters():
        if p.requires_grad:
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


@pytest.mark.cuda
def test_semantic_loss_step_through_kernels(dev):
    """The x4 step with the MedCLIP semantic loss (tiny random MedCLIP, clip
    size 56, 3 patches) at the training shapes, batch 2 x 96x96 -> 384x384,
    one block: the kernel launches of the L1 step, clip > 0, and every
    gradient within max(5e-2, 1.5 e) relative L2 of the plain bf16 step
    with the same weights, tokens and crop offsets (e the plain bf16
    gradient's distance from f32)."""
    from m2trans_tpu_torch.losses.semantic import SemanticLossFn
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip

    mcfg = MedCLIPConfig.tiny()
    fn = SemanticLossFn(init_medclip(mcfg, seed=0, device=dev), mcfg, None, clip_size=56)
    ids = np.random.default_rng(0).integers(5, 128, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0
    caps = {"input_ids": ids, "attention_mask": mask}
    x = torch.rand(2, 96, 96, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    hr = torch.rand(2, 384, 384, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    fns = (cftm_branch, ff_conv, tail_band_fused, cftm_branch_bwd, tail_band_bwd)
    grads, clips = {}, {}
    for name, kw in (("kernels", dict(dtype="bfloat16", use_pallas=True)),
                     ("plain", dict(dtype="bfloat16", use_pallas=False)),
                     ("f32", dict(dtype="float32", use_pallas=False))):
        cfg = Config(scale=4, n_feats=64, n_blocks=1, lambda_clip=0.01, **kw)
        model = init_m2trans(cfg, seed=0, device=dev)
        counts = [f.launches for f in fns]
        aux = make_train_step(cfg, model, make_optimizer(cfg, model), fn, graphs=False)(
            x, hr, captions=caps, rng=np.random.default_rng(3))
        torch.cuda.synchronize()
        if name == "kernels":
            assert [f.launches - n for f, n in zip(fns, counts)] == [4, 1, 1, 4, 1]
        clips[name] = float(aux["clip"])
        grads[name] = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert clips["kernels"] > 0 and abs(clips["kernels"] - clips["plain"]) < 0.05 * clips["plain"]
    for n, gk in grads["kernels"].items():
        assert bool(torch.isfinite(gk).all()), n
        e = _rel_l2(grads["plain"][n], grads["f32"][n])
        assert _rel_l2(gk, grads["plain"][n]) <= max(5e-2, 1.5 * e), n


def _ff_operands(rng, shape):
    c = shape[-1]
    return (_randn(rng, shape, dtype=torch.bfloat16),
            _randn(rng, shape, dtype=torch.bfloat16),
            ff_weight_hwio(_randn(rng, (c, c, 3, 3), (9 * c) ** -0.5)),
            _randn(rng, (c,), (9 * c) ** -0.5, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 32, 64), (1, 13, 21, 64),
                                   (2, 8, 16, 16), (1, 9, 40, 96),
                                   (2, 104, 88, 64), (1, 8, 8, 16),
                                   (1, 40, 24, 96), (1, 24, 16, 80),
                                   (1, 512, 512, 64)])
def test_k3_matches_plain(dev, shape):
    """Whole tiles, edge tiles in both directions, a frame smaller than one
    tile, fewer tiles than the grid has blocks and more than a multiple of
    them, and the other widths (C = 80 and 96 run with fewer window
    buffers)."""
    ops = _ff_operands(np.random.default_rng(shape[1]), shape)
    want = ff_conv_plain(*ops).float()
    n0 = ff_conv.launches
    got = ff_conv(*[a.to(dev) for a in ops]).float().cpu()
    assert ff_conv.launches == n0 + 1
    tol = max(2e-3, 2e-2 * float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
def test_k3_gradient_through_ffconvfn(dev):
    """FfConvFn launches K3 forward; its backward is the plain VJP."""
    rng = np.random.default_rng(5)
    ops = _ff_operands(rng, (2, 16, 24, 64))
    gout = _randn(rng, (2, 16, 24, 64), dtype=torch.bfloat16)
    ref = [a.clone().requires_grad_(True) for a in ops]
    want = torch.autograd.grad(ff_conv_plain(*ref), ref, gout)
    ins = [a.to(dev).requires_grad_(True) for a in ops]
    n0 = ff_conv.launches
    out = ff_conv(*ins)
    assert ff_conv.launches == n0 + 1
    got = torch.autograd.grad(out, ins, gout.to(dev))
    for g, w, name in zip(got, want, ("oc", "x", "w", "b")):
        assert g.dtype == w.dtype and g.shape == w.shape
        _grad_close(g, w, name)


@pytest.mark.cuda
def test_k3_raises_on_what_it_does_not_take(dev):
    ops = [a.to(dev) for a in _ff_operands(np.random.default_rng(0), (1, 8, 16, 64))]
    with pytest.raises(ValueError, match="ff_conv kernel"):
        ff_conv(ops[0].float(), *ops[1:])
    wide = [a.to(dev) for a in _ff_operands(np.random.default_rng(0), (1, 8, 16, 128))]
    with pytest.raises(ValueError, match="shared memory"):
        ff_conv(*wide)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [0, 1, 2])
def test_k1n_matches_plain(dev, levels):
    rng = np.random.default_rng(40 + levels)
    cb, c = 16, 16 * 4 ** levels
    body = _randn(rng, (2, 32, 64, 4 * cb), dtype=torch.bfloat16)
    args = [body[..., 2 * cb:3 * cb], _randn(rng, (c, 3 * c), c ** -0.5, torch.bfloat16),
            _randn(rng, (10, c // 2)), _randn(rng, (10, c // 2))]
    want = halo_attention_qkv_plain(*args, levels=levels).float()
    n0 = halo_attention_qkv.launches
    dargs = [a.to(dev) for a in args]
    dargs[0] = body.to(dev)[..., 2 * cb:3 * cb]  # a channel slice on the card too
    got = halo_attention_qkv(*dargs, levels=levels).float().cpu()
    assert halo_attention_qkv.launches == n0 + 1
    d = (got - want).abs()
    assert float(d.max()) < 5e-2 and float(d.mean()) < 5e-3


@pytest.mark.cuda
def test_k1n_gradient_and_tblock_apply(dev):
    """HaloAttnQkvFn's backward is the plain VJP; tblock_apply in bf16 with
    kernels is one K1n launch on the reflect-padded frame."""
    rng = np.random.default_rng(44)
    args = [_randn(rng, (1, 16, 16, 16), dtype=torch.bfloat16),
            _randn(rng, (16, 48), 0.25, torch.bfloat16),
            _randn(rng, (10, 8)), _randn(rng, (10, 8))]
    gout = _randn(rng, (1, 16, 16, 16), dtype=torch.bfloat16)
    ref = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(halo_attention_qkv_plain(*ref), ref, gout)
    ins = [a.to(dev).requires_grad_(True) for a in args]
    got = torch.autograd.grad(halo_attention_qkv(*ins), ins, gout.to(dev))
    for g, w, name in zip(got, want, ("x", "w_qkv", "rel_h", "rel_w")):
        _grad_close(g, w, name)
    blk = init_m2trans(Config(scale=2, n_feats=64, n_blocks=1), seed=0, device=dev).body[0]
    z = _randn(rng, (2, 20, 12, 16)).to(dev)
    n0 = halo_attention_qkv.launches
    with torch.inference_mode():
        got = port_model.tblock_apply(blk.attn1, z,
                                      policy=ComputePolicy(torch.bfloat16, True))
        want = port_model.tblock_apply(blk.attn1, z,
                                       policy=ComputePolicy(torch.bfloat16, False))
    assert halo_attention_qkv.launches == n0 + 1 and got.shape == (2, 20, 12, 16)
    d = (got.float() - want.float()).abs()
    assert float(d.max()) < 5e-2 and float(d.mean()) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name,nb", [("batch", 1), ("body", 4), ("body", 2)])
@pytest.mark.parametrize("g", [2, 8])
def test_k4_matches_plain_exactly(dev, name, nb, g):
    rng = np.random.default_rng(g)
    x = _randn(rng, (8, 12, 20, 16 * nb), dtype=torch.bfloat16)
    if name == "batch":
        pack = lambda t: relayout.pack_batch(t, g)
        unpack = lambda t: relayout.unpack_batch(t, g)
    else:
        pack = lambda t: relayout.pack_body(t, g, nb)
        unpack = lambda t: relayout.unpack_body(t, g, nb)
    want = pack(x)  # the plain version, on the CPU
    n0 = relayout.relayout.launches
    got = pack(x.to(dev))
    back = unpack(got)
    assert relayout.relayout.launches == n0 + 2
    assert torch.equal(got.cpu(), want) and torch.equal(back.cpu(), x)
    with pytest.raises(ValueError, match="relayout kernel"):
        relayout.pack_body(x.to(dev).float(), g, nb)


@pytest.mark.cuda
def test_bf16_eval_through_kernels(dev, tmp_path):
    """The eager bf16 eval of a two-frame set with FSIM/GMSD launches K1, K3
    and K2 once per CFTM branch, CFTM and frame, and stays close to the f32
    eval: PSNR within 0.1 dB, SSIM / FSIM / GMSD within 2e-3."""
    rng = np.random.default_rng(7)
    hr_dir, lr_dir = tmp_path / "HR", tmp_path / "LR_bicubic" / "X4"
    hr_dir.mkdir()
    lr_dir.mkdir(parents=True)
    for i, (h, w) in enumerate(((32, 32), (36, 28))):
        yy, xx = np.mgrid[0:4 * h, 0:4 * w]
        img = 0.5 + 0.4 * np.sin(xx / (5.0 + i))[..., None] * np.cos(yy / 9.0)[..., None]
        u8 = np.clip(img * 255 + rng.normal(0, 4, (4 * h, 4 * w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(u8).save(hr_dir / f"e{i}.jpg", quality=95)
        Image.fromarray(u8[::4, ::4]).save(lr_dir / f"e{i}x4.jpg", quality=95)
    ds = BenchmarkDataset(str(hr_dir), str(tmp_path / "LR_bicubic"), scale=4)
    cfg = Config(scale=4, n_feats=64, n_blocks=2)
    model = init_m2trans(cfg, seed=0, device=dev)
    fns = (cftm_branch, ff_conv, tail_band_fused)
    counts = [f.launches for f in fns]
    bf16 = evaluate_dataset(model, cfg, ds, full_metrics=True,
                            policy=ComputePolicy(torch.bfloat16, True), graphs=False)
    assert [f.launches - n for f, n in zip(fns, counts)] == [16, 4, 2]
    f32 = evaluate_dataset(model, cfg, ds, full_metrics=True, graphs=False)
    assert set(bf16) == {"psnr", "ssim", "fsim", "gmsd"}
    assert abs(bf16["psnr"] - f32["psnr"]) <= 0.1
    for k in ("ssim", "fsim", "gmsd"):
        assert abs(bf16[k] - f32[k]) <= 2e-3, (k, bf16, f32)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [448, 288])
@pytest.mark.parametrize("levels", [0, 1, 2])
def test_k1_at_extended_shard_shapes(dev, rows, levels):
    """K1 with the identity affine of the sharded CFTM at the extended-shard
    heights of a 512-row frame (256 + 2 x 96 rows on 2 ranks, 128 + 2 x 96
    on 4), W = 512, base width 16."""
    rng = np.random.default_rng(rows + levels)
    c = 16 * 4 ** levels
    body = _randn(rng, (1, rows, 512, 64), dtype=torch.bfloat16)
    wq = _randn(rng, (c, 3 * c), c ** -0.5, torch.bfloat16)
    rel_h, rel_w = _randn(rng, (10, c // 2)), _randn(rng, (10, c // 2))
    s = torch.full((1, 16), 0.5 if levels else 1.0)
    t = torch.zeros(1, 16)
    want = cftm_branch_plain(body[..., 16:32], wq, rel_h, rel_w, s, t, levels=levels)
    got = cftm_branch(body.to(dev)[..., 16:32], wq.to(dev), rel_h.to(dev),
                      rel_w.to(dev), s.to(dev), t.to(dev), levels=levels)
    d = (got.float().cpu() - want.float()).abs()
    assert float(d.max()) < 5e-2 and float(d.mean()) < 5e-3


@pytest.mark.cuda
def test_two_rank_sharded_forward_on_the_card(dev):
    """2 ranks sharing the card under gloo: the sharded x4 bf16 forward
    through K1, K3 and K2 (4 + 1 + 1 launches a rank for one block) against
    the single-device bf16 forward: mean 5e-3, max 1e-1."""
    import torch_ranks
    from m2trans_tpu_torch.parallel.mesh import run_ranks
    from m2trans_tpu_torch.train.convert import reference_state_dict

    cfg = Config(scale=4, n_feats=64, n_blocks=1)
    model = init_m2trans(cfg, seed=0)
    sd = {k: v.numpy() for k, v in reference_state_dict(model).items()}
    x = np.random.default_rng(0).uniform(0, 1, (1, 128, 64, 3)).astype(np.float32)
    kw = dict(scale=4, n_feats=64, n_blocks=1)
    res = run_ranks(torch_ranks.spatial_rank, 2, ([("x4", kw, sd, x, "bf16")], (), "cuda"))
    with torch.inference_mode():
        want = m2trans_apply(model.to(dev), torch.from_numpy(x).to(dev), cfg,
                             ComputePolicy(torch.bfloat16, True)).float().cpu().numpy()
    for r in res:
        assert r["x4_launches"] == [4, 1, 1] and r["loaded"] == []
        d = np.abs(r["x4"] - want)
        assert d.shape == (1, 512, 256, 3) and d.mean() < 5e-3 and d.max() < 1e-1


@pytest.mark.cuda
def test_data_space_mesh_forward_on_the_card(dev):
    """4 ranks sharing the card under gloo as a 2 x 2 (data, space) mesh: a
    batch of 2 over the data rows, each image's rows over its row, through
    K1, K3 and K2 (4 + 1 + 1 launches a rank for one block), against the
    single-device bf16 forward of the batch: mean 5e-3, max 1e-1."""
    import torch_ranks
    from m2trans_tpu_torch.parallel.mesh import run_ranks
    from m2trans_tpu_torch.train.convert import reference_state_dict

    cfg = Config(scale=4, n_feats=64, n_blocks=1)
    model = init_m2trans(cfg, seed=1)
    sd = {k: v.numpy() for k, v in reference_state_dict(model).items()}
    x = np.random.default_rng(1).uniform(0, 1, (2, 128, 64, 3)).astype(np.float32)
    kw = dict(scale=4, n_feats=64, n_blocks=1)
    res = run_ranks(torch_ranks.spatial_rank, 4,
                    ([("x4", kw, sd, x, "bf16", (2, 2))], (), "cuda"))
    with torch.inference_mode():
        want = m2trans_apply(model.to(dev), torch.from_numpy(x).to(dev), cfg,
                             ComputePolicy(torch.bfloat16, True)).float().cpu().numpy()
    for r in res:
        assert r["x4_launches"] == [4, 1, 1] and r["loaded"] == []
        d = np.abs(r["x4"] - want)
        assert d.shape == (2, 512, 256, 3) and d.mean() < 5e-3 and d.max() < 1e-1


# ---------------------------------------------------------------------------
# the train step and the eval forward replayed from CUDA graphs
# ---------------------------------------------------------------------------

_STEP_KINDS = {"bf16 kernels": dict(dtype="bfloat16", use_pallas=True),
               "f32": dict(dtype="float32"),
               "recipe": dict(dtype="bfloat16", use_pallas=True, lambda_clip=0.01)}


def _step_case(dev, kind):
    """The x4 step at the flagship width (one block), batch 2 x 96x96 ->
    384x384; the recipe's with a tiny random MedCLIP (clip size 56, 3
    patches) and ragged token ids."""
    from m2trans_tpu_torch.losses.semantic import SemanticLossFn
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip

    cfg = Config(scale=4, n_feats=64, n_blocks=1, **_STEP_KINDS[kind])
    fn, caps = None, None
    if kind == "recipe":
        mcfg = MedCLIPConfig.tiny()
        fn = SemanticLossFn(init_medclip(mcfg, seed=0, device=dev), mcfg, None,
                            clip_size=56)
        ids = np.random.default_rng(0).integers(5, 128, (2, 16)).astype(np.int32)
        mask = np.ones((2, 16), np.int32)
        mask[1, 9:] = 0
        caps = {"input_ids": ids, "attention_mask": mask}
    x = torch.rand(2, 96, 96, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    hr = torch.rand(2, 384, 384, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    return cfg, fn, caps, x, hr


def _train(dev, case, graphs, n=3, lrs=None, model=None, opt=None):
    """``n`` steps from init seed 0 (or ``model`` / ``opt``), the draws of
    step i from seed 10 + i, the LR of step i ``lrs[i]``; returns the
    losses, the parameters, Adam's state and the step."""
    from m2trans_tpu_torch.train.graphed import LOSS_NAMES
    from m2trans_tpu_torch.train.loop import set_lr

    cfg, fn, caps, x, hr = case
    if model is None:
        model = init_m2trans(cfg, seed=0, device=dev)
        opt = make_optimizer(cfg, model)
    step = make_train_step(cfg, model, opt, fn, graphs=graphs)
    losses = []
    for i in range(n):
        if lrs is not None:
            set_lr(opt, lrs[i])
        aux = step(x, hr, captions=caps, rng=np.random.default_rng(10 + i))
        losses.append(torch.stack([aux[k] for k in LOSS_NAMES]))
    torch.cuda.synchronize()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = {f"{k}.{s}": v.clone() for k, p in model.named_parameters()
             if p in opt.state for s, v in opt.state[p].items()}
    return torch.stack(losses), params, state, step


def _assert_same_run(got, want, exact):
    """Losses, parameters and Adam's state bit for bit; where two eager runs
    themselves differ (``exact`` False), each parameter's change and each
    moment within relative L2 5e-2 (PERF.md §2's gradient bound)."""
    (gl, gp, gs), (wl, wp, ws) = got[:3], want[:3]
    if exact:
        assert torch.equal(gl, wl), (gl, wl)
        for name in wp:
            assert torch.equal(gp[name], wp[name]), name
        for name in ws:
            assert torch.equal(gs[name], ws[name]), name
        return
    assert torch.allclose(gl, wl, rtol=5e-2, atol=0)
    for name in ws:
        if not name.endswith(".step"):
            assert _rel_l2(gs[name], ws[name]) <= 5e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(_STEP_KINDS))
def test_graphed_train_step_equals_eager(dev, kind):
    """Three replayed steps equal three eager steps from the same state, the
    augmentations drawn anew each step: losses, parameters and Adam's
    moments and steps bit for bit, for bf16 with the kernels, f32 and the
    recipe (MedCLIP loss). One graph is captured, counting 4 K1 + 1 K3 + 1
    K2 + 4 K1b + 1 K2b launches a block with the kernels (none in f32), and
    no statistics kernel: under autograd the statistics stay torch's."""
    case = _step_case(dev, kind)
    eager = _train(dev, case, graphs=False)
    again = _train(dev, case, graphs=False)
    graphed = _train(dev, case, graphs=True)
    exact = all(torch.equal(a, b) for a, b in zip(
        [eager[0], *eager[1].values(), *eager[2].values()],
        [again[0], *again[1].values(), *again[2].values()]))
    _assert_same_run(graphed, eager, exact)
    runner = graphed[3].graphed
    assert (runner.captures, runner.replays) == (1, 3)
    (launches,) = runner.capture_launches.values()
    k = kind != "f32"
    assert launches == {"cftm_branch": 4 * k, "ff_conv": k, "tail_band": k,
                        "cftm_branch_bwd": 4 * k, "tail_band_bwd": k,
                        "in_stats": 0}  # the step's statistics stay torch's
    assert bool(torch.isfinite(graphed[0]).all()) and bool((graphed[0][:, 2] > 0).all()) \
        == (kind == "recipe")


@pytest.mark.cuda
def test_lr_set_between_epochs_reaches_the_replay(dev):
    """``set_lr`` fills the optimizer's LR tensor, which the graph reads:
    replayed steps under a changing LR equal eager ones, and differ from
    steps at the first LR."""
    case = _step_case(dev, "bf16 kernels")
    lrs = [2e-4, 1e-4, 5e-5]
    graphed = _train(dev, case, graphs=True, lrs=lrs)
    eager = _train(dev, case, graphs=False, lrs=lrs)
    fixed = _train(dev, case, graphs=True, lrs=[2e-4] * 3)
    again = _train(dev, case, graphs=False, lrs=lrs)
    exact = all(torch.equal(a, b) for a, b in zip(eager[1].values(), again[1].values()))
    _assert_same_run(graphed, eager, exact)
    assert not torch.equal(graphed[1]["head.weight"], fixed[1]["head.weight"])


@pytest.mark.cuda
def test_no_grad_forward_after_graphed_steps_reads_the_new_weights(dev):
    """A replay writes the weights in place; the step bumps their version
    counters, so ``param_key`` moves, and the no-grad forward (the Trainer's
    panel, ``numerics.prepared``'s operands) and the graphed eval forward give what a
    fresh model loaded with the same weights gives."""
    from m2trans_tpu_torch.models.numerics import param_key, policy_from_config
    from m2trans_tpu_torch.train.evaluate import make_forward_fn

    case = _step_case(dev, "bf16 kernels")
    cfg, _, _, x, _ = case
    model = init_m2trans(cfg, seed=0, device=dev)
    opt = make_optimizer(cfg, model)
    policy = policy_from_config(cfg)
    lr1 = x[:1].clone()
    fwd = make_forward_fn(model, cfg, policy)
    with torch.no_grad():
        m2trans_apply(model, lr1, cfg, policy)  # fills _prepared's caches
    with torch.inference_mode():
        fwd(lr1)  # captures the eval graph
    keys = [param_key(p) for p in model.parameters()]
    _train(dev, case, graphs=True, n=2, model=model, opt=opt)
    moved = [param_key(p) for p in model.parameters()]
    assert all(a != b for a, b, p in zip(keys, moved, model.parameters())
               if p.requires_grad)
    fresh = init_m2trans(cfg, seed=3, device=dev)
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = m2trans_apply(model, lr1, cfg, policy)
        want = m2trans_apply(fresh, lr1, cfg, policy)
    assert torch.equal(got, want)
    with torch.inference_mode():
        assert torch.equal(fwd(lr1), want.float())


@pytest.mark.cuda
def test_resume_from_a_graphed_checkpoint_continues_identically(dev, tmp_path):
    """Two graphed steps, the epoch's checkpoint (the reference's format: a
    float LR, ``capturable`` False, ``step`` on the host), then a new model
    and optimizer restored from it take two more steps, graphed and eager:
    both equal four uninterrupted graphed steps."""
    from m2trans_tpu_torch.train import checkpoint as ckpt_lib

    case = _step_case(dev, "bf16 kernels")
    cfg = case[0]
    straight = _train(dev, case, graphs=True, n=4)
    again = _train(dev, case, graphs=True, n=4)
    exact = all(torch.equal(a, b) for a, b in zip(straight[1].values(), again[1].values()))
    model = init_m2trans(cfg, seed=0, device=dev)
    opt = make_optimizer(cfg, model)
    first = _train(dev, case, graphs=True, n=2, model=model, opt=opt)
    ckpt_lib.save_state(str(tmp_path), 1, 4, model, opt, {}, {"epochs": 1})
    saved = torch.load(tmp_path / "model_x4_1.pt", weights_only=True)
    group = saved["optimizer_state_dict"]["param_groups"][0]
    assert isinstance(group["lr"], float) and group["capturable"] is False
    assert all(st["step"].device.type == "cpu"
               for st in saved["optimizer_state_dict"]["state"].values())
    for graphs in (True, False):
        resumed = init_m2trans(cfg, seed=7, device=dev)
        opt2 = make_optimizer(cfg, resumed)
        assert ckpt_lib.restore_latest(str(tmp_path), 4, resumed, opt2)[0] == 1
        assert torch.is_tensor(opt2.param_groups[0]["lr"])
        assert opt2.param_groups[0]["capturable"] is True
        # the draws of steps 2 and 3 of the straight run
        cfg_, fn, caps, x, hr = case
        step = make_train_step(cfg, resumed, opt2, fn, graphs=graphs)
        losses = [torch.stack(list(step(x, hr, rng=np.random.default_rng(10 + i)).values()))
                  for i in (2, 3)]
        torch.cuda.synchronize()
        params = {k: p.detach().clone() for k, p in resumed.named_parameters()}
        state = {f"{k}.{s}": v for k, p in resumed.named_parameters()
                 if p in opt2.state for s, v in opt2.state[p].items()}
        _assert_same_run((torch.cat([first[0], torch.stack(losses)]), params, state),
                         straight, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16 kernels", "f32"])
def test_eval_metrics_with_graphs_equal_eager(dev, tmp_path, policy):
    """evaluate_dataset with the graphed forward (a graph a frame shape,
    two shapes here, kept on the model across calls) gives the eager
    metrics exactly, FSIM/GMSD included; a second evaluation captures
    nothing new."""
    from m2trans_tpu_torch.train.evaluate import eval_runner, metrics_runner

    rng = np.random.default_rng(8)
    hr_dir, lr_dir = tmp_path / "HR", tmp_path / "LR_bicubic" / "X4"
    hr_dir.mkdir()
    lr_dir.mkdir(parents=True)
    for i, (h, w) in enumerate(((32, 32), (36, 28), (32, 32))):
        u8 = rng.integers(0, 256, (4 * h, 4 * w, 3), dtype=np.uint8)
        Image.fromarray(u8).save(hr_dir / f"g{i}.jpg", quality=95)
        Image.fromarray(u8[::4, ::4]).save(lr_dir / f"g{i}x4.jpg", quality=95)
    ds = BenchmarkDataset(str(hr_dir), str(tmp_path / "LR_bicubic"), scale=4)
    cfg = Config(scale=4, n_feats=64, n_blocks=2)
    model = init_m2trans(cfg, seed=0, device=dev)
    pol = (ComputePolicy(torch.bfloat16, True) if policy == "bf16 kernels"
           else ComputePolicy())
    eager = evaluate_dataset(model, cfg, ds, full_metrics=True, policy=pol, graphs=False)
    graphed = evaluate_dataset(model, cfg, ds, full_metrics=True, policy=pol)
    runner = eval_runner(model, cfg, pol)
    metrics = metrics_runner(model, cfg, True)
    assert graphed == eager
    assert (runner.captures, runner.replays) == (2, 3)
    assert (metrics.captures, metrics.replays) == (2, 3)
    assert evaluate_dataset(model, cfg, ds, full_metrics=True, policy=pol) == eager
    assert (runner.captures, runner.replays) == (2, 6)
    # the weights written in place (an optimizer step): replays, no capture
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.001)
    assert evaluate_dataset(model, cfg, ds, full_metrics=True, policy=pol) == \
        evaluate_dataset(model, cfg, ds, full_metrics=True, policy=pol, graphs=False)
    assert (runner.captures, runner.replays, metrics.captures) == (2, 9, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["L1", "recipe-f32"])
def test_graphed_step_batch8_equals_eager(dev, kind):
    """The train step at batch 8 (new shapes for the packed cutmix draws,
    the one-hot crops and MedCLIP's 24 patches of 224x224), replayed from
    its CUDA graph, equals the eager step bit for bit over 3 steps: losses,
    parameters and Adam's state (the flagship width at 2 blocks, MedCLIP at
    its published width, seeded)."""
    from m2trans_tpu_torch.losses.semantic import SemanticLossFn
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip
    from m2trans_tpu_torch.tools.bench_clip_train import StepCase, replay_vs_eager

    fn = None
    if kind != "L1":
        mcfg = MedCLIPConfig()
        fn = SemanticLossFn(init_medclip(mcfg, seed=4, device=dev), mcfg, None)
    case = StepCase(kind, 8, dev, fn, n_blocks=2)
    assert replay_vs_eager(case, 3) == "bit for bit"


@pytest.mark.cuda
def test_release_bin_through_make_semantic_loss_on_card(dev, tmp_path):
    """A release-format pytorch_model.bin (``medclip_release_state_dict``),
    vocab.txt and tokenizer_config.json through ``make_semantic_loss`` on the
    card: the weights are the seeded model's, the port's tokenizer gives the
    ids, and the loss and its gradient match the same loss on the CPU."""
    import json

    from m2trans_tpu_torch.losses.semantic import make_semantic_loss
    from m2trans_tpu_torch.models.medclip.model import (
        MedCLIPConfig,
        init_medclip,
        medclip_release_state_dict,
    )

    ref = init_medclip(MedCLIPConfig.tiny(), seed=6)
    torch.save(medclip_release_state_dict(ref), tmp_path / "pytorch_model.bin")
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "carotid", "artery", "liver",
         "of", "the", "view", "##s"]) + "\n")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"do_lower_case": True}))
    cfg = Config(medclip_path=str(tmp_path), medclip_tiny=True, lambda_clip=0.01)
    fn = make_semantic_loss(cfg, dev)
    for a, b in zip(fn.model.state_dict().values(), ref.state_dict().values()):
        assert torch.equal(a.cpu(), b)
    caps = fn.tokenize(["View of the carotid artery", "the livers"])
    assert caps["input_ids"][0, :8].tolist() == [2, 10, 8, 9, 5, 6, 3, 0]
    assert caps["input_ids"][1, :6].tolist() == [2, 9, 7, 11, 3, 0]
    rng = np.random.default_rng(7)
    sr = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    hr = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    offsets = fn.draw_offsets(np.random.default_rng(3), 2, 64, 64)
    cpu_fn = make_semantic_loss(cfg, torch.device("cpu"))
    want_sr = sr.clone().requires_grad_(True)
    got_sr = sr.to(dev).detach().requires_grad_(True)
    got = fn(got_sr, hr.to(dev), caps, offsets=offsets)
    want = cpu_fn(want_sr, hr, caps, offsets=offsets)
    got.backward()
    want.backward()
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=1e-4)
    assert torch.allclose(got_sr.grad.cpu(), want_sr.grad, rtol=1e-3, atol=1e-6)


# ---------------------------------------------------------------------------
# MedCLIP's Swin window attention (csrc/swin_attn.cu)
# ---------------------------------------------------------------------------

# (batch, map side, channels, heads, shift): Swin-tiny's four stages at the
# recipe's 6 patches (hd 32; SW-MSA in stages 1-3, the window covers stage
# 4's map), an unshifted stage-1 block, and MedCLIPConfig.tiny()'s two
# stages (hd 8)
SWIN_SHAPES = [(6, 56, 96, 3, 3), (6, 56, 96, 3, 0), (6, 28, 192, 6, 3),
               (6, 14, 384, 12, 3), (6, 7, 768, 24, 0), (2, 14, 16, 2, 3),
               (2, 7, 32, 4, 0), (1, 14, 64, 4, 3)]
# kernel vs plain: max|a - b| <= max(atol, rtol * max|b|); f32 sums in
# another order than cuBLAS, bf16 may round P or a product one ulp apart at
# a tie (the K1b bound)
SWIN_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-3, 2e-2)}


def _swin_case(dev, shape, dtype, seed=0):
    b, hw, c, heads, shift = shape
    rng = np.random.default_rng(seed)
    q, k, v, gout = (_randn(rng, (b, hw, hw, c), dtype=dtype).to(dev) for _ in range(4))
    table = _randn(rng, (169, heads), dtype=dtype).to(dev)
    return q, k, v, table, gout, heads, shift


def _swin_run(fn, case):
    q, k, v, table, gout, heads, shift = case
    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fn(*ins, table, heads, 7, shift)
    return [out.detach(), *torch.autograd.grad(out, ins, gout)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SWIN_SHAPES)
def test_swin_attn_matches_plain(dev, shape, dtype):
    """The kernels' output, dq, dk and dv against the plain version's, and
    a second run bit for bit."""
    from m2trans_tpu_torch.ops.kernels.swin_attn import (
        window_attention,
        window_attention_plain,
    )

    case = _swin_case(dev, shape, dtype)
    n0 = window_attention.launches
    got = _swin_run(window_attention, case)
    torch.cuda.synchronize()
    assert window_attention.launches == n0 + 2
    again = _swin_run(window_attention, case)
    want = _swin_run(window_attention_plain, case)
    atol, rtol = SWIN_TOL[dtype]
    for name, a, b, c in zip(("out", "dq", "dk", "dv"), got, want, again):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert torch.equal(a, c), f"{name}: two runs differ"
        err, top = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
        assert err <= max(atol, rtol * top), f"{name}: max err {err:.3g}, max {top:.3g}"


@pytest.mark.cuda
def test_swin_attn_raises_on_what_it_does_not_take(dev):
    from m2trans_tpu_torch.ops.kernels.swin_attn import window_attention

    q, k, v, table, _, _, _ = _swin_case(dev, (1, 14, 48, 2, 3), torch.float32)
    with pytest.raises(ValueError, match="head dim"):  # hd 24
        window_attention(q, k, v, table, 2, 7, 3)
    q, k, v, table, _, heads, _ = _swin_case(dev, (1, 14, 64, 2, 3), torch.float32)
    with pytest.raises(ValueError, match="multiples of the window"):
        window_attention(q[:, :12], k[:, :12], v[:, :12], table, heads, 7, 3)


@pytest.mark.cuda
def test_swin_attn_in_a_cuda_graph_equals_eager(dev):
    """Forward and backward captured in a CUDA graph replay the eager bits;
    the capture counts 2 launches and a replay none."""
    from m2trans_tpu_torch.ops.kernels.swin_attn import window_attention

    case = _swin_case(dev, (6, 28, 192, 6, 3), torch.float32, seed=1)
    eager = _swin_run(window_attention, case)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _swin_run(window_attention, case)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = window_attention.launches
    with torch.cuda.graph(graph):
        static = _swin_run(window_attention, case)
    assert window_attention.launches == n0 + 2
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    assert window_attention.launches == n0 + 2
    for a, b in zip(static, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_swin_attn_launches_in_a_recipe_capture(dev):
    """The recipe step's MedCLIP (tiny: 2 Swin blocks) launches 2 x 3
    kernels a step (HR forward, SR forward, SR backward): 6 eagerly, 6 more
    for the side-stream step and 6 for the capture, none in a replay."""
    from m2trans_tpu_torch.ops.kernels.swin_attn import window_attention

    case = _step_case(dev, "recipe")
    n0 = window_attention.launches
    _train(dev, case, graphs=False, n=1)
    n1 = window_attention.launches
    _train(dev, case, graphs=True, n=3)
    assert (n1 - n0, window_attention.launches - n1) == (6, 12)


@pytest.mark.cuda
def test_semantic_loss_gradient_through_the_swin_kernels(dev, monkeypatch):
    """d(semantic loss)/d sr through MedCLIP at its published width (f32,
    seeded weights, 3 patches of 224 from 2 x 384x384) with the kernels
    against the same with the plain attention: the loss rtol 2e-5, the
    gradient rtol 1e-4 (the staged loss's d/d sr test against JAX)."""
    from m2trans_tpu_torch.losses.semantic import (
        clip_image_sims,
        clip_text_embed,
        crop_offsets,
        semantic_loss_staged,
    )
    from m2trans_tpu_torch.models.medclip import swin
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip
    from m2trans_tpu_torch.ops.kernels.swin_attn import window_attention_plain

    mcfg = MedCLIPConfig()
    model = init_medclip(mcfg, seed=4, device=dev)
    rng = np.random.default_rng(5)
    sr, hr = (torch.from_numpy(rng.uniform(0, 1, (2, 384, 384, 3)).astype(np.float32))
              .to(dev) for _ in range(2))
    ids = torch.from_numpy(rng.integers(5, mcfg.text.vocab_size, (2, 16))).to(dev)
    mask = torch.ones_like(ids)
    offsets = crop_offsets(rng, 2, 384, 384, 2, 224)
    with torch.no_grad():
        t = clip_text_embed(model, ids, mask)
        sim_y = clip_image_sims(model, hr, offsets, t)

    def loss_and_grad():
        s = sr.clone().requires_grad_(True)
        loss = semantic_loss_staged(model, s, offsets, t, sim_y)
        (g,) = torch.autograd.grad(loss, [s])
        return float(loss), g

    got = loss_and_grad()
    monkeypatch.setattr(swin, "window_attention", window_attention_plain)
    want = loss_and_grad()
    assert got[0] == pytest.approx(want[0], rel=2e-5)
    assert float(want[1].abs().max()) > 0
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# HAT's attention kernels (csrc/hat_attn.cu) and HAT's served forward
# ---------------------------------------------------------------------------

# kernel vs plain, bf16: max|a - b| <= max(2e-3, 2e-2 * max|b|) (the Swin
# kernels' bf16 bound: the kernel rounds the unnormalised P to bf16 and
# divides by the f32 row sum once, the plain version rounds the normalised P
# and the product; both round the output to bf16), and the mean |a - b| under
# 2e-3 of max|b| (a wrong bias row or mask shifts every output of a window)
HAT_TOL = (2e-3, 2e-2, 2e-3)
# (batch, H, W, kind): the published block at 96^2, shift 0 and 8, OCA;
# a map of other sides (64 x 112, windows of two rows of seven)
HAT_CASES = [(2, 96, 96, 0), (2, 96, 96, 8), (2, 96, 96, "oca"), (1, 64, 112, 8),
             (1, 64, 112, "oca")]


def _hat_case(dev, b, h, w, seed=0, c=180, heads=6):
    """q, k, v as views of one (B, H, W, 3C) bf16 qkv tensor, a bias table
    of each kind (f32)."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, h, w, 3 * c, generator=g).bfloat16().to(dev)
    tables = {k: (torch.randn(n, heads, generator=g) * 0.5).to(dev)
              for k, n in (("sa", 31 * 31), ("oca", 39 * 39))}
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], tables, heads


def _hat_attend(kind, q, k, v, tables, heads, plain=False):
    from m2trans_tpu_torch.ops.kernels import hat_attn
    from m2trans_tpu_torch.ops.kernels.swin_attn import window_attention_plain

    if kind == "oca":
        fn = hat_attn.overlap_attention_plain if plain else hat_attn.overlap_attention
        return fn(q, k, v, tables["oca"], heads, 16, 24)
    if plain:
        return window_attention_plain(q, k, v, tables["sa"], heads, 16, kind)
    return hat_attn.window_attention_16(q, k, v, tables["sa"], heads, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("case", HAT_CASES)
def test_hat_attn_matches_plain(dev, case):
    """Each kernel against its plain version in bf16 on views of one qkv
    tensor, a second run bit for bit; window 16 leaves MedCLIP's window-7
    kernel's count alone."""
    from m2trans_tpu_torch.ops.kernels import hat_attn
    from m2trans_tpu_torch.ops.kernels.swin_attn import window_attention

    b, h, w, kind = case
    q, k, v, tables, heads = _hat_case(dev, b, h, w)
    counter = hat_attn.overlap_attention if kind == "oca" else hat_attn.window_attention_16
    n0, swin0 = counter.launches, window_attention.launches
    with torch.no_grad():
        got = _hat_attend(kind, q, k, v, tables, heads)
        torch.cuda.synchronize()
        again = _hat_attend(kind, q, k, v, tables, heads)
        want = _hat_attend(kind, q, k, v, tables, heads, plain=True)
    assert counter.launches == n0 + 2 and window_attention.launches == swin0
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (b, h, w, 180)
    assert torch.equal(got, again)
    d = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    assert float(d.max()) <= max(HAT_TOL[0], HAT_TOL[1] * top), float(d.max())
    assert float(d.mean()) <= HAT_TOL[2] * top, float(d.mean())


@pytest.mark.cuda
def test_hat_attn_contiguous_operands_and_what_it_refuses(dev):
    """Contiguous q, k, v (pixel stride C) give the views' bits; f32, odd or
    too wide heads, sides off the window and operands that want a gradient
    raise."""
    from m2trans_tpu_torch.ops.kernels import hat_attn

    q, k, v, tables, heads = _hat_case(dev, 1, 32, 48, seed=3)
    with torch.no_grad():
        for kind in (8, "oca"):
            a = _hat_attend(kind, q, k, v, tables, heads)
            b = _hat_attend(kind, q.contiguous(), k.contiguous(), v.contiguous(), tables, heads)
            assert torch.equal(a, b)
    sa = tables["sa"]
    with pytest.raises(ValueError, match="bf16"):
        hat_attn.window_attention_16(q.float(), k.float(), v.float(), sa, heads, 0)
    with pytest.raises(ValueError, match="head dim"):
        hat_attn.window_attention_16(q, k, v, torch.zeros(961, 4, device=dev), 4, 0)
    with pytest.raises(ValueError, match="multiples of 16"):
        hat_attn.window_attention_16(q[:, :24], k[:, :24], v[:, :24], sa, heads, 0)
    with pytest.raises(ValueError, match="forward only"):
        hat_attn.overlap_attention(q.detach().requires_grad_(True), k, v, tables["oca"], heads)


def _hat_cfg(**kw):
    import os

    from m2trans_tpu_torch.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return load_config(os.path.join(root, "m2trans_tpu_torch", "configs", "HAT_SRx4.yml"),
                       overrides=kw or None)


@pytest.mark.cuda
def test_hat_graphed_forward_launches_and_bits(dev):
    """HAT_SRx4 at its published widths (seeded init): the serving forward
    replayed from a CUDA graph equals the eager forward bit for bit, its
    capture counts 36 SW-MSA, 6 OCA and 86 LayerNorm launches, and it stays
    near the plain bf16 forward (the kernels' plain versions)."""
    from m2trans_tpu_torch.models.hat import hat_apply, init_hat

    cfg = _hat_cfg()
    model = init_hat(cfg, seed=1, device=dev)
    policy = ComputePolicy(torch.bfloat16, True)
    x = torch.rand(2, 64, 80, 3, generator=torch.Generator().manual_seed(2)).to(dev)
    gf = GraphedForward(model, cfg, policy)
    got = gf(x).clone()
    assert gf.capture_launches[tuple(x.shape)] == {"hat_wattn": 36, "hat_oca": 6,
                                                   "row_norm": 86}
    with torch.inference_mode():
        want = serving_forward(model, x, cfg, policy, False)
        plain = hat_apply(model, x, cfg, ComputePolicy(torch.bfloat16, False)).float()
    assert got.shape == (2, 256, 320, 3) and torch.equal(got, want)
    assert torch.equal(gf(x), want)
    assert float((got - plain).abs().mean()) < 2e-3


@pytest.mark.cuda
def test_hat_infer_cli_on_a_release_pth(dev, tmp_path):
    """``python -m m2trans_tpu_torch.infer`` with the HAT yml and a seeded
    ``.pth`` in the release layout: graphs with 36 + 6 attention and 86
    LayerNorm launches a capture,
    PNGs of 4x frames that are no multiple of the window, and nothing of
    jax or the JAX package loaded."""
    import json
    import os
    import subprocess
    import sys

    from m2trans_tpu_torch.models.hat import init_hat, release_state_dict

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    torch.save({"params_ema": release_state_dict(init_hat(_hat_cfg(), seed=5))},
               tmp_path / "HAT_SRx4.pth")
    src = tmp_path / "frames"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (60, 75, 3), dtype=np.uint8)).save(src / f"{i}.png")
    argv = ["infer", "--config", os.path.join(root, "m2trans_tpu_torch", "configs",
                                              "HAT_SRx4.yml"),
            "--model_path", str(tmp_path / "HAT_SRx4.pth"), "--input", str(src),
            "--output", str(tmp_path / "out")]
    code = ("import runpy, sys; sys.argv = %r; runpy.run_module('m2trans_tpu_torch.infer', "
            "run_name='__main__'); bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'm2trans_tpu'}); print('LOADED ' + ','.join(bad))" % argv)
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1].strip() == "LOADED"
    report = json.loads(lines[-2])
    assert report["cuda_graphs"]["launches_per_capture"] == {
        "1x60x75x3": {"hat_wattn": 36, "hat_oca": 6, "row_norm": 86}}
    assert report["cuda_graphs"]["replays"] == 3
    assert sorted(os.listdir(tmp_path / "out")) == ["0.png", "1.png", "2.png"]
    assert np.asarray(Image.open(tmp_path / "out" / "0.png")).shape == (240, 300, 3)


# SS2D's scan kernel against its plain version: one bf16 rounding step of the
# largest output at most (both compute in f32 and differ in the last bits:
# the hardware exp2 and log2, another order of the sums), and the mean under
# 1e-5 of it (almost no element rounds the other way)
SCAN_TOL = (4e-3, 1e-5)
# (batch, H, W, d_inner, R): a request at the published widths; a frame
# that is not square (a swapped transpose shows) and no multiple of the
# kernel's 64-position tile; narrower maps with R = 8, 16
SCAN_CASES = [(8, 96, 96, 360, 12), (2, 37, 53, 360, 12), (1, 21, 6, 72, 8),
              (1, 9, 11, 24, 16)]


def _scan_case(dev, b, h, w, d, rank, seed=0):
    """bf16 x and projections, f32 tables of no special structure."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, h, w, d, generator=g) * 0.5).bfloat16().to(dev)
    xdbl = (torch.randn(b, h, w, 4 * (rank + 32), generator=g) * 0.5).bfloat16().to(dev)
    return (x, xdbl, (torch.randn(4, d, rank, generator=g) * rank ** -0.5).to(dev),
            (torch.randn(4, d, generator=g) - 3.0).to(dev),
            (-torch.exp(torch.randn(4, d, 16, generator=g))).to(dev),
            torch.randn(4, d, generator=g).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES)
def test_ss2d_scan_matches_plain(dev, case):
    """The four-way scan kernel against its plain version on the same card
    tensors, a second call bit for bit, one launch a call."""
    from m2trans_tpu_torch.ops.kernels.ss2d_scan import ss2d_scan, ss2d_scan_plain

    args = _scan_case(dev, *case)
    n0 = ss2d_scan.launches
    with torch.no_grad():
        got = ss2d_scan(*args)
        torch.cuda.synchronize()
        again = ss2d_scan(*args)
        want = ss2d_scan_plain(*args)
    assert ss2d_scan.launches == n0 + 2
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == case[:4]
    assert torch.equal(got, again)
    d = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    assert float(d.max()) <= SCAN_TOL[0] * top, float(d.max())
    assert float(d.mean()) <= SCAN_TOL[1] * top, float(d.mean())


@pytest.mark.cuda
def test_ss2d_scan_refuses_what_it_does_not_take(dev):
    from m2trans_tpu_torch.ops.kernels.ss2d_scan import ss2d_scan

    x, xdbl, dt_w, dt_b, a, ds = _scan_case(dev, 1, 8, 8, 48, 4)
    with pytest.raises(ValueError, match="bf16"):
        ss2d_scan(x.float(), xdbl, dt_w, dt_b, a, ds)
    with pytest.raises(ValueError, match="multiple of 4"):
        ss2d_scan(x, xdbl.view(1, 8, 8, 4, 36)[..., :34].contiguous(), dt_w[..., :2].contiguous(),
                  dt_b, a, ds)
    with pytest.raises(ValueError, match="forward only"):
        ss2d_scan(x, xdbl, dt_w.requires_grad_(True), dt_b, a, ds)


def _mambair_cfg():
    import os

    from m2trans_tpu_torch.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return load_config(os.path.join(root, "m2trans_tpu_torch", "configs", "MambaIR_SRx4.yml"))


@pytest.mark.cuda
def test_mambair_graphed_forward_launches_and_bits(dev):
    """MambaIR_SRx4 at its published widths (the release init): the serving
    forward replayed from a CUDA graph equals the eager forward bit for bit,
    its capture counts 36 scan and 110 LayerNorm launches, it stays near the
    plain bf16 forward (the kernels' plain versions); M2Trans's and HAT's
    forwards launch no scan, and M2Trans's no LayerNorm."""
    from m2trans_tpu_torch.models.hat import init_hat
    from m2trans_tpu_torch.models.mambair import init_mambair, mambair_apply
    from m2trans_tpu_torch.ops.kernels.row_norm import row_norm
    from m2trans_tpu_torch.ops.kernels.ss2d_scan import ss2d_scan

    cfg = _mambair_cfg()
    model = init_mambair(cfg, seed=1, device=dev)
    policy = ComputePolicy(torch.bfloat16, True)
    x = torch.rand(2, 64, 80, 3, generator=torch.Generator().manual_seed(2)).to(dev)
    gf = GraphedForward(model, cfg, policy)
    got = gf(x).clone()
    assert gf.capture_launches[tuple(x.shape)] == {"ss2d_scan": 36, "row_norm": 110}
    with torch.inference_mode():
        want = serving_forward(model, x, cfg, policy, False)
        plain = mambair_apply(model, x, cfg, ComputePolicy(torch.bfloat16, False)).float()
    assert got.shape == (2, 256, 320, 3) and torch.equal(got, want)
    assert torch.equal(gf(x), want)
    assert float((got - plain).abs().mean()) < 2e-3
    n0, r0 = ss2d_scan.launches, row_norm.launches
    small = Config(scale=4, n_feats=64, n_blocks=1, num_heads=4, dtype="bfloat16",
                   use_pallas=True)
    hat_cfg = _hat_cfg()
    with torch.inference_mode():
        serving_forward(init_m2trans(small, seed=0, device=dev), x[:1, :32, :32], small, policy,
                        False)
        assert row_norm.launches == r0
        serving_forward(init_hat(hat_cfg, seed=0, device=dev), x[:1, :32, :32], hat_cfg, policy,
                        False)
    assert ss2d_scan.launches == n0


@pytest.mark.cuda
def test_mambair_infer_cli_on_a_release_pth(dev, tmp_path):
    """``python -m m2trans_tpu_torch.infer`` with the MambaIR yml and a
    seeded ``.pth`` in the release layout (``params``): graphs with 36 scan
    and 110 LayerNorm launches a capture, PNGs of 4x frames, and nothing of jax or the JAX
    package loaded."""
    import json
    import os
    import subprocess
    import sys

    from m2trans_tpu_torch.models.mambair import init_mambair
    from m2trans_tpu_torch.models.sr_blocks import release_state_dict

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    torch.save({"params": release_state_dict(init_mambair(_mambair_cfg(), seed=5))},
               tmp_path / "MambaIR_SR_x4.pth")
    src = tmp_path / "frames"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (60, 75, 3), dtype=np.uint8)).save(src / f"{i}.png")
    argv = ["infer", "--config", os.path.join(root, "m2trans_tpu_torch", "configs",
                                              "MambaIR_SRx4.yml"),
            "--model_path", str(tmp_path / "MambaIR_SR_x4.pth"), "--input", str(src),
            "--output", str(tmp_path / "out")]
    code = ("import runpy, sys; sys.argv = %r; runpy.run_module('m2trans_tpu_torch.infer', "
            "run_name='__main__'); bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'm2trans_tpu'}); print('LOADED ' + ','.join(bad))" % argv)
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1].strip() == "LOADED"
    report = json.loads(lines[-2])
    assert report["cuda_graphs"]["launches_per_capture"] == {
        "1x60x75x3": {"ss2d_scan": 36, "row_norm": 110}}
    assert report["cuda_graphs"]["replays"] == 3
    assert sorted(os.listdir(tmp_path / "out")) == ["0.png", "1.png", "2.png"]
    assert np.asarray(Image.open(tmp_path / "out" / "0.png")).shape == (240, 300, 3)


# The LayerNorm kernel (csrc/row_norm.cu) against its plain version, the
# torch composition, on the same card tensors: x' (the residual forms'
# sum) bit for bit; the normed rows within one bf16 step of the result,
# since the two differ only in the order of the statistics' f32 sums, and
# within one step of 2^-8 where the result is smaller (there the norm's
# term and beta cancel, and those sums' last bits are many steps of what is
# left); the gated rows within two, as a step of the norm's rounding carries
# through the product with SiLU(z) (up to twice the product's own step)
# before it rounds again.
ROW_NORM_CASES = [(8, 96, 96, 180), (8, 96, 96, 360), (1, 37, 53, 180), (2, 37, 53, 360)]


def _bf16_steps(got, want):
    """|got - want| in bf16 steps of |want|, or of 2^-8 where |want| is
    smaller (bf16 in)."""
    top = want.float().abs().clamp_min(2.0 ** -8)
    return (got.float() - want.float()).abs() / torch.exp2(torch.floor(torch.log2(top)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["plain", "residual", "scaled", "gated"])
@pytest.mark.parametrize("shape", ROW_NORM_CASES)
def test_row_norm_matches_plain(dev, shape, form):
    """Each form at the served maps' shapes (HAT's and MambaIR's 180
    channels, MambaIR's 360 of out_norm) and at ragged ones (an odd number
    of rows, so a warp holds a row alone): a second call bit for bit, one
    launch a call."""
    from m2trans_tpu_torch.ops.kernels.row_norm import row_norm, row_norm_plain

    g = torch.Generator().manual_seed(shape[-1] + shape[1])
    c = shape[-1]
    x = (torch.randn(shape, generator=g) * 1.5 + torch.randn(c, generator=g)).bfloat16().to(dev)
    other = (torch.randn(shape, generator=g) * 2.0).bfloat16().to(dev)
    scale = (1.0 + 0.1 * torch.randn(c, generator=g)).bfloat16().to(dev)
    w = (1.0 + 0.2 * torch.randn(c, generator=g)).bfloat16().to(dev)
    b = (0.1 * torch.randn(c, generator=g)).bfloat16().to(dev)
    kw = {"plain": {}, "residual": {"add": other}, "scaled": {"add": other, "scale": scale},
          "gated": {"gate": other}}[form]
    n0 = row_norm.launches
    with torch.no_grad():
        got = row_norm(x, w, b, 1e-5, **kw)
        torch.cuda.synchronize()
        again = row_norm(x, w, b, 1e-5, **kw)
        want = row_norm_plain(x, w, b, 1e-5, **kw)
    assert row_norm.launches == n0 + 2
    if "add" in kw:
        assert torch.equal(got[0], want[0]) and torch.equal(got[0], again[0])
        got, again, want = got[1], again[1], want[1]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == shape
    assert torch.equal(got, again)
    steps = _bf16_steps(got, want)
    assert float(steps.max()) <= (2 if form == "gated" else 1), float(steps.max())
    assert float((steps > 0).float().mean()) < 0.01
