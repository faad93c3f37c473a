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
sums), its gradients to the same bound; K1n as K1; K4 exactly.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data.benchmark import BenchmarkDataset
from m2trans_tpu_torch.models import m2trans as port_model
from m2trans_tpu_torch.models.m2trans import ComputePolicy, init_m2trans, m2trans_apply
from m2trans_tpu_torch.ops.kernels import relayout
from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv, ff_conv_plain, ff_weight_hwio
from m2trans_tpu_torch.ops.kernels.halo_attn import (
    cftm_branch,
    cftm_branch_bwd,
    cftm_branch_plain,
    cftm_branch_plain_vjp,
    halo_attention_qkv,
    halo_attention_qkv_plain,
)
from m2trans_tpu_torch.ops.kernels.tail_band import (
    tail_band_apply,
    tail_band_bwd,
    tail_band_fused,
    tail_band_operands,
    tail_band_plain_vjp,
)
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


@pytest.mark.cuda
def test_train_step_through_kernels(dev):
    """One bf16 step of the training loop's ``make_train_step`` at the
    flagship width (one block): 4 K1 + 1 K3 + 1 K2 forward and 4 K1b + 1 K2b
    backward launches, finite gradients for every trainable parameter."""
    cfg = Config(scale=4, n_feats=64, n_blocks=1, dtype="bfloat16", use_pallas=True)
    model = init_m2trans(cfg, seed=0, device=dev)
    step = make_train_step(cfg, model, make_optimizer(cfg, model))
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


def _ff_operands(rng, shape):
    c = shape[-1]
    return (_randn(rng, shape, dtype=torch.bfloat16),
            _randn(rng, shape, dtype=torch.bfloat16),
            ff_weight_hwio(_randn(rng, (c, c, 3, 3), (9 * c) ** -0.5)),
            _randn(rng, (c,), (9 * c) ** -0.5, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 32, 64), (1, 13, 21, 64),
                                   (2, 8, 16, 16), (1, 9, 40, 96)])
def test_k3_matches_plain(dev, shape):
    """Whole tiles, edge tiles in both directions, and other widths."""
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
    """The bf16 eval of a two-frame set with FSIM/GMSD launches K1, K3 and
    K2 once per CFTM branch, CFTM and frame, and stays close to the f32
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
                            policy=ComputePolicy(torch.bfloat16, True))
    assert [f.launches - n for f, n in zip(fns, counts)] == [16, 4, 2]
    f32 = evaluate_dataset(model, cfg, ds, full_metrics=True)
    assert set(bf16) == {"psnr", "ssim", "fsim", "gmsd"}
    assert abs(bf16["psnr"] - f32["psnr"]) <= 0.1
    for k in ("ssim", "fsim", "gmsd"):
        assert abs(bf16[k] - f32[k]) <= 2e-3, (k, bf16, f32)
