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
bound of their gradient tests).
"""

import numpy as np
import pytest
import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import ComputePolicy, init_m2trans, m2trans_apply
from m2trans_tpu_torch.ops.kernels.halo_attn import (
    cftm_branch,
    cftm_branch_bwd,
    cftm_branch_plain,
    cftm_branch_plain_vjp,
)
from m2trans_tpu_torch.ops.kernels.tail_band import (
    tail_band_apply,
    tail_band_bwd,
    tail_band_fused,
    tail_band_operands,
    tail_band_plain_vjp,
)
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
    """One CFTM at the flagship width: 4 K1 launches and 1 K2 launch, and
    the output agrees with the plain bf16 path on the card."""
    cfg = Config(scale=4, n_feats=64, n_blocks=1)
    model = init_m2trans(cfg, seed=0, device=dev)
    x = torch.rand(2, 40, 36, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    n1, n2 = cftm_branch.launches, tail_band_fused.launches
    with torch.inference_mode():
        got = m2trans_apply(model, x, cfg, ComputePolicy(torch.bfloat16, True)).float()
        assert (cftm_branch.launches - n1, tail_band_fused.launches - n2) == (4, 1)
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
    flagship width (one block): 4 K1 + 1 K2 forward and 4 K1b + 1 K2b
    backward launches, finite gradients for every trainable parameter."""
    cfg = Config(scale=4, n_feats=64, n_blocks=1, dtype="bfloat16", use_pallas=True)
    model = init_m2trans(cfg, seed=0, device=dev)
    step = make_train_step(cfg, model, make_optimizer(cfg, model))
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    hr = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    counts = [f.launches for f in (cftm_branch, tail_band_fused, cftm_branch_bwd,
                                   tail_band_bwd)]
    step(x, hr)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(
        (cftm_branch, tail_band_fused, cftm_branch_bwd, tail_band_bwd), counts)] == [4, 1, 4, 1]
    for name, p in model.named_parameters():
        if p.requires_grad:
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
