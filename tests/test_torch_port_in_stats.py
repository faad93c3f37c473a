"""The CFTM's instance-norm statistics as K1's per-branch affine
(``ops/kernels/in_stats.py``) on the CPU: the plain version against the
statistics and per-branch slicing it replaced and against the JAX package's
statistics, the wrapper's checks, and the fused CFTM's choice between the
two paths. The kernel itself runs in ``tests/test_torch_port_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from m2trans_tpu_torch.models import m2trans as port_model
from m2trans_tpu_torch.models.m2trans import CFTM, ComputePolicy
from m2trans_tpu_torch.ops.kernels import in_stats as stats_mod
from m2trans_tpu_torch.ops.kernels.in_stats import in_stats_affine, in_stats_affine_plain
from m2trans_tpu_torch.ops.norm import in_stats


def _map(seed, shape):
    """A seeded bf16 NHWC map whose channels have their own offset and
    scale, as a block's input has, so that no mean sits near zero and
    E[x]^2 stays within four times the variance."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    off = rng.uniform(0.2, 1.0, c) * rng.choice([-1.0, 1.0], c)
    scale = rng.uniform(0.5, 1.5, c)
    x = (rng.standard_normal(shape) * scale + off).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def _sliced(x):
    """What ``_cftm_apply_fused`` computed before the kernel: ``in_stats``,
    each branch's contiguous slice, branches 1-3 halved."""
    inv, t = in_stats(x)
    cb = x.shape[-1] // 4
    out = []
    for k in range(4):
        sk = inv[:, k * cb:(k + 1) * cb].contiguous()
        tk = t[:, k * cb:(k + 1) * cb].contiguous()
        out.append((sk, tk) if k == 0 else (sk * 0.5, tk * 0.5))
    return out


@pytest.mark.parametrize("shape", [(1, 40, 56, 64), (8, 24, 32, 64), (3, 16, 8, 128)])
def test_plain_version_is_the_sliced_statistics_bit_for_bit(shape):
    x = _map(1, shape)
    st = in_stats_affine(x)
    assert st.shape == (2, 4, shape[0], shape[-1] // 4) and st.dtype == torch.float32
    for k, (sk, tk) in enumerate(_sliced(x)):
        assert st[0, k].is_contiguous() and st[1, k].is_contiguous()
        assert torch.equal(st[0, k], sk) and torch.equal(st[1, k], tk)


@pytest.mark.parametrize("bsz", [1, 8])
def test_plain_version_matches_the_jax_statistics(bsz):
    """m2trans_tpu/models/m2trans.py ``_cftm_apply_fused``'s statistics, on
    the same bf16 values, laid out and halved as the kernel writes them."""
    x = _map(2, (bsz, 32, 48, 64))
    xf = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16).astype(jnp.float32)
    mean = jnp.mean(xf, axis=(1, 2))
    var = jnp.mean(jnp.square(xf), axis=(1, 2)) - jnp.square(mean)
    inv = lax.rsqrt(var + 1e-5)
    tfull = -mean * inv
    half = np.array([1.0, 0.5, 0.5, 0.5], np.float32)[:, None, None]
    want = np.stack([np.asarray(v).reshape(bsz, 4, 16).transpose(1, 0, 2) * half
                     for v in (inv, tfull)])
    # f32 sums in another order: E[x^2] - E[x]^2 turns their rounding
    # into up to ~4x as much relative error in the variance
    np.testing.assert_allclose(in_stats_affine_plain(x).numpy(), want, rtol=1e-5,
                               atol=1e-7)


def test_wrapper_raises_for_an_unsupported_device():
    x = torch.empty((1, 8, 8, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        in_stats_affine(x)


@pytest.mark.parametrize("case,match", [
    ("f32", "bf16"), ("strided", "contiguous"), ("c48", "multiple of 32"),
    ("empty", "empty"), ("unaligned", "16-byte")])
def test_kernel_checks_refuse_what_it_does_not_take(case, match):
    x = _map(3, (2, 8, 8, 64))
    bad = {"f32": lambda: x.float(),
           "strided": lambda: x[:, :, ::2],
           "c48": lambda: _map(3, (2, 8, 8, 48)),
           "empty": lambda: x[:, :0],
           "unaligned": lambda: torch.cat([x.flatten()[:4], x.flatten()])[4:].view(x.shape)}
    with pytest.raises(ValueError, match=match):
        stats_mod._check(bad[case]())
    stats_mod._check(x)


def _cftm(nf=32, seed=0):
    torch.manual_seed(seed)
    blk = CFTM(nf)
    for p in blk.parameters():
        torch.nn.init.normal_(p, std=0.05)
    return blk


def _counted(monkeypatch):
    """Counts the fused CFTM's calls of the plain version and of
    ``in_stats_affine``, and keeps what the plain version returned."""
    calls = {"plain": [], "in_stats_affine": 0}

    def counted_plain(x):
        st = in_stats_affine_plain(x)
        if st.requires_grad:
            st.retain_grad()
        calls["plain"].append(st)
        return st

    def counted_affine(x):
        calls["in_stats_affine"] += 1
        return in_stats_affine(x)

    monkeypatch.setattr(port_model, "in_stats_affine_plain", counted_plain)
    monkeypatch.setattr(port_model, "in_stats_affine", counted_affine)
    return calls


def test_fused_cftm_takes_in_stats_under_autograd_and_the_kernel_without(monkeypatch):
    """With kernels, no gradient to x: one ``in_stats_affine`` call. Under
    autograd: the plain version (``in_stats`` laid out and halved), whose s
    and t receive gradients in every branch. Both give the same bits (the
    plain version runs on the CPU)."""
    calls = _counted(monkeypatch)
    blk = _cftm()
    pol = ComputePolicy(torch.bfloat16, True)
    x = _map(4, (1, 32, 32, 32))
    with torch.no_grad():
        y_nograd = port_model.cftm_apply(blk, x, policy=pol)
    with torch.inference_mode():
        y_inf = port_model.cftm_apply(blk, x, policy=pol)
    assert calls["in_stats_affine"] == 2 and calls["plain"] == []

    xg = x.clone().requires_grad_(True)
    y = port_model.cftm_apply(blk, xg, policy=pol)
    assert calls["in_stats_affine"] == 2 and len(calls["plain"]) == 1
    y.float().square().sum().backward()
    (st,) = calls["plain"]
    assert st.grad is not None
    for which in range(2):
        for k in range(4):
            assert bool(st.grad[which, k].abs().sum() > 0), (which, k)
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
    assert torch.equal(y.detach(), y_nograd) and torch.equal(y_inf, y_nograd)


def test_fused_cftm_without_kernels_keeps_in_stats(monkeypatch):
    """bf16 without kernels: the plain statistics, gradient or not."""
    calls = _counted(monkeypatch)
    blk = _cftm(seed=1)
    with torch.no_grad():
        port_model.cftm_apply(blk, _map(5, (1, 32, 32, 32)),
                              policy=ComputePolicy(torch.bfloat16, False))
    assert calls["in_stats_affine"] == 0 and len(calls["plain"]) == 1
