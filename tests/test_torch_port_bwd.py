"""The backward of the port's kernel modules against the JAX package, on
the CPU.

K1's gradients (m2trans_tpu_torch.ops.kernels.halo_attn: on CPU tensors
autograd through ``cftm_branch_plain``) against ``jax.grad`` of
``cftm_branch_fused(..., interpret=True)``, whose custom_vjp runs the
Pallas backward kernel in interpret mode; K2's (through ``tail_band_apply``,
plain on the CPU) against the JAX ``tail_band_apply(..., interpret=True)``
with its Pallas backward forced on, as tests/test_tail_band.py does. Same
numpy inputs, bf16 compute on both sides, and the tolerance of those
tests: ``max|a - b| <= max(2e-3, 2e-2 * max|b|)`` per gradient. The CUDA
kernels K1b and K2b are held against these plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m2trans_tpu.ops.pallas.tail_band as jax_tb
from m2trans_tpu.ops.pallas.halo_attn import cftm_branch_fused
from m2trans_tpu_torch.ops.kernels.halo_attn import (
    cftm_branch,
    cftm_branch_plain_vjp,
)
from m2trans_tpu_torch.ops.kernels.tail_band import (
    tail_band_apply,
    tail_band_operands,
    tail_band_plain,
    tail_band_plain_vjp,
)


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    tol = max(2e-3, 2e-2 * float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=tol,
                               err_msg=name)


def _branch_inputs(levels, hw, cb=4, bsz=2, seed=1):
    rng = np.random.default_rng(seed)
    c = cb * 4 ** levels
    return [rng.normal(0, 1, (bsz, hw, hw, cb)).astype(np.float32),
            rng.normal(0, 1, (bsz, hw, hw, cb)).astype(np.float32),
            rng.uniform(0.5, 1.5, (bsz, cb)).astype(np.float32),
            rng.normal(0, 0.2, (bsz, cb)).astype(np.float32),
            rng.normal(0, c ** -0.5, (c, 3 * c)).astype(np.float32),
            rng.normal(0, 1, (10, c // 2)).astype(np.float32),
            rng.normal(0, 1, (10, c // 2)).astype(np.float32)]


@pytest.mark.parametrize("levels,with_add,hw", [
    (0, False, 16), (0, True, 24), (1, False, 32), (1, True, 16),
    (2, False, 32), (2, True, 32)])
def test_k1_gradients_match_pallas_bwd(levels, with_add, hw):
    """loss = mean(out^2) of one bf16 branch; all seven gradients."""
    args = _branch_inputs(levels, hw)

    def jax_loss(x, a, s, t, w, rh, rw):
        y = cftm_branch_fused(
            x.astype(jnp.bfloat16), w.astype(jnp.bfloat16), rh, rw, s, t,
            x_add=a.astype(jnp.bfloat16) if with_add else None, r=0.5,
            levels=levels, interpret=True)
        return (y.astype(jnp.float32) ** 2).mean()

    want = jax.grad(jax_loss, argnums=tuple(range(7)))(*map(jnp.asarray, args))

    x, a, s, t, w, rh, rw = [torch.from_numpy(v).requires_grad_(True) for v in args]
    y = cftm_branch(x.bfloat16(), w.bfloat16(), rh, rw, s, t,
                    x_add=a.bfloat16() if with_add else None, r=0.5,
                    levels=levels)
    (y.float() ** 2).mean().backward()
    names = ("dx", "dx_add", "ds", "dt", "dw_qkv", "drel_h", "drel_w")
    for name, v, g in zip(names, (x, a, s, t, w, rh, rw), want):
        if name == "dx_add" and not with_add:
            assert v.grad is None
            continue
        _close(v.grad.numpy(), g, name)


def test_k1_plain_vjp_is_the_wrappers_gradient():
    """cftm_branch_plain_vjp (K1b's plain version) gives the gradients
    autograd gives through the wrapper, for a given cotangent."""
    x, a, s, t, w, rh, rw = [torch.from_numpy(v) for v in _branch_inputs(1, 16)]
    xb, ab, wb = x.bfloat16(), a.bfloat16(), w.bfloat16()
    g = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, xb.shape).astype(np.float32)).bfloat16()
    got = cftm_branch_plain_vjp(xb, wb, rh, rw, s, t, g, x_add=ab, levels=1)
    ins = [v.clone().requires_grad_(True) for v in (xb, ab, s, t, wb, rh, rw)]
    out = cftm_branch(ins[0], ins[4], ins[5], ins[6], ins[2], ins[3],
                      x_add=ins[1], levels=1)
    out.backward(g)
    for v, d in zip(ins, got):
        torch.testing.assert_close(d, v.grad, rtol=0, atol=0)


def _tail_params(scale, nf, seed):
    """(JAX HWIO params, the same as f32 OIHW torch tensors)."""
    rng = np.random.default_rng(seed)

    def conv(kh, cin, cout, bias=True):
        bound = (cin * kh * kh) ** -0.5
        p = {"w": rng.uniform(-bound, bound, (kh, kh, cin, cout)).astype(np.float32)}
        if bias:
            p["b"] = rng.uniform(-bound, bound, (cout,)).astype(np.float32)
        return p

    if scale == 4:
        jp = {"c0": conv(1, nf, 4 * nf), "c1": conv(1, nf, 4 * nf),
              "c2": conv(3, nf, 3, bias=False)}
    else:
        jp = {"c0": conv(1, nf, nf * scale * scale),
              "c1": conv(3, nf, 3, bias=False)}
    tp = {k: {n: torch.from_numpy(np.ascontiguousarray(
        v.transpose(3, 2, 0, 1) if n == "w" else v)).requires_grad_(True)
        for n, v in sp.items()} for k, sp in jp.items()}
    return jp, tp


@pytest.mark.parametrize("scale,hw", [(4, (8, 16)), (2, (8, 16)),
                                      (3, (8, 8))])
def test_k2_gradients_match_pallas_bwd(scale, hw, monkeypatch):
    """loss = sum(out^2) of the bf16 tail; every parameter and dx."""
    nf = 16
    jp, tp = _tail_params(scale, nf, seed=scale)
    x = np.random.default_rng(3).uniform(0, 1, (2, *hw, nf)).astype(np.float32)

    def jax_loss(pp, xx):
        out = jax_tb.tail_band_apply(pp, xx.astype(jnp.bfloat16), scale=scale,
                                     rgb_range=1.0, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    monkeypatch.setattr(jax_tb, "_tail_bwd_fits", lambda *a: True)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    gp, gx = jax.grad(jax_loss, argnums=(0, 1))(jparams, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = tail_band_apply(tp, xt.bfloat16(), scale=scale, rgb_range=1.0)
    (out.float() ** 2).sum().backward()
    _close(xt.grad.numpy(), gx, "dx")
    for k, sp in tp.items():
        for n, v in sp.items():
            want = np.asarray(gp[k][n], np.float32)
            if n == "w":
                want = want.transpose(3, 2, 0, 1)
            _close(v.grad.numpy(), want, f"{k}.{n}")


def test_k2_plain_vjp_is_the_plain_gradient():
    """tail_band_plain_vjp (K2b's plain version) returns the gradients of
    the ten operands, zeros for the stage-1 weights at x2."""
    _, tp = _tail_params(2, 16, seed=5)
    tp = {k: {n: v.detach() for n, v in sp.items()} for k, sp in tp.items()}
    y = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (2, 8, 16, 16)).astype(np.float32)).bfloat16()
    ops = tail_band_operands(tp, y, scale=2)
    g = torch.ones((2, 8, 16, 12), dtype=torch.bfloat16)
    grads = tail_band_plain_vjp(*ops, g, scale=2, rgb_range=1.0)
    assert [tuple(d.shape) for d in grads] == [tuple(v.shape) for v in ops]
    assert float(grads[3].abs().max()) == 0 and float(grads[4].abs().max()) == 0
    ins = [v.clone().requires_grad_(True) for v in ops]
    tail_band_plain(*ins, scale=2, rgb_range=1.0).backward(g)
    torch.testing.assert_close(grads[0], ins[0].grad, rtol=0, atol=0)
    torch.testing.assert_close(grads[6], ins[6].grad, rtol=0, atol=0)
