"""The designs of K1b and K2b's second pass for the H100, stated on tensors
(m2trans_tpu_torch.ops.kernels.halo_attn / tail_band), against the plain
VJPs and the JAX package on the CPU; and the port's repairs to the streaming
runner and the f32 tail.

K1b: ``window_branch_vjp`` (a window's attention VJP with dS formed in the
accumulator layout, dq / dk / dv a window, the gather through a neighbour
table, per-block partials and the tree reduction) equals
``cftm_branch_plain_vjp`` and ``jax.vjp`` of ``cftm_branch_fused(...,
interpret=True)``, whose custom_vjp runs the Pallas backward kernel. K2b:
``phase_conv_adjoint_taps`` equals the transposed structured conv, and
``tail_band_vjp_by_roles`` equals ``tail_band_plain_vjp`` and the JAX
``tail_band_apply`` VJP with its Pallas backward forced on. Same numpy
inputs, bf16 compute, and the tolerance of tests/test_cftm_fused.py:80 and
tests/test_tail_band.py: ``max|a - b| <= max(2e-3, 2e-2 * max|b|)`` per
gradient. The CUDA kernels are held against the plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import m2trans_tpu.ops.pallas.tail_band as jax_tb
from m2trans_tpu.ops.pallas.halo_attn import cftm_branch_fused
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models import m2trans as port_model
from m2trans_tpu_torch.models.m2trans import ComputePolicy, init_m2trans
from m2trans_tpu_torch.ops.kernels import halo_attn as ha
from m2trans_tpu_torch.ops.kernels import tail_band as tb
from m2trans_tpu_torch.ops.tail_phase import expand_phase_kernel
from m2trans_tpu_torch.parallel.streaming import StreamingSR


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    tol = max(2e-3, 2e-2 * float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=tol,
                               rtol=0, err_msg=name)


def _t(rng, *shape, sd=1.0):
    return torch.from_numpy(rng.normal(0, sd, shape).astype(np.float32))


def _branch_case(levels, hw, cb=16, bsz=2, seed=1):
    """x, x_add, gout (bf16), w (bf16), rel_h, rel_w, s, t of one branch."""
    rng = np.random.default_rng(seed)
    c = cb * 4 ** levels
    x, add, g = (_t(rng, bsz, *hw, cb).bfloat16() for _ in range(3))
    w = _t(rng, c, 3 * c, sd=c ** -0.5).bfloat16()
    rel_h, rel_w = _t(rng, 10, c // 2), _t(rng, 10, c // 2)
    s = torch.from_numpy(rng.uniform(0.5, 1.5, (bsz, cb)).astype(np.float32))
    return x, add, g, w, rel_h, rel_w, s, _t(rng, bsz, cb, sd=0.2)


NAMES = ("dx", "dx_add", "ds", "dt", "dw_qkv", "drel_h", "drel_w")


# a ragged window grid: 2 x 3 blocks, the windows at the border clipped
@pytest.mark.parametrize("levels,hw", [(0, (16, 24)), (1, (32, 48)), (2, (64, 96))])
@pytest.mark.parametrize("with_add", [False, True])
def test_k1b_window_vjp_matches_plain_vjp(levels, hw, with_add):
    x, add, g, w, rel_h, rel_w, s, t = _branch_case(levels, hw, bsz=1 + (levels < 2))
    add = add if with_add else None
    got = ha.window_branch_vjp(x, w, rel_h, rel_w, s, t, g, x_add=add, levels=levels)
    want = ha.cftm_branch_plain_vjp(x, w, rel_h, rel_w, s, t, g, x_add=add,
                                    levels=levels)
    for name, a, b in zip(NAMES, got, want):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        _close(a.float().numpy(), b.float().numpy(), name)


@pytest.mark.parametrize("levels,hw", [(0, (16, 16)), (1, (16, 32)), (2, (32, 32))])
def test_k1b_window_vjp_matches_pallas_bwd(levels, hw):
    """All seven gradients for one cotangent, against the Pallas VJP run in
    interpret mode as tests/test_torch_port_bwd.py runs it."""
    x, add, g, w, rel_h, rel_w, s, t = _branch_case(levels, hw, seed=3)

    def jax_out(xx, aa, ss, tt, ww, rh, rw):
        return cftm_branch_fused(
            xx.astype(jnp.bfloat16), ww.astype(jnp.bfloat16), rh, rw, ss, tt,
            x_add=aa.astype(jnp.bfloat16), r=0.5, levels=levels,
            interpret=True).astype(jnp.float32)

    ins = [jnp.asarray(v.float().numpy()) for v in (x, add, s, t, w, rel_h, rel_w)]
    _, vjp = jax.vjp(jax_out, *ins)
    want = vjp(jnp.asarray(g.float().numpy()))
    got = ha.window_branch_vjp(x, w, rel_h, rel_w, s, t, g, x_add=add, levels=levels)
    for name, a, b in zip(NAMES, got, want):
        _close(a.float().numpy(), b, name)


@pytest.mark.parametrize("c", [16, 64])
def test_dS_in_the_accumulator_layout_is_the_softmax_vjp(c):
    """P and dS rebuilt from the register layout equal the softmax and its
    VJP over the 100 real keys; what the pad slots hold contributes nothing."""
    rng = np.random.default_rng(c)
    q, d_o = _t(rng, 64, c, sd=0.3).bfloat16(), _t(rng, 64, c).bfloat16()
    k, v = _t(rng, 112, c).bfloat16(), _t(rng, 112, c).bfloat16()
    p, ds = ha.register_softmax_vjp(q, k, v, d_o)
    logits = (q.float() @ k.float().T)[:, :100].requires_grad_(True)
    pw = torch.softmax(logits, dim=-1)
    dp = d_o.float() @ v.float().T[:, :100]
    (dsw,) = torch.autograd.grad(pw, logits, dp)
    assert p.dtype == ds.dtype == torch.bfloat16 and p.shape == ds.shape == (64, 112)
    assert float(p[:, 100:].abs().max()) == 0 and float(ds[:, 100:].abs().max()) == 0
    np.testing.assert_allclose(p[:, :100].float(), pw.detach(), atol=4e-3, rtol=0)
    _close(ds[:, :100].float().numpy(), dsw.numpy(), "dS")
    k2, v2 = k.clone(), v.clone()
    k2[100:], v2[100:] = 7.0, -3.0  # other pad contents, the same result
    p2, ds2 = ha.register_softmax_vjp(q, k2, v2, d_o)
    assert torch.equal(p, p2) and torch.equal(ds, ds2)


def test_cluster_attention_vjp_is_the_window_vjp():
    """The C = 256 split over four CTAs' channel slices (partial logits and
    partial dP summed in rank order) gives the window's dq, dk, dv."""
    rng = np.random.default_rng(5)
    q, d_o = _t(rng, 64, 256, sd=0.1).bfloat16(), _t(rng, 64, 256).bfloat16()
    k, v = _t(rng, 112, 256, sd=0.5).bfloat16(), _t(rng, 112, 256).bfloat16()
    k[100:], v[100:] = 0, 0
    dq, dk, dv = ha.cluster_attention_vjp(q, k, v, d_o)
    p, ds = ha.register_softmax_vjp(q, k, v, d_o)
    _close(dq.numpy(), (ds.float() @ k.float()).numpy(), "dq")
    _close(dk.numpy(), (ds.float().T @ q.float()).numpy(), "dk")
    _close(dv.numpy(), (p.float().T @ d_o.float()).numpy(), "dv")


@pytest.mark.parametrize("n", [1, 7, 18, 288])
def test_tree_reduction_order(n):
    """The partials summed in the tree order equal the serial sum to f32
    rounding, and two calls give the same bits."""
    part = _t(np.random.default_rng(n), n, 5, 33)
    got = ha.tree_reduce_rows(part)
    assert got.dtype == torch.float32 and got.shape == (5, 33)
    serial = torch.zeros(5, 33)
    for row in part:
        serial = serial + row
    exact = part.double().sum(dim=0)
    bound = 2.0 ** -23 * n * float(part.abs().sum(dim=0).max())
    assert float((got.double() - exact).abs().max()) <= bound
    assert float((got - serial).abs().max()) <= bound
    assert torch.equal(got, ha.tree_reduce_rows(part.clone()))


@pytest.mark.parametrize("nbh,nbw", [(1, 1), (2, 3), (3, 2)])
def test_gather_neighbour_sets_cover_every_key_once(nbh, nbw):
    """Every (window, key slot) whose pixel is in the frame is gathered by
    exactly one pixel, its own; slots off the frame by none."""
    seen = {}
    for (bi, bj), pixels in ha.key_neighbours(nbh, nbw).items():
        for p, found in enumerate(pixels):
            assert 1 <= len(found) <= 4 and (bi, bj, p) in found  # own window: slot p
            for wi, wj, slot in found:
                wr, wc = (int(v) for v in ha.window_slots()[slot])
                assert (8 * wi - 1 + wr, 8 * wj - 1 + wc) == (8 * bi + p // 8, 8 * bj + p % 8)
                assert (wi, wj, slot) not in seen
                seen[(wi, wj, slot)] = (bi, bj, p)
    in_frame = sum(1 for wi in range(nbh) for wj in range(nbw)
                   for wr, wc in ha.window_slots().tolist()
                   if 0 <= 8 * wi - 1 + wr < 8 * nbh and 0 <= 8 * wj - 1 + wc < 8 * nbw)
    assert len(seen) == in_frame


def _tail_case(scale, bsz, h, w, nf=16, seed=0):
    rng = np.random.default_rng(seed)

    def u(shape, fan_in):
        return torch.from_numpy(
            rng.uniform(-1, 1, shape).astype(np.float32)) * fan_in ** -0.5

    if scale == 4:
        p = {"c0": {"w": u((4 * nf, nf, 1, 1), nf), "b": u((4 * nf,), nf)},
             "c1": {"w": u((4 * nf, nf, 1, 1), nf), "b": u((4 * nf,), nf)},
             "c2": {"w": u((3, nf, 3, 3), 9 * nf)}}
    else:
        p = {"c0": {"w": u((nf * scale ** 2, nf, 1, 1), nf),
                    "b": u((nf * scale ** 2,), nf)},
             "c1": {"w": u((3, nf, 3, 3), 9 * nf)}}
    y = _t(rng, bsz, h, w, nf).bfloat16()
    g = _t(rng, bsz, h, w, scale * scale * 3).bfloat16()
    return tb.tail_band_operands(p, y, scale=scale), g


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_phase_tap_adjoint_table_is_the_transpose(scale):
    """Every (block, tap) is read by exactly one (phase, offset)."""
    fwd = tb.phase_tap_table(scale)
    adj = tb.phase_tap_adjoint_table(scale)
    assert len(adj) == scale * scale
    pairs = {(blk, tap, q, yo, xo) for blk, terms in enumerate(adj)
             for tap, q, yo, xo in terms}
    assert pairs == {(blk, tap, q, yo, xo) for q, terms in enumerate(fwd)
                     for tap, blk, yo, xo in terms}
    assert all(len(terms) == 9 and [t[0] for t in terms] == list(range(9))
               for terms in adj)


# whole tiles of K2's 8x16 walk, and frames that are no multiple of it
@pytest.mark.parametrize("scale,shape", [(2, (2, 8, 16)), (2, (1, 7, 5)),
                                         (3, (1, 8, 16)), (3, (2, 9, 6)),
                                         (4, (1, 8, 16)), (4, (1, 5, 19))])
def test_k2b_tap_list_adjoint_is_the_transposed_conv(scale, shape):
    ops, g = _tail_case(scale, *shape, seed=scale)
    band = tb._phase_band(*ops[:5], *ops[6:], scale).float().requires_grad_(True)
    w3 = ops[5].float().requires_grad_(True)
    K = expand_phase_kernel(w3, scale)
    out = F.conv2d(band.permute(0, 3, 1, 2), K.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    want_band, want_w3 = torch.autograd.grad(out, (band, w3), g.float())
    dph, dw3 = tb.phase_conv_adjoint_taps(band.detach(), g.float(), w3.detach(), scale)
    torch.testing.assert_close(dph, want_band, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dw3, want_w3, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("scale,shape", [(2, (1, 7, 5)), (3, (2, 9, 6)),
                                         (4, (2, 8, 16)), (4, (1, 5, 19))])
def test_k2b_roles_vjp_matches_plain_vjp(scale, shape):
    ops, g = _tail_case(scale, *shape, seed=10 + scale)
    got = tb.tail_band_vjp_by_roles(*ops, g, scale=scale, rgb_range=1.0)
    want = tb.tail_band_plain_vjp(*ops, g, scale=scale, rgb_range=1.0)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        _close(a.float().numpy(), b.float().numpy(), f"gradient {i}")


class _RolesTail(torch.autograd.Function):
    """The plain forward with the by-roles statement of K2b as its VJP."""

    @staticmethod
    def forward(ctx, scale, *ops):
        ctx.save_for_backward(*ops)
        ctx.scale = scale
        return tb.tail_band_plain(*ops, scale=scale, rgb_range=1.0)

    @staticmethod
    def backward(ctx, g):
        return (None, *tb.tail_band_vjp_by_roles(*ctx.saved_tensors, g,
                                                 scale=ctx.scale, rgb_range=1.0))


@pytest.mark.parametrize("scale,hw", [(4, (8, 16)), (2, (8, 16)), (3, (8, 8))])
def test_k2b_roles_vjp_matches_pallas_bwd(scale, hw, monkeypatch):
    """loss = sum(out^2) of the bf16 tail; every parameter and dx against the
    JAX tail_band_apply with its Pallas backward in interpret mode."""
    nf = 16
    rng = np.random.default_rng(scale)

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
        jp = {"c0": conv(1, nf, nf * scale * scale), "c1": conv(3, nf, 3, bias=False)}
    tp = {k: {n: torch.from_numpy(np.ascontiguousarray(
        v.transpose(3, 2, 0, 1) if n == "w" else v)).requires_grad_(True)
        for n, v in sp.items()} for k, sp in jp.items()}
    x = np.random.default_rng(3).uniform(0, 1, (2, *hw, nf)).astype(np.float32)

    def jax_loss(pp, xx):
        out = jax_tb.tail_band_apply(pp, xx.astype(jnp.bfloat16), scale=scale,
                                     rgb_range=1.0, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    monkeypatch.setattr(jax_tb, "_tail_bwd_fits", lambda *a: True)
    gp, gx = jax.grad(jax_loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    ops = tb.tail_band_operands(tp, xt.bfloat16(), scale=scale)
    out = _RolesTail.apply(scale, *ops)
    (out.float() ** 2).sum().backward()
    _close(xt.grad.numpy(), gx, "dx")
    for k, sp in tp.items():
        for n, v in sp.items():
            want = np.asarray(gp[k][n], np.float32)
            _close(v.grad.numpy(), want.transpose(3, 2, 0, 1) if n == "w" else want,
                   f"{k}.{n}")


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_streaming_depths_yield_the_same_frames_in_order(depth):
    """On a CPU model nothing is pinned and no event is used; the stream's
    frames equal the synchronous call's, in order, at every depth."""
    cfg = Config(scale=2, n_feats=8, n_blocks=1)
    model = init_m2trans(cfg, seed=2)
    run = StreamingSR(model, cfg, policy=ComputePolicy(), depth=depth)
    frames = [np.random.default_rng(i).uniform(0, 1, (1, 16, 8 + 8 * (i % 2), 3))
              .astype(np.float32) for i in range(5)]
    outs = list(run.stream(iter(frames), collect_stats=True))
    assert len(outs) == 5 and len(run.latencies_s) == 5
    assert run._slots == {}  # no pinned buffers for a CPU model
    for f, o in zip(frames, outs):
        assert o.shape == (1, 32, 2 * f.shape[2], 3)
        np.testing.assert_array_equal(o, run(f))


def test_conv_ps_gelu_builds_its_permutation_once(monkeypatch):
    """The f32 tail's permutation is built once per (channels, r, device)."""
    calls = []
    real = port_model.ps_weight_perm

    def counted(c_out, r):
        calls.append((c_out, r))
        return real(c_out, r)

    monkeypatch.setattr(port_model, "ps_weight_perm", counted)
    port_model._PS_PERM.clear()
    rng = np.random.default_rng(0)
    x = _t(rng, 1, 4, 4, 8)
    w, b = _t(rng, 32, 8, 1, 1), _t(rng, 32)
    w9, b9 = _t(rng, 72, 8, 1, 1), _t(rng, 72)
    first = port_model._conv_ps_gelu(x, w, b, 2)
    for _ in range(3):
        assert torch.equal(port_model._conv_ps_gelu(x, w, b, 2), first)
    port_model._conv_ps_gelu(x, w9, b9, 3)
    port_model._conv_ps_gelu(x, w9, b9, 3)
    assert calls == [(8, 2), (8, 3)]
    assert first.shape == (1, 8, 8, 8)


def test_conv_ps_gelu_cache_built_while_serving_serves_training():
    """A permutation first built under inference mode still indexes a weight
    that autograd tracks afterwards."""
    port_model._PS_PERM.clear()
    rng = np.random.default_rng(1)
    x, w, b = _t(rng, 1, 4, 4, 8), _t(rng, 32, 8, 1, 1), _t(rng, 32)
    with torch.inference_mode():
        served = port_model._conv_ps_gelu(x, w, b, 2)
    w.requires_grad_(True)
    out = port_model._conv_ps_gelu(x, w, b, 2)
    out.sum().backward()
    assert torch.equal(out.detach(), served) and w.grad is not None
    assert len(port_model._PS_PERM) == 1
