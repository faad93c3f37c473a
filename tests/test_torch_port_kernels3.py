"""K3, K1n and K4 (their plain versions, which the wrappers run on CPU
tensors) against the JAX Pallas kernels in interpret mode, and the model
functions that reach them, on the CPU.

K3 ``ff_conv`` vs ``ff_pair_conv_fused`` and ``packed_ff_conv`` through the
JAX ``pack_body`` / ``unpack_body`` (bf16, the tolerances of
tests/test_ff_packed.py); K1n ``halo_attention_qkv`` vs
``halo_attention_qkv_fused`` at L = 0, 1, 2 (f32: atol 3e-5 and gradients
atol 1e-4 as tests/test_pallas_halo_attn.py; bf16: K1's 5e-2 / mean 5e-3);
K4's relayouts vs ``pack_batch_dma`` ... ``unpack_batch_dma``, exactly; the
repaired ``tblock_apply`` (reflect pad and crop) and ``make_branch_fn``
against the JAX functions; the port's own weight converter against the JAX
package's, both ways. The CUDA kernels themselves run only on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2trans_tpu.models import init_m2trans as jax_init
from m2trans_tpu.models.m2trans import ComputePolicy as JaxPolicy
from m2trans_tpu.models.m2trans import make_branch_fn as jax_make_branch_fn
from m2trans_tpu.models.m2trans import tblock_apply as jax_tblock_apply
from m2trans_tpu.ops.pallas import halo_attn_packed as jpk
from m2trans_tpu.ops.pallas.ff_packed import packed_ff_conv
from m2trans_tpu.ops.pallas.ff_pair import ff_pair_conv_fused
from m2trans_tpu.ops.pallas.halo_attn import halo_attention_qkv_fused
from m2trans_tpu.train import convert as jax_convert
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models import m2trans as port_model
from m2trans_tpu_torch.models.m2trans import ComputePolicy, init_m2trans
from m2trans_tpu_torch.ops.conv import conv2d
from m2trans_tpu_torch.ops.kernels import ff_conv as ffk
from m2trans_tpu_torch.ops.kernels import relayout
from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv, ff_conv_plain, ff_weight_hwio
from m2trans_tpu_torch.ops.kernels.halo_attn import (
    halo_attention_qkv,
    halo_attention_qkv_plain,
)
from m2trans_tpu_torch.train import convert as port_convert
from m2trans_tpu_torch.train.jax_params import module_from_params

BF = torch.bfloat16
F32_POLICY = JaxPolicy()
BF16_PALLAS = JaxPolicy(dtype=jnp.bfloat16, precision=None, use_pallas=True)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def _ff_inputs(g=8, h=16, w=24, c=64, seed=0):
    rng = np.random.default_rng(seed)
    return dict(oc=rng.normal(0, 0.5, (g, h, w, c)).astype(np.float32),
                x=rng.normal(0, 0.5, (g, h, w, c)).astype(np.float32),
                w=rng.normal(0, 0.1, (3, 3, c, c)).astype(np.float32),
                b=rng.normal(0, 0.1, (c,)).astype(np.float32))


@pytest.mark.parametrize("kernel,atol,mean", [("pair", 1e-2, 1e-3),
                                              ("packed", 3e-2, 3e-3)])
def test_k3_plain_matches_pallas_ff_kernels(kernel, atol, mean):
    """ff_pair rounds where K3 rounds (conv to bf16, + b, + x), so the two
    differ in the f32 tap order; ff_packed adds the bias and the residual in
    f32 and rounds once, hence its wider bound (both from
    tests/test_ff_packed.py)."""
    d = _ff_inputs()
    g = d["oc"].shape[0]
    bf = jnp.bfloat16
    ocp = jpk.pack_body(_j(d["oc"], bf), g, interpret=True)
    xp = jpk.pack_body(_j(d["x"], bf), g, interpret=True)
    if kernel == "pair":
        out = ff_pair_conv_fused(ocp, xp, _j(d["w"], bf), _j(d["b"]), g=g,
                                 interpret=True)
    else:
        out = packed_ff_conv(ocp, xp, _j(d["w"], bf), _j(d["b"]), g=g, nb=4,
                             interpret=True)
    want = np.asarray(jpk.unpack_body(out, g, interpret=True), np.float32)
    got = ff_conv(_t(d["oc"], BF), _t(d["x"], BF), _t(d["w"], BF),
                  _t(d["b"], BF)).float().numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol)
    assert float(np.abs(got - want).mean()) < mean


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k3_plain_is_the_conv_bias_residual_composition(dtype):
    """Bit for bit the composition the bf16 CFTM ran before K3: conv2d with
    the module's OIHW weight and bias, then + x."""
    d = _ff_inputs(g=2, h=9, w=7, c=16, seed=1)
    w_oihw = _t(d["w"]).permute(3, 2, 0, 1).contiguous()
    oc, x, b = _t(d["oc"], dtype), _t(d["x"], dtype), _t(d["b"], dtype)
    want = conv2d(oc, w_oihw, _t(d["b"]), padding="zeros", dtype=dtype) + x
    w = ff_weight_hwio(w_oihw, dtype)
    assert w.shape == (3, 3, 16, 16) and w.is_contiguous()
    torch.testing.assert_close(ff_conv_plain(oc, x, w, b), want, rtol=0, atol=0)


def test_k3_gradients_are_the_plain_vjp():
    """On the CPU ff_conv is differentiated by autograd through the plain
    version; the gradients equal the f32 composition's within bf16
    rounding."""
    d = _ff_inputs(g=1, h=8, w=8, c=16, seed=2)
    ins = [_t(d[k], BF).requires_grad_(True) for k in ("oc", "x", "w", "b")]
    gout = _t(np.random.default_rng(3).normal(size=d["oc"].shape), BF)
    got = torch.autograd.grad(ff_conv(*ins), ins, gout)
    ref = [v.detach().float().requires_grad_(True) for v in ins]
    want = torch.autograd.grad(ff_conv_plain(*ref), ref, gout.float())
    for a, b in zip(got, want):
        assert a.dtype == BF and a.shape == b.shape
        tol = max(2e-3, 2e-2 * float(b.abs().max()))
        assert float((a.float() - b).abs().max()) <= tol


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "channels", "weight",
                                 "bias", "residual"])
def test_k3_check_raises(bad):
    d = _ff_inputs(g=1, h=8, w=8, c=16)
    oc, x, w, b = (_t(d[k], BF) for k in ("oc", "x", "w", "b"))
    ffk._check(oc, x, w, b)
    if bad == "dtype":
        oc = oc.float()
    elif bad == "contiguous":
        oc = oc.transpose(1, 2)
        x = x.transpose(1, 2)
    elif bad == "channels":
        oc, x = oc[..., :8].contiguous(), x[..., :8].contiguous()
        w, b = w[:, :, :8, :8].contiguous(), b[:8].contiguous()
    elif bad == "weight":
        w = w.permute(3, 2, 0, 1).contiguous()
    elif bad == "bias":
        b = b[:8]
    else:
        x = x[:, :4]
    with pytest.raises(ValueError, match="ff_conv kernel"):
        ffk._check(oc, x, w, b)


def test_cftm_ff_operands_are_cached_only_without_grad():
    """The (3, 3, C_in, C_out) weight is kept on the block between calls
    only where no gradient is wanted, and rewritten in place (its storage
    kept, which a CUDA graph reading it needs) when the weight changes."""
    blk = init_m2trans(Config(scale=2, n_feats=16, n_blocks=1), seed=0).body[0]
    with torch.no_grad():
        w, b = port_model._ff_wb(blk, BF)
        assert port_model._ff_wb(blk, BF)[0] is w
        before = w.clone()
        blk.feed_forward[0].weight.mul_(2.0)
        w2, _ = port_model._ff_wb(blk, BF)
        assert w2 is w and not torch.equal(w2, before)
        torch.testing.assert_close(
            w2, ff_weight_hwio(blk.feed_forward[0].weight), rtol=0, atol=0)
    w3, b3 = port_model._ff_wb(blk, BF)
    assert w3.requires_grad and b3.requires_grad
    assert b.dtype == BF and w.shape == (3, 3, 16, 16)


# ---------------------------------------------------------------------------
# K1n
# ---------------------------------------------------------------------------


def _qkv_inputs(levels, cb=4, bsz=2, hw=32, seed=0):
    rng = np.random.default_rng(seed)
    c = cb * 4 ** levels
    return dict(x=rng.normal(0, 1, (bsz, hw, hw, cb)).astype(np.float32),
                w=rng.normal(0, c ** -0.5, (c, 3 * c)).astype(np.float32),
                rel_h=rng.normal(0, 1, (10, c // 2)).astype(np.float32),
                rel_w=rng.normal(0, 1, (10, c // 2)).astype(np.float32))


@pytest.mark.parametrize("levels", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1n_plain_matches_pallas(levels, dtype):
    d = _qkv_inputs(levels, seed=levels)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, BF)
    want = np.asarray(halo_attention_qkv_fused(
        _j(d["x"], jd), _j(d["w"], jd), _j(d["rel_h"]), _j(d["rel_w"]),
        levels=levels, interpret=True,
        precision=jax.lax.Precision.HIGHEST if dtype == "float32" else None
    )).astype(np.float32)
    got = halo_attention_qkv(_t(d["x"], td), _t(d["w"], td), _t(d["rel_h"]),
                             _t(d["rel_w"]), levels=levels)
    assert got.dtype == td
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=3e-5)
    else:
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
        assert float(np.abs(got - want).mean()) < 5e-3


@pytest.mark.parametrize("levels", [0, 1, 2])
def test_k1n_gradients_match_jax_custom_vjp(levels):
    d = _qkv_inputs(levels, cb=4, bsz=1, hw=16 if levels < 2 else 32, seed=5)
    keys = ("x", "w", "rel_h", "rel_w")

    def loss(x, w, rh, rw):
        return jnp.sum(halo_attention_qkv_fused(
            x, w, rh, rw, levels=levels, interpret=True,
            precision=jax.lax.Precision.HIGHEST) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(_j(d[k]) for k in keys))
    ins = [_t(d[k]).requires_grad_(True) for k in keys]
    got = torch.autograd.grad((halo_attention_qkv(*ins, levels=levels) ** 2).sum(),
                              ins)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


def test_k1n_has_no_affine_and_no_residual():
    """K1n is K1's branch B alone: K1 with the identity affine, minus z."""
    from m2trans_tpu_torch.ops.kernels.halo_attn import cftm_branch_plain

    d = _qkv_inputs(1, seed=7)
    x, w, rh, rw = (_t(d[k]) for k in ("x", "w", "rel_h", "rel_w"))
    one, zero = torch.ones(2, 4), torch.zeros(2, 4)
    full = cftm_branch_plain(x, w, rh, rw, one, zero, levels=1)
    torch.testing.assert_close(halo_attention_qkv_plain(x, w, rh, rw, levels=1),
                               full - x, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# tblock_apply (pad and crop), make_branch_fn
# ---------------------------------------------------------------------------


def _block(n_feats=16, seed=0):
    cfg = Config(scale=2, n_feats=n_feats, n_blocks=1)
    params = jax_init(jax.random.PRNGKey(seed), cfg)
    return params["body"][0], module_from_params(params, cfg).body[0]


@pytest.mark.parametrize("hw", [(20, 12), (16, 24), (7, 9)])
def test_tblock_apply_pads_and_crops_like_jax(hw):
    """Frames that are not a multiple of the block are reflect-padded and
    the result cropped, as the JAX tblock_apply does."""
    jblk, blk = _block()
    x = np.random.default_rng(hw[0]).normal(0, 1, (2, *hw, 4)).astype(np.float32)
    want = np.asarray(jax_tblock_apply(jblk["attn1"], _j(x), policy=F32_POLICY))
    with torch.no_grad():
        got = port_model.tblock_apply(blk.attn1, _t(x)).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_tblock_apply_bf16_kernels_matches_jax():
    """bf16 with kernels: one K1n call (its plain version here) on the
    padded frame, vs the JAX Pallas kernel in interpret mode."""
    jblk, blk = _block(seed=1)
    x = np.random.default_rng(2).normal(0, 1, (2, 20, 12, 4)).astype(np.float32)
    want = np.asarray(jax_tblock_apply(jblk["attn1"], _j(x), policy=BF16_PALLAS)
                      ).astype(np.float32)
    with torch.no_grad():
        got = port_model.tblock_apply(blk.attn1, _t(x),
                                      policy=ComputePolicy(BF, True))
    assert got.dtype == BF and got.shape == (2, 20, 12, 4)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    assert float(np.abs(got - want).mean()) < 5e-3


@pytest.mark.parametrize("mode", ["f32", "bf16-kernels", "bf16-plain"])
def test_make_branch_fn_matches_jax(mode):
    jblk, blk = _block(seed=3)
    jpol, pol = {"f32": (F32_POLICY, ComputePolicy()),
                 "bf16-kernels": (BF16_PALLAS, ComputePolicy(BF, True)),
                 "bf16-plain": (JaxPolicy(dtype=jnp.bfloat16, precision=None),
                                ComputePolicy(BF, False))}[mode]
    jbranch = jax_make_branch_fn(jblk, jpol)
    branch = port_model.make_branch_fn(blk, pol)
    z = np.random.default_rng(4).normal(0, 1, (2, 32, 32, 4)).astype(np.float32)
    for name, levels in port_model.BRANCHES:
        want = np.asarray(jbranch(name, _j(z, jpol.dtype), levels)).astype(np.float32)
        with torch.no_grad():
            got = branch(name, _t(z, pol.dtype), levels)
        assert got.dtype == pol.dtype
        got = got.float().numpy()
        if mode == "f32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
            assert float(np.abs(got - want).mean()) < 5e-3


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

RELAYOUTS = {
    "pack_batch": (relayout.pack_batch, relayout.pack_batch_plain,
                   lambda x, g: jpk.pack_batch_dma(x, g, interpret=True)),
    "unpack_batch": (relayout.unpack_batch, relayout.unpack_batch_plain,
                     lambda x, g: jpk.unpack_batch_dma(x, g, interpret=True)),
    "pack_body": (relayout.pack_body, relayout.pack_body_plain,
                  lambda x, g: jpk.pack_body_dma(x, g, interpret=True)),
    "unpack_body": (relayout.unpack_body, relayout.unpack_body_plain,
                    lambda x, g: jpk.unpack_body_dma(x, g, interpret=True)),
}


@pytest.mark.parametrize("name", sorted(RELAYOUTS))
@pytest.mark.parametrize("g", [2, 8])
def test_k4_plain_matches_pallas_exactly(name, g):
    fn, plain, jfn = RELAYOUTS[name]
    rng = np.random.default_rng(g)
    shape = (8, 8, 16, 32) if name.startswith("pack") else (8 // g, 8, 16, 32 * g)
    x = rng.normal(0, 1, shape).astype(np.float32)
    want = np.asarray(jfn(_j(x, jnp.bfloat16), g)).astype(np.float32)
    for f in (fn, plain):
        got = f(_t(x, BF), g)
        assert got.dtype == BF and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_k4_round_trips_and_index_maps():
    x = _t(np.random.default_rng(0).normal(size=(4, 3, 5, 32)), BF)
    g, nb, cb = 2, 4, 8
    p = relayout.pack_body(x, g)
    assert p.shape == (2, 3, 5, 64)
    assert p[1, 2, 3, 3 * g * cb + 1 * cb + 5] == x[1 * g + 1, 2, 3, 3 * cb + 5]
    assert torch.equal(relayout.unpack_body(p, g), x)
    q = relayout.pack_batch(x, 4)
    assert q[0, 1, 2, 3 * 32 + 7] == x[3, 1, 2, 7]
    assert torch.equal(relayout.unpack_batch(q, 4), x)
    assert relayout.pack_batch(x, 1) is x and relayout.unpack_batch(x, 1) is x


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "batch", "cb", "lanes"])
def test_k4_check_raises(bad):
    x = torch.zeros(4, 3, 5, 32, dtype=BF)
    relayout._check(x, 2, 4, True)
    args = {"dtype": (x.float(), 2, 4, True),
            "contiguous": (x.transpose(1, 2), 2, 4, True),
            "batch": (x, 3, 4, True),
            "cb": (x, 2, 8, True),
            "lanes": (x, 3, 1, False)}[bad]
    with pytest.raises(ValueError, match="relayout kernel"):
        relayout._check(*args)


# ---------------------------------------------------------------------------
# the port's own weight converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_converter_copy_equals_the_jax_package_s(scale):
    """The port keeps its own numpy copy of the JAX package's converter:
    equal state dicts and params both ways on a seeded model."""
    cfg = Config(scale=scale, n_feats=8, n_blocks=2)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_init(jax.random.PRNGKey(scale), cfg))
    for prefix in (True, False):
        want = jax_convert.params_to_torch_state_dict(params, cfg, module_prefix=prefix)
        got = port_convert.params_to_torch_state_dict(params, cfg, module_prefix=prefix)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    sd = {k: torch.from_numpy(v.copy()) for k, v in want.items()}
    for load_tail in (True, False):
        a = jax_convert.torch_state_dict_to_params(sd, cfg, load_tail=load_tail)
        b = port_convert.torch_state_dict_to_params(sd, cfg, load_tail=load_tail)
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for u, v in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(u, v)
    back = port_convert.torch_state_dict_to_params(sd, cfg)
    for u, v in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(u, v)
    with pytest.raises(KeyError):
        port_convert.torch_state_dict_to_params(sd, cfg.replace(n_blocks=3))
