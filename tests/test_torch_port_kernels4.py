"""The arithmetic of the Hopper designs of K3 and of K1's C = 256 body, on
the CPU.

The CUDA kernels run only on the card (tests/test_torch_port_cuda.py,
chip_smoke.py). What can be held here is the way they cut the work: K1's
cluster body gives each of the four CTAs of a window a slice of the q|k|v
weight and of the rel-pos tables, sums the CTAs' partial logits, and hands
``P v`` over by base channel for the inverse wavelet transform; K3 walks
8x16-pixel tiles whose 10x18 windows are zero beyond the frame and sums nine
shifted products. Each cut is a plain function on tensors
(``ops/kernels/halo_attn.py``) or written out below, and is held against
the plain versions, which in turn are held against the JAX Pallas kernels
in interpret mode (here for the cluster arithmetic, and in
tests/test_torch_port_kernels.py / _kernels3.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2trans_tpu.ops.pallas.halo_attn import halo_attention_qkv_fused
from m2trans_tpu_torch.ops.halo_attention import (
    add_rel_pos_to_k,
    blockify,
    extract_halo_windows,
    unblockify,
)
from m2trans_tpu_torch.ops.kernels import halo_attn as hk
from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv_plain
from m2trans_tpu_torch.ops.wavelet import haar_dwt, haar_iwt

BF = torch.bfloat16


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# K1, the cluster split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,split", [(256, 4), (256, 2), (64, 4), (16, 1)])
def test_cluster_columns_partition_the_channels(c, split):
    cols = hk.cluster_columns(c, split)
    assert cols.shape == (split, c // split)
    assert torch.equal(cols.reshape(-1).sort().values, torch.arange(c))
    # a CTA's columns are contiguous: its weight rows copy as 16-byte vectors
    assert torch.equal(cols[:, 1:] - cols[:, :-1],
                       torch.ones(split, c // split - 1, dtype=torch.int64))


@pytest.mark.parametrize("cb,levels,split", [(16, 2, 4), (16, 1, 4), (8, 2, 2),
                                             (4, 0, 4)])
def test_cluster_output_columns_own_every_subband_of_their_base_channels(
        cb, levels, split):
    cols = hk.cluster_output_columns(cb, levels, split)
    c, g, cbl = cb * 4 ** levels, 4 ** levels, cb // split
    assert cols.shape == (split, c // split)
    assert torch.equal(cols.reshape(-1).sort().values, torch.arange(c))
    for r in range(split):
        base = cols[r] % cb     # channel index is g*cb + base channel
        band = cols[r] // cb
        assert base.min() == r * cbl and base.max() == (r + 1) * cbl - 1
        assert torch.equal(band.reshape(g, cbl)[:, 0], torch.arange(g))


def test_cluster_columns_raise_on_a_ragged_split():
    with pytest.raises(ValueError, match="multiple"):
        hk.cluster_columns(250, 4)
    with pytest.raises(ValueError, match="multiple"):
        hk.cluster_output_columns(6, 2, 4)


@pytest.mark.parametrize("c,split", [(256, 4), (64, 2)])
def test_cluster_weight_slices_are_a_permutation_that_unslice_undoes(c, split):
    rng = np.random.default_rng(c)
    w = _t(rng.normal(size=(c, 3 * c)), BF)
    sl = hk.cluster_weight_slices(w, split)
    assert sl.shape == (split, c, 3 * c // split) and sl.dtype == BF
    assert torch.equal(sl.reshape(-1).sort().values, w.reshape(-1).sort().values)
    assert torch.equal(hk.cluster_weight_unslice(sl), w)
    cl = c // split
    for r in range(split):
        for part in range(3):
            assert torch.equal(sl[r, :, part * cl:(part + 1) * cl],
                               w[:, part * c + r * cl:part * c + (r + 1) * cl])


@pytest.mark.parametrize("c,split", [(256, 4), (64, 2)])
def test_cluster_rel_slices_are_what_the_plain_version_adds_to_k(c, split):
    rng = np.random.default_rng(1)
    rel_h, rel_w = _t(rng.normal(size=(10, c // 2))), _t(rng.normal(size=(10, c // 2)))
    sl = hk.cluster_rel_slices(rel_h, rel_w, split)
    assert sl.shape == (split, 100, c // split)
    k0 = torch.zeros(1, 1, 1, 100, c)
    want = add_rel_pos_to_k(k0, rel_h, rel_w, 10)[0, 0, 0]
    got = torch.cat(list(sl), dim=-1)  # the CTAs' columns are contiguous
    assert torch.equal(got, want)


@pytest.mark.parametrize("split", [2, 4])
def test_partial_logits_sum_to_the_whole_product(split):
    """Each CTA's q k^T over its own channels, summed in rank order in f32,
    is the window's q k^T."""
    rng = np.random.default_rng(2)
    c = 256
    q = _t(rng.normal(size=(64, c)), BF).float()
    k = _t(rng.normal(size=(112, c)), BF).float()
    total = torch.zeros(64, 112)
    for cols in hk.cluster_columns(c, split):
        total = total + q[:, cols] @ k[:, cols].T
    torch.testing.assert_close(total, q @ k.T, rtol=1e-5, atol=1e-4)


def _cluster_branch(x, w_qkv, rel_h, rel_w, levels, split):
    """``IWT^L(attn(qkv(DWT^L(x))))`` computed the way K1's cluster body
    cuts it, rounding where it rounds: every CTA projects the whole zc onto
    its weight slice, the partial logits are summed in rank order, the
    softmax is shared, each CTA's ``P v`` columns are handed to the CTA that
    owns their base channel, which takes the inverse transform."""
    dt = x.dtype
    zc = x.float()
    for _ in range(levels):
        zc = haar_dwt(zc)
    zc = zc.to(dt).float()
    bsz, hc, wc, c = zc.shape
    cl = c // split
    slices = hk.cluster_weight_slices(w_qkv, split).float()
    rel = hk.cluster_rel_slices(rel_h.float(), rel_w.float(), split)
    logits, vs = 0.0, []
    for r in range(split):
        qkv = zc @ slices[r]
        q = blockify((qkv[..., :cl] * c ** -0.5).to(dt), 8).float()
        k = extract_halo_windows(qkv[..., cl:2 * cl], 8, 1)
        k = (k + rel[r]).to(dt).float()
        vs.append(extract_halo_windows(qkv[..., 2 * cl:].to(dt), 8, 1).float())
        logits = logits + torch.einsum("bnmqc,bnmkc->bnmqk", q, k)
    p = torch.softmax(logits, dim=-1).to(dt).float()
    o = torch.cat([torch.einsum("bnmqk,bnmkc->bnmqc", p, v) for v in vs], dim=-1)
    # hand over by base channel, transform per owner, put the channels back
    cb = c // 4 ** levels
    out = torch.empty(bsz, hc * 2 ** levels, wc * 2 ** levels, cb)
    for r, cols in enumerate(hk.cluster_output_columns(cb, levels, split)):
        mine = unblockify(o[..., cols], hc, wc)
        for _ in range(levels):
            mine = haar_iwt(mine)
        out[..., r * (cb // split):(r + 1) * (cb // split)] = mine
    return out.to(dt)


@pytest.mark.parametrize("dtype,cb,levels,split", [
    ("float32", 16, 2, 4), ("bfloat16", 16, 2, 4), ("float32", 8, 1, 2)])
def test_cluster_arithmetic_is_the_plain_branch(dtype, cb, levels, split):
    rng = np.random.default_rng(3)
    td = torch.float32 if dtype == "float32" else BF
    c = cb * 4 ** levels
    x = _t(rng.normal(size=(1, 64, 32, cb)), td)
    w = _t(rng.normal(0, c ** -0.5, (c, 3 * c)), td)
    rel_h, rel_w = _t(rng.normal(size=(10, c // 2))), _t(rng.normal(size=(10, c // 2)))
    got = _cluster_branch(x, w, rel_h, rel_w, levels, split).float()
    want = hk.halo_attention_qkv_plain(x, w, rel_h, rel_w, levels=levels).float()
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=0, atol=3e-5)
    else:  # the order of the f32 sums moves a bf16 rounding here and there
        d = (got - want).abs()
        assert float(d.max()) < 5e-2 and float(d.mean()) < 5e-4


def test_cluster_arithmetic_matches_the_pallas_kernel():
    """f32, L = 2, base width 16 (C = 256), against the TPU kernel in
    interpret mode at the tolerance of tests/test_pallas_halo_attn.py."""
    import jax

    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 32, 32, 16)).astype(np.float32)
    w = rng.normal(0, 1 / 16, (256, 768)).astype(np.float32)
    rel_h = rng.normal(size=(10, 128)).astype(np.float32)
    rel_w = rng.normal(size=(10, 128)).astype(np.float32)
    want = np.asarray(halo_attention_qkv_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(rel_h), jnp.asarray(rel_w),
        levels=2, interpret=True, precision=jax.lax.Precision.HIGHEST))
    got = _cluster_branch(_t(x), _t(w), _t(rel_h), _t(rel_w), 2, 4).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("bad", ["misaligned", "pixel_stride"])
def test_k1_check_raises_on_what_the_cluster_body_cannot_load(bad):
    """At L = 2 and base width 16 the body reads x with vector loads: x must
    start on 16 bytes and its pixels must be a multiple of 8 channels apart."""
    rng = np.random.default_rng(5)
    w = _t(rng.normal(size=(256, 768)), BF)
    rel = _t(rng.normal(size=(10, 128)))
    s = torch.ones(1, 16)
    if bad == "misaligned":
        x = _t(rng.normal(size=(1, 32, 32, 20)), BF)[..., 4:]
    else:
        x = _t(rng.normal(size=(1, 32, 32, 20)), BF)[..., :16]
    with pytest.raises(ValueError, match="16-byte aligned"):
        hk._check(x, w, rel, rel, s, s, None, 2, 8, 1)
    ok = _t(rng.normal(size=(1, 32, 32, 32)), BF)[..., 16:]
    hk._check(ok, w, rel, rel, s, s, None, 2, 8, 1)


# ---------------------------------------------------------------------------
# K3, tiles, zero-filled windows and shifted products
# ---------------------------------------------------------------------------


def _tiled_ff_conv(oc, x, w, b, th=8, tw=16):
    """K3 as its kernel walks it: per 8x16 output tile a 10x18 input window,
    zero beyond the frame, nine shifted (pixels x C)(C x C) products summed
    in f32, then the three roundings; pixels beyond the frame are dropped."""
    bsz, h, wd, c = oc.shape
    out = torch.empty_like(oc)
    for bi in range(bsz):
        for y0 in range(0, h, th):
            for x0 in range(0, wd, tw):
                win = torch.zeros(th + 2, tw + 2, c)
                ys, xs = max(y0 - 1, 0), max(x0 - 1, 0)
                ye, xe = min(y0 + th + 1, h), min(x0 + tw + 1, wd)
                win[ys - y0 + 1:ye - y0 + 1, xs - x0 + 1:xe - x0 + 1] = \
                    oc[bi, ys:ye, xs:xe].float()
                acc = torch.zeros(th, tw, c)
                for dy in range(3):
                    for dx in range(3):
                        acc = acc + win[dy:dy + th, dx:dx + tw] @ w[dy, dx].float()
                hh, ww = min(th, h - y0), min(tw, wd - x0)
                y = acc[:hh, :ww].to(oc.dtype)
                out[bi, y0:y0 + hh, x0:x0 + ww] = \
                    (y + b) + x[bi, y0:y0 + hh, x0:x0 + ww]
    return out


@pytest.mark.parametrize("shape", [(1, 16, 32, 16), (2, 13, 21, 16), (1, 8, 8, 32),
                                   (1, 3, 40, 16)])
def test_k3_tile_walk_is_the_plain_conv(shape):
    """Whole tiles, edge tiles in both directions, a frame smaller than one
    tile; the tolerance is chip_smoke's for K3 (the f32 order of the tap sums
    moves a bf16 rounding at a tie)."""
    rng = np.random.default_rng(shape[1])
    c = shape[-1]
    oc, x = _t(rng.normal(size=shape), BF), _t(rng.normal(size=shape), BF)
    w = _t(rng.normal(0, (9 * c) ** -0.5, (3, 3, c, c)), BF)
    b = _t(rng.normal(0, (9 * c) ** -0.5, (c,)), BF)
    got, want = _tiled_ff_conv(oc, x, w, b).float(), ff_conv_plain(oc, x, w, b).float()
    tol = max(2e-3, 2e-2 * float(want.abs().max()))
    d = (got - want).abs()
    assert float(d.max()) <= tol
    assert float((d > 0).float().mean()) < 1e-2  # ties are rare
