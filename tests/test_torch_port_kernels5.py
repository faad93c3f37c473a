"""The arithmetic of the Hopper designs of K2 and of K1 at L = 0 / L = 1, on
the CPU.

The CUDA kernels run only on the card (tests/test_torch_port_cuda.py,
chip_smoke.py). What can be held here is the way they cut the work. K2
walks 8x16 LR tiles, contracts the phase band with the 3x3 weight first
(``T = ph . w3`` per phase block and tap) and lets every output phase gather
its nine T values in a fixed order. K1's window bodies keep a warp's 16 x 112
logits in accumulator registers, mask the pad slots, reduce over the lanes
of a quad and hand bf16(P) to ``P v`` from the same registers. Each cut is a
plain function on tensors beside its wrapper (``ops/kernels/tail_band.py``,
``ops/kernels/halo_attn.py``) and is held against the plain versions and
against the JAX Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2trans_tpu.ops.pallas.halo_attn import cftm_branch_fused, halo_attention_qkv_fused
from m2trans_tpu.ops.pallas.tail_band import tail_band_apply as jax_tail_band
from m2trans_tpu_torch.ops.kernels import halo_attn as hk
from m2trans_tpu_torch.ops.kernels import tail_band as tb
from m2trans_tpu_torch.ops.pixel_shuffle import pixel_shuffle_fast
from m2trans_tpu_torch.ops.tail_phase import _k_selector

BF = torch.bfloat16


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# K2: tile walk, contraction, gather
# ---------------------------------------------------------------------------


def _tail_params(scale, nf, seed):
    """(JAX HWIO params, port OIHW params) of one random tail."""
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
        jp = {"c0": conv(1, nf, nf * scale * scale), "c1": conv(3, nf, 3, bias=False)}
    tp = {k: {n: _t(v.transpose(3, 2, 0, 1) if n == "w" else v)
              for n, v in sp.items()} for k, sp in jp.items()}
    jp = {k: {n: jnp.asarray(v) for n, v in sp.items()} for k, sp in jp.items()}
    return jp, tp


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("scale,hw", [(2, (8, 16)), (2, (9, 7)), (3, (16, 32)),
                                      (3, (5, 20)), (4, (8, 16)), (4, (12, 20))])
def test_contract_then_gather_is_the_plain_tail(scale, hw, dtype):
    """Frames that are whole tiles and frames that are not, in either
    direction, ring included: max abs <= 2e-3 in bf16 (the f32 order of the
    nine-term sums moves a rounding at a tie), <= 1e-5 in f32."""
    td = BF if dtype == "bfloat16" else torch.float32
    _, tp = _tail_params(scale, 16, seed=scale)
    y = _t(np.random.default_rng(hw[1]).normal(size=(2, *hw, 16)), td)
    ops = tb.tail_band_operands(tp, y, scale=scale, dtype=td)
    want = tb.tail_band_plain(*ops, scale=scale, rgb_range=1.0).float()
    got = tb.tail_band_contract_gather(*ops, scale=scale, rgb_range=1.0).float()
    assert got.shape == want.shape == (2, *hw, scale * scale * 3)
    assert float((got - want).abs().max()) <= (2e-3 if td == BF else 1e-5)


@pytest.mark.parametrize("scale,hw", [(2, (16, 16)), (3, (16, 24)), (4, (24, 40))])
def test_contract_then_gather_matches_pallas_bf16(scale, hw):
    """Against the TPU kernel in interpret mode on the same numpy inputs, at
    the tolerance of tests/test_torch_port_kernels.py."""
    nf = 8
    jp, tp = _tail_params(scale, nf, seed=scale)
    x = np.random.default_rng(7).normal(0, 1, (2, *hw, nf)).astype(np.float32)
    want = np.asarray(jax_tail_band(
        jp, jnp.asarray(x).astype(jnp.bfloat16), scale=scale, rgb_range=1.0,
        dtype=jnp.bfloat16, interpret=True)).astype(np.float32)
    ops = tb.tail_band_operands(tp, _t(x, BF), scale=scale)
    got = pixel_shuffle_fast(
        tb.tail_band_contract_gather(*ops, scale=scale, rgb_range=1.0), scale)
    np.testing.assert_allclose(got.float().numpy(), want, atol=8e-3)


@pytest.mark.parametrize("hw", [(96, 96), (100, 76), (7, 5), (8, 17)])
def test_tile_walk_covers_every_lr_pixel_once(hw):
    h, w = hw
    seen = torch.zeros(h, w, dtype=torch.int32)
    tiles = tb.tail_tile_walk(h, w)
    assert len(tiles) == -(-h // tb.TILE[0]) * (-(-w // tb.TILE[1]))
    for r0, c0, rows, cols in tiles:
        assert r0 % tb.TILE[0] == 0 and c0 % tb.TILE[1] == 0
        assert 1 <= rows <= tb.TILE[0] and 1 <= cols <= tb.TILE[1]
        seen[r0:r0 + rows, c0:c0 + cols] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_tap_table_is_the_selector_in_group_order(scale):
    """Every (phase, tap) names the one non-zero block of the expanded
    kernel, and a phase's terms come by group of four blocks, then by tap."""
    M = _k_selector(scale)  # [yo+1, xo+1, block, dr+1, dc+1, phase]
    table = tb.phase_tap_table(scale)
    assert len(table) == scale * scale
    for q, terms in enumerate(table):
        assert sorted(t[0] for t in terms) == list(range(9))
        assert [(t[1] // 4, t[0]) for t in terms] == sorted(
            (t[1] // 4, t[0]) for t in terms)
        for tap, blk, yo, xo in terms:
            assert M[yo + 1, xo + 1, blk, tap // 3, tap % 3, q] == 1.0
    assert M.sum() == 9 * scale * scale


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_ring_slots_feed_only_the_blocks_that_face_the_tile(scale):
    """The halo slots are the 10x18 halo once, tile pixels first; a block is
    marked needed exactly when some tap of some output pixel of the tile
    reads it (so the blocks K2 skips are never gathered)."""
    th, tw = tb.TILE
    slots = tb.halo_slots()
    assert len(slots) == len(set(slots)) == (th + 2) * (tw + 2)
    assert slots[:th * tw] == [(1 + r, 1 + c) for r in range(th) for c in range(tw)]
    read = {slot: set() for slot in slots}
    for terms in tb.phase_tap_table(scale):
        for _, blk, yo, xo in terms:
            for r in range(th):
                for c in range(tw):
                    read[(1 + r + yo, 1 + c + xo)].add(blk)
    assert [read[slot] for slot in slots] == tb.halo_needed_blocks(scale)
    P = scale * scale
    ring = sum(len(b) for b in tb.halo_needed_blocks(scale)[th * tw:])
    assert ring == 2 * (th + tw) * scale + 4 < (len(slots) - th * tw) * P


def test_k2_check_refuses_widths_the_kernel_does_not_take():
    y = torch.zeros((1, 8, 8, 80), dtype=BF)
    with pytest.raises(ValueError, match="multiple of 16, at most 64"):
        tb._launch(y, *[None] * 9, 4, 1.0)


# ---------------------------------------------------------------------------
# K1 at L = 0 / L = 1: softmax on the accumulator registers
# ---------------------------------------------------------------------------


def test_two_accumulator_tiles_are_one_a_fragment():
    """Registers (2*hr, 2*hr + 1) of accumulator tiles 2*kk + h hold, lane by
    lane, the elements that A-fragment register 2*h + hr of k16 step kk
    wants: P goes from the logits to P v without leaving its registers."""
    cl, al = hk.mma_accumulator_layout(), hk.mma_a_layout()
    for h in range(2):
        for hr in range(2):
            for half in range(2):
                assert torch.equal(cl[:, 2 * hr + half, 0], al[:, 2 * h + hr, half, 0])
                assert torch.equal(cl[:, 2 * hr + half, 1] + 8 * h,
                                   al[:, 2 * h + hr, half, 1])
    covered = torch.zeros(16, 8, dtype=torch.int32)
    covered[cl[..., 0].reshape(-1), cl[..., 1].reshape(-1)] += 1
    assert bool((covered == 1).all())


def test_window_slots_are_the_window_once():
    slots = hk.window_slots()
    assert slots.shape == (hk.NK, 2)
    assert len({(int(r), int(c)) for r, c in slots}) == 100
    assert torch.equal(slots[:hk.NQ, 0], 1 + torch.arange(64) // 8)
    assert torch.equal(slots[:hk.NQ, 1], 1 + torch.arange(64) % 8)


@pytest.mark.parametrize("c", [16, 64])
def test_register_softmax_is_the_softmax_over_the_real_keys(c):
    rng = np.random.default_rng(c)
    q, k, v = (_t(rng.normal(size=(n, c))) for n in (hk.NQ, hk.NKP, hk.NKP))
    k[hk.NK:] = 1e3  # pad slots must not be seen
    got = hk.register_softmax_window(q, k, v, torch.float32)
    want = torch.softmax(q @ k[:hk.NK].T, dim=-1) @ v[:hk.NK]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["affine", "affine+add", "bare"])
@pytest.mark.parametrize("levels", [0, 1])
def test_window_arithmetic_is_the_plain_branch(levels, mode, dtype):
    rng = np.random.default_rng(levels + len(mode))
    td = BF if dtype == "bfloat16" else torch.float32
    cb, c = 16, 16 * 4 ** levels
    side = 16 * 2 ** levels
    x = _t(rng.normal(size=(2, side, 2 * side, cb)), td)
    w = _t(rng.normal(0, c ** -0.5, (c, 3 * c)), td)
    rel_h, rel_w = _t(rng.normal(size=(10, c // 2))), _t(rng.normal(size=(10, c // 2)))
    s, t = _t(rng.uniform(0.5, 1.5, (2, cb))), _t(rng.normal(0, 0.2, (2, cb)))
    add = _t(rng.normal(size=x.shape), td) if mode == "affine+add" else None
    if mode == "bare":
        got = hk.window_branch(x, w, rel_h, rel_w, levels=levels)
        want = hk.halo_attention_qkv_plain(x, w, rel_h, rel_w, levels=levels)
    else:
        got = hk.window_branch(x, w, rel_h, rel_w, s, t, x_add=add, levels=levels)
        want = hk.cftm_branch_plain(x, w, rel_h, rel_w, s, t, x_add=add, levels=levels)
    d = (got.float() - want.float()).abs()
    if td == BF:  # the order of the f32 sums moves a bf16 rounding here and there
        assert float(d.max()) < 5e-2 and float(d.mean()) < 5e-4
    else:
        assert float(d.max()) < 3e-5


@pytest.mark.parametrize("levels,with_add", [(0, False), (0, True), (1, False),
                                             (1, True)])
def test_window_arithmetic_matches_the_pallas_cascade_kernel(levels, with_add):
    """bf16, base width 16, against the TPU cascade kernel in interpret mode
    at the tolerance of tests/test_torch_port_kernels.py."""
    rng = np.random.default_rng(20 + levels)
    cb, c = 16, 16 * 4 ** levels
    side = 16 * 2 ** levels
    d = dict(x=rng.normal(size=(1, side, side, cb)), w=rng.normal(0, c ** -0.5, (c, 3 * c)),
             rel_h=rng.normal(size=(10, c // 2)), rel_w=rng.normal(size=(10, c // 2)),
             s=rng.uniform(0.5, 1.5, (1, cb)), t=rng.normal(0, 0.2, (1, cb)),
             add=rng.normal(size=(1, side, side, cb)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    bf = jnp.bfloat16
    want = np.asarray(cftm_branch_fused(
        jnp.asarray(d["x"]).astype(bf), jnp.asarray(d["w"]).astype(bf),
        jnp.asarray(d["rel_h"]), jnp.asarray(d["rel_w"]), jnp.asarray(d["s"]),
        jnp.asarray(d["t"]), x_add=jnp.asarray(d["add"]).astype(bf) if with_add else None,
        r=0.5, levels=levels, interpret=True)).astype(np.float32)
    got = hk.window_branch(
        _t(d["x"], BF), _t(d["w"], BF), _t(d["rel_h"]), _t(d["rel_w"]), _t(d["s"]),
        _t(d["t"]), x_add=_t(d["add"], BF) if with_add else None, r=0.5,
        levels=levels).float().numpy()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    assert float(np.abs(got - want).mean()) < 5e-3


@pytest.mark.parametrize("levels", [0, 1])
def test_window_arithmetic_matches_the_pallas_bare_kernel(levels):
    """K1n in f32 against the TPU kernel in interpret mode at the tolerance
    of tests/test_pallas_halo_attn.py."""
    rng = np.random.default_rng(30 + levels)
    c = 16 * 4 ** levels
    side = 16 * 2 ** levels
    x = rng.normal(size=(1, side, side, 16)).astype(np.float32)
    w = rng.normal(0, c ** -0.5, (c, 3 * c)).astype(np.float32)
    rel_h = rng.normal(size=(10, c // 2)).astype(np.float32)
    rel_w = rng.normal(size=(10, c // 2)).astype(np.float32)
    want = np.asarray(halo_attention_qkv_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(rel_h), jnp.asarray(rel_w),
        levels=levels, interpret=True, precision=jax.lax.Precision.HIGHEST))
    got = hk.window_branch(_t(x), _t(w), _t(rel_h), _t(rel_w), levels=levels).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("bad", ["misaligned", "pixel_stride"])
@pytest.mark.parametrize("levels", [0, 1])
def test_k1_check_raises_on_what_the_window_bodies_cannot_load(levels, bad):
    """At base width 16 the bodies read x with 16-byte loads: x must start on
    16 bytes and its pixels must be a multiple of 8 channels apart."""
    rng = np.random.default_rng(5)
    c = 16 * 4 ** levels
    w = _t(rng.normal(size=(c, 3 * c)), BF)
    rel = _t(rng.normal(size=(10, c // 2)))
    s = torch.ones(1, 16)
    if bad == "misaligned":
        x = _t(rng.normal(size=(1, 32, 32, 20)), BF)[..., 4:]
    else:
        x = _t(rng.normal(size=(1, 32, 32, 20)), BF)[..., :16]
    with pytest.raises(ValueError, match="16-byte aligned"):
        hk._check(x, w, rel, rel, s, s, None, levels, 8, 1)
    ok = _t(rng.normal(size=(1, 32, 32, 32)), BF)[..., 16:]
    hk._check(ok, w, rel, rel, s, s, None, levels, 8, 1)
    hk._check(ok, w, rel, rel, s, s, ok, levels, 8, 1)


def test_variant_names_the_body_each_shape_takes():
    """By shape alone: base width 16 has a body per level, other widths go to
    the general body (the built library's choice is held to this on the
    card)."""
    assert [hk.variant_by_shape(16, lv) for lv in (0, 1, 2)] == [
        "w16_warp", "w64_warpgroup", "c256_cluster4"]
    for cb, lv in ((32, 0), (32, 1), (4, 2), (64, 0), (8, 1)):
        assert hk.variant_by_shape(cb, lv) == "general"
    assert set(hk._VARIANTS) == {"general", "c256_cluster4", "w16_warp",
                                 "w64_warpgroup"}
