"""K1, the fused CFTM wavelet branch: wrapper, launch count and plain
version.

Replaces the TPU kernels behind ``cftm_branch_fused``
(m2trans_tpu/ops/pallas/halo_attn.py: ``_cascade_kernel`` via
``_cascade_banded_impl``, ``_cascade_tile_kernel`` via
``_cascade_tiled_impl``; m2trans_tpu/ops/pallas/halo_attn_packed.py:
``_packed_cascade_kernel`` via ``packed_cascade_core``,
``_packed_front_kernel`` via ``packed_front_core``). Row bands, column
slabs and lane packing were TPU choices; on the card they are one source,
``csrc/cftm_branch.cu``, with four bodies taken by shape alone
(:func:`cftm_branch_variant` names the one a shape launches). At base width
16, the flagship's:

- L = 0 (C = 16) and L = 1 (C = 64), ``csrc/cftm_window.cuh``: a chain of
  latencies bound them, not operations or bytes, so a window belongs to one
  warp (``w16_warp``) or to a group of four warps (``w64_warpgroup``) with
  no block barrier inside a window; 16-byte loads and stores; projection,
  ``q k^T`` and ``P v`` on ``mma.sync``; the softmax on the accumulator
  registers, P fed to ``P v`` as A fragments, so neither the f32 logits nor
  P visit shared memory (:func:`register_softmax_window` and
  :func:`window_branch` state that arithmetic on tensors);
- L = 2 (C = 256), ``c256_cluster4``: operations and the room for them
  bind: the 384 KB weight exceeds a block's shared memory and a batch has
  fewer windows than the card has SMs, so one window is split over a
  thread-block cluster of four CTAs (``cluster_*`` below state the split on
  tensors), each streaming its 256x192 weight slice through a ``cp.async``
  ring into ``mma.sync`` + ``ldmatrix`` products and exchanging partial
  logits, probabilities and ``P v`` through distributed shared memory.

Every other base width takes the general body, one block per window on
WMMA. The headers have the detail, the waves and the reason ``wgmma`` was
not taken.

K1b, its VJP (``csrc/cftm_branch_bwd.cu``), replaces the TPU backward
kernels of ``cftm_branch_fused``'s custom_vjp (halo_attn.py
``_cascade_bwd_kernel``, ``_cascade_bwd_tile_kernel``; halo_attn_packed.py
``_packed_bwd_kernel``, ``_packed_bwd_tile_kernel``,
``_packed_front_bwd_kernel``). :class:`CftmBranchFn` ties the two together
for autograd: its forward launches K1 and saves only the inputs, its
backward launches K1b (:func:`cftm_branch_bwd`).

    out = B(z) + z,   z = (x*s + t) [+ r*x_add]   (zero outside the frame)
    B   = DWT^L -> qkv -> 8x8-block / 10x10-window halo attention -> IWT^L

K1n, the bare wavelet branch (``halo_attention_qkv_fused`` of halo_attn.py:
``_kernel`` via ``_halo_attention_banded_impl``, ``_tile_kernel`` via
``_halo_attention_tiled_impl``, ``_multiband_kernel`` via
``_halo_attention_whole_impl``), is B alone, no affine and no residual: a
second entry of ``csrc/cftm_branch.cu`` (:func:`halo_attention_qkv`). Its
TPU custom_vjp differentiates the XLA composition, so
:class:`HaloAttnQkvFn`'s backward is the plain version's VJP.

:func:`cftm_branch` launches the kernels for CUDA tensors and runs
:func:`cftm_branch_plain` (differentiated by autograd) for CPU tensors
only; anything else raises. :func:`cftm_branch_plain_vjp` is K1b's plain
version.
"""

from __future__ import annotations

from typing import Optional

import torch

from m2trans_tpu_torch.ops.halo_attention import (
    add_rel_pos_to_k,
    blockify,
    extract_halo_windows,
    unblockify,
)
from m2trans_tpu_torch.ops.kernels import build
from m2trans_tpu_torch.ops.wavelet import haar_dwt, haar_iwt


def _branch_plain_f32(z: torch.Tensor, w_qkv, rel_h, rel_w, levels: int,
                      block: int, halo: int) -> torch.Tensor:
    """``IWT^L(attn(qkv(DWT^L(z))))`` in f32, rounding to ``z``'s dtype
    where K1 rounds: the DWT output, q/k(+rel)/v after f32 products, the
    probabilities after an f32 softmax; P v and the IWT stay f32."""
    dt = z.dtype
    zc = z.float()
    for _ in range(levels):
        zc = haar_dwt(zc)
    qkv = zc.to(dt).float() @ w_qkv.float()
    c = qkv.shape[-1] // 3
    bsz, hc, wc, _ = qkv.shape
    win = block + 2 * halo
    q = blockify((qkv[..., :c] * c ** -0.5).to(dt), block).float()
    k = add_rel_pos_to_k(extract_halo_windows(qkv[..., c:2 * c], block, halo),
                         rel_h.float(), rel_w.float(), win).to(dt).float()
    v = extract_halo_windows(qkv[..., 2 * c:].to(dt), block, halo).float()
    attn = torch.softmax(torch.einsum("bnmqc,bnmkc->bnmqk", q, k), dim=-1)
    o = torch.einsum("bnmqk,bnmkc->bnmqc", attn.to(dt).float(), v)
    o = unblockify(o, hc, wc)
    for _ in range(levels):
        o = haar_iwt(o)
    return o


def cftm_branch_plain(x: torch.Tensor, w_qkv: torch.Tensor,
                      rel_h: torch.Tensor, rel_w: torch.Tensor,
                      s: torch.Tensor, t: torch.Tensor, *,
                      x_add: Optional[torch.Tensor] = None, r: float = 0.5,
                      levels: int = 0, block: int = 8, halo: int = 1
                      ) -> torch.Tensor:
    """Plain PyTorch version of K1, rounding where the kernel rounds: z and
    the DWT output to the input dtype, q/k(+rel)/v to it after f32
    products, softmax in f32, the probabilities to it, then f32 P v, IWT
    and residual, one final rounding. In f32 every rounding is a no-op and
    this is the XLA composition ``_cascade_xla`` of the JAX package.

    x, x_add: (B, H, W, Cb); s, t: (B, Cb) f32; w_qkv: (C, 3C) with
    C = Cb * 4**levels; rel_h, rel_w: (block + 2*halo, C/2)."""
    dt = x.dtype
    z = x.float() * s.float()[:, None, None, :] + t.float()[:, None, None, :]
    if x_add is not None:
        z = z + r * x_add.float()
    z = z.to(dt)
    o = _branch_plain_f32(z, w_qkv, rel_h, rel_w, levels, block, halo)
    return (o + z.float()).to(dt)


def halo_attention_qkv_plain(x: torch.Tensor, w_qkv: torch.Tensor,
                             rel_h: torch.Tensor, rel_w: torch.Tensor, *,
                             levels: int = 0, block: int = 8, halo: int = 1
                             ) -> torch.Tensor:
    """Plain PyTorch version of K1n, the bare wavelet branch
    ``IWT^L(attn(qkv(DWT^L(x))))``: no affine, no residual, rounded once
    from the f32 IWT result. In f32 it is ``_xla_reference`` of the JAX
    package."""
    return _branch_plain_f32(x, w_qkv, rel_h, rel_w, levels, block,
                             halo).to(x.dtype)


# K1's C = 256 body splits one window over a cluster of CLUSTER_SPLIT CTAs.
# The functions below state, on tensors, which part of the operands each CTA
# of the cluster works on; the kernel indexes the (C, 3C) weight and the
# rel-pos tables in place, so nothing is rearranged on the host.
CLUSTER_SPLIT = 4
_VARIANTS = ("general", "c256_cluster4", "w16_warp", "w64_warpgroup")
NQ, NK, NKP = 64, 100, 112  # queries, keys and padded key slots of a window


def cluster_columns(c: int, split: int = CLUSTER_SPLIT) -> torch.Tensor:
    """Coarse channels whose q, k and v columns each CTA of a window's
    cluster projects, and over which it sums its partial logits: (split,
    c/split) int64, rank r the contiguous channels [r*c/split,
    (r+1)*c/split). With channel index ``g*cb + cc`` (g the subband) these
    are the subbands [r*G/split, (r+1)*G/split) of every base channel."""
    if c % split:
        raise ValueError(f"c={c} is not a multiple of split={split}")
    return torch.arange(c).reshape(split, c // split)


def cluster_output_columns(cb: int, levels: int, split: int = CLUSTER_SPLIT
                           ) -> torch.Tensor:
    """Coarse channels of ``P v`` whose inverse wavelet transform each CTA
    takes: (split, C/split) int64, rank r the base channels [r*cb/split,
    (r+1)*cb/split) with all their subbands, in the order ``g*(cb/split) +
    cc`` in which the CTAs hand them to it."""
    if cb % split:
        raise ValueError(f"cb={cb} is not a multiple of split={split}")
    g, cbl = 4 ** levels, cb // split
    r = torch.arange(split)[:, None, None]
    gg = torch.arange(g)[None, :, None]
    cc = torch.arange(cbl)[None, None, :]
    return (gg * cb + r * cbl + cc).reshape(split, g * cbl)


def cluster_weight_slices(w_qkv: torch.Tensor, split: int = CLUSTER_SPLIT
                          ) -> torch.Tensor:
    """The (C, 3C) q|k|v weight as the cluster's CTAs stage it: (split, C,
    3*C/split), rank r's q, k and v columns side by side."""
    c = w_qkv.shape[0]
    cols = cluster_columns(c, split).to(w_qkv.device)
    return torch.cat([w_qkv[:, part * c:(part + 1) * c][:, cols].permute(1, 0, 2)
                      for part in range(3)], dim=-1)


def cluster_weight_unslice(slices: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`cluster_weight_slices`: back to (C, 3C)."""
    split, c, cl3 = slices.shape
    cl = cl3 // 3
    cols = cluster_columns(c, split).to(slices.device)
    w = slices.new_empty(c, 3 * c)
    for part in range(3):
        for r in range(split):
            w[:, part * c + cols[r]] = slices[r, :, part * cl:(part + 1) * cl]
    return w


def cluster_rel_slices(rel_h: torch.Tensor, rel_w: torch.Tensor,
                       split: int = CLUSTER_SPLIT) -> torch.Tensor:
    """The rel-pos tables as each CTA adds them to its k columns: (split,
    win*win, C/split), row ``wr*win + wc`` of the key window, the first C/2
    channels taking ``rel_h[wr]`` and the rest ``rel_w[wc]``."""
    win = rel_h.shape[0]
    full = torch.cat([rel_h[:, None, :].expand(win, win, -1),
                      rel_w[None, :, :].expand(win, win, -1)], dim=-1)
    cols = cluster_columns(full.shape[-1], split).to(rel_h.device)
    return full.reshape(win * win, -1)[:, cols].permute(1, 0, 2)


def cftm_branch_variant(cb: int, levels: int) -> str:
    """Name of the body of ``csrc/cftm_branch.cu`` that K1 and K1n launch
    for base width ``cb`` at ``levels``, as the built library decides it."""
    return _VARIANTS[build.lib().m2t_cftm_branch_variant(cb, levels)]


def variant_by_shape(cb: int, levels: int) -> str:
    """The same choice stated here, for code that runs without the library
    (the sources' ``variant_of``): base width 16 has a body of its own per
    level, every other width the general one."""
    if cb != 16 or levels not in (0, 1, 2):
        return "general"
    return ("w16_warp", "w64_warpgroup", "c256_cluster4")[levels]


# The bodies of csrc/cftm_window.cuh keep a window's 16 x 112 logits of one
# warp in the accumulator registers of seven pairs of m16n8 tiles. The three
# functions below state that layout and the softmax on it.


def window_slots(block: int = 8) -> torch.Tensor:
    """(100, 2) int64: (row, col) in the 10x10 key window of every slot, in
    the kernels' order (``win_coord``): the 8x8 query block row-major, then
    the top and bottom halo rows, the left and right halo columns."""
    q = [(1 + i // block, 1 + i % block) for i in range(block * block)]
    ring = ([(0, c) for c in range(10)] + [(9, c) for c in range(10)]
            + [(1 + r, 0) for r in range(block)] + [(1 + r, 9) for r in range(block)])
    return torch.tensor(q + ring)


def mma_accumulator_layout() -> torch.Tensor:
    """(32 lanes, 4 registers, 2) int64: (row, column) in a 16x8 accumulator
    tile of ``mma.m16n8k16`` that each register of each lane holds."""
    lane = torch.arange(32)[:, None]
    e = torch.arange(4)[None, :]
    return torch.stack([lane // 4 + 8 * (e // 2), 2 * (lane % 4) + e % 2], dim=-1)


def mma_a_layout() -> torch.Tensor:
    """(32 lanes, 4 registers, 2 halves, 2) int64: (row, k) in the 16x16 A
    operand of each bf16 half of each register of each lane."""
    lane = torch.arange(32)[:, None, None]
    r = torch.arange(4)[None, :, None]
    h = torch.arange(2)[None, None, :]
    return torch.stack([(lane // 4 + 8 * (r % 2)).expand(32, 4, 2),
                        2 * (lane % 4) + 8 * (r // 2) + h], dim=-1)


def register_softmax_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            dtype=torch.bfloat16) -> torch.Tensor:
    """One window's ``softmax(q k^T) v`` as the bodies of cftm_window.cuh
    compute it. q: (64, C) (scaled), k, v: (112, C) in slot order, pad rows
    100..111 anything finite. Each warp owns 16 query rows; its logits lie
    in 14 accumulator tiles (:func:`mma_accumulator_layout`), pad slots are
    masked to -inf, the row max and sum are reduced over the four lanes of a
    quad, and ``dtype(P)`` goes to ``P v`` as A fragments taken from the same
    registers (tiles 2*kk and 2*kk + 1 are the k16 step kk). Returns the f32
    (64, C) result."""
    cl, al = mma_accumulator_layout(), mma_a_layout()
    out = []
    for w in range(NQ // 16):
        logits = q[16 * w:16 * w + 16].float() @ k.float().T  # (16, 112)
        # registers: s[lane, nt, e] = logits[row, nt*8 + col]
        key = torch.arange(NKP // 8)[None, :, None] * 8 + cl[:, None, :, 1]
        row = cl[:, None, :, 0].expand(32, NKP // 8, 4)
        s = logits[row, key]
        s = torch.where(key >= NK, torch.full_like(s, float("-inf")), s)
        quad = torch.arange(32) // 4
        m = torch.full((8, 2), float("-inf"))
        tot = torch.zeros(8, 2)
        for hr in range(2):  # rows g8 and g8 + 8: registers 2*hr, 2*hr + 1
            own = s[:, :, 2 * hr:2 * hr + 2].reshape(32, -1)
            m[:, hr] = own.max(dim=1).values.reshape(8, 4).max(dim=1).values
        p = torch.exp(s - m[quad][:, None, :].repeat_interleave(2, dim=-1))
        for hr in range(2):
            own = p[:, :, 2 * hr:2 * hr + 2].reshape(32, -1)
            tot[:, hr] = own.sum(dim=1).reshape(8, 4).sum(dim=1)
        p = (p / tot[quad][:, None, :].repeat_interleave(2, dim=-1)).to(dtype)
        # A fragments of k16 step kk: registers (2*h + hr) <- tile 2*kk + h,
        # accumulator registers (2*hr, 2*hr + 1); rebuild P from them
        pm = torch.zeros(16, NKP)
        for kk in range(NKP // 16):
            for h in range(2):
                for hr in range(2):
                    r = 2 * h + hr
                    for half in range(2):
                        rows, ks = al[:, r, half, 0], al[:, r, half, 1]
                        pm[rows, 16 * kk + ks] = p[:, 2 * kk + h, 2 * hr + half].float()
        out.append(pm @ v.to(dtype).float())
    return torch.cat(out)


def window_branch(x: torch.Tensor, w_qkv: torch.Tensor, rel_h: torch.Tensor,
                  rel_w: torch.Tensor, s=None, t=None, *, x_add=None,
                  r: float = 0.5, levels: int = 0) -> torch.Tensor:
    """K1 (K1n with ``s`` None) as the bodies of cftm_window.cuh cut it,
    rounding where they round: per 8x8 coarse query block the 112 padded
    slots of its window (zero outside the frame and in the pad rows), the
    projection with rel-pos added to the 100 real keys,
    :func:`register_softmax_window`, the inverse transform and the residual
    from the kept z."""
    dt = x.dtype
    z = x.float()
    if s is not None:
        z = z * s.float()[:, None, None, :] + t.float()[:, None, None, :]
        if x_add is not None:
            z = z + r * x_add.float()
    z = z.to(dt)
    zc = z.float()
    for _ in range(levels):
        zc = haar_dwt(zc)
    zc = zc.to(dt)
    bsz, hc, wc, c = zc.shape
    zp = torch.nn.functional.pad(zc, (0, 0, 1, 1, 1, 1))
    slots = window_slots()
    rel = torch.cat([rel_h.float()[slots[:, 0]], rel_w.float()[slots[:, 1]]], dim=-1)
    o = torch.zeros(bsz, hc, wc, c)
    for b in range(bsz):
        for bi in range(hc // 8):
            for bj in range(wc // 8):
                rows = torch.zeros(NKP, c, dtype=dt)
                rows[:NK] = zp[b, 8 * bi + slots[:, 0], 8 * bj + slots[:, 1]]
                qkv = rows.float() @ w_qkv.float()
                q = (qkv[:NQ, :c] * c ** -0.5).to(dt)
                k = qkv[:, c:2 * c]
                k[:NK] = k[:NK] + rel
                ov = register_softmax_window(q, k.to(dt), qkv[:, 2 * c:].to(dt), dt)
                o[b, 8 * bi:8 * bi + 8, 8 * bj:8 * bj + 8] = ov.reshape(8, 8, c)
    for _ in range(levels):
        o = haar_iwt(o)
    return (o + z.float()).to(dt) if s is not None else o.to(dt)


# K1b at base width 16 (csrc/cftm_branch_bwd.cu) keeps a warp's 16 x 112
# logits, probabilities, dP and dS in the accumulator registers; a window's
# dq, dk, dv cross global memory once; an 8x8 block gathers them through a
# neighbour table; every partial sum goes through one tree reduction. The
# functions below state that arithmetic on tensors.

RED_LANES = 8  # row lanes of the reduction's tree (reduce_tree_kernel)


def tree_reduce_rows(part: torch.Tensor) -> torch.Tensor:
    """Sum of the rows of ``part`` (n, ...) in the order of K1b's and K2b's
    reduction: lane l sums the rows i = l (mod 8) in ascending order, then
    ``((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7))``, all in f32. The
    order depends on the indices alone, so two runs give the same bits."""
    part = part.float()
    lanes = []
    for lane in range(RED_LANES):
        acc = torch.zeros_like(part[0])
        for i in range(lane, part.shape[0], RED_LANES):
            acc = acc + part[i]
        lanes.append(acc)
    return ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])) + \
        ((lanes[4] + lanes[5]) + (lanes[6] + lanes[7]))


def slot_of_window_position() -> torch.Tensor:
    """(10, 10) int64: the slot of every (row, col) of the key window, the
    inverse of :func:`window_slots` (the kernels' ``win_slot``)."""
    out = torch.empty(10, 10, dtype=torch.int64)
    slots = window_slots()
    out[slots[:, 0], slots[:, 1]] = torch.arange(NK)
    return out


def key_neighbours(nbh: int, nbw: int):
    """For every 8x8 block (bi, bj) of an (nbh, nbw) grid and every pixel p
    of it, the (window row, window column, slot) triples of the windows that
    hold the pixel as a key, in the order K1b's second kernel sums them
    (dy = -1..1, dx = -1..1; the block's own window among them, at most 4).
    Worked out once a pixel. Returns a dict keyed (bi, bj) of 64 lists."""
    slot_of = slot_of_window_position()
    table = {}
    for bi in range(nbh):
        for bj in range(nbw):
            rows = []
            for p in range(NQ):
                li, lj = divmod(p, 8)
                found = []
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        wr, wc = 1 + li - 8 * dy, 1 + lj - 8 * dx
                        if (0 <= bi + dy < nbh and 0 <= bj + dx < nbw
                                and 0 <= wr <= 9 and 0 <= wc <= 9):
                            found.append((bi + dy, bj + dx, int(slot_of[wr, wc])))
                rows.append(found)
            table[(bi, bj)] = rows
    return table


def _rows_from_fragments(regs: torch.Tensor) -> torch.Tensor:
    """(32 lanes, 14 tiles, 4 registers) accumulator values of a warp's 16 x
    112 tile -> the (16, 112) matrix, read as the A fragments of the next
    product take them (tiles 2*kk and 2*kk + 1 are the k16 step kk)."""
    al = mma_a_layout()
    out = torch.zeros(16, NKP, dtype=regs.dtype)
    for kk in range(NKP // 16):
        for h in range(2):
            for hr in range(2):
                for half in range(2):
                    rows, ks = al[:, 2 * h + hr, half, 0], al[:, 2 * h + hr, half, 1]
                    out[rows, 16 * kk + ks] = regs[:, 2 * kk + h, 2 * hr + half]
    return out


def register_softmax_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         d_o: torch.Tensor, dtype=torch.bfloat16):
    """One window's P and dS as K1b's window body forms them. q, d_o: (64, C)
    (q scaled), k, v: (112, C) in slot order. A warp owns 16 query rows; its
    logits, its ``dP = dO v^T`` and with them ``dS = P * (dP - rowsum(dP *
    P))`` lie in the 14 accumulator tiles of :func:`mma_accumulator_layout`;
    pad slots are masked to -inf before the softmax, so P and dS are zero
    there; the row max, the row sum and ``rowsum(dP * P)`` are reduced over
    the four lanes of a quad. Returns ``dtype(P)``, ``dtype(dS)``, (64, 112)
    each, as they cross shared memory for ``P^T dO`` and ``dS^T q``."""
    cl = mma_accumulator_layout()
    key = torch.arange(NKP // 8)[None, :, None] * 8 + cl[:, None, :, 1]
    row = cl[:, None, :, 0].expand(32, NKP // 8, 4)
    quad = torch.arange(32) // 4

    def quad_rows(vals, op):  # (32, 14, 4) -> (8 quads, 2 rows)
        out = torch.empty(8, 2)
        for hr in range(2):
            own = op(vals[:, :, 2 * hr:2 * hr + 2].reshape(32, -1))
            out[:, hr] = op(own.reshape(8, 4))
        return out

    def spread(per_row):  # (8, 2) -> (32, 1, 4)
        return per_row[quad][:, None, :].repeat_interleave(2, dim=-1)

    ps, dss = [], []
    for w in range(NQ // 16):
        rows16 = slice(16 * w, 16 * w + 16)
        logits = q[rows16].float() @ k.float().T
        dpm = d_o[rows16].float() @ v.float().T
        s = logits[row, key]
        s = torch.where(key >= NK, torch.full_like(s, float("-inf")), s)
        dp = dpm[row, key]
        m = quad_rows(s, lambda a: a.max(dim=1).values)
        p = torch.exp(s - spread(m))
        p = p / spread(quad_rows(p, lambda a: a.sum(dim=1)))
        rs = quad_rows(p * dp, lambda a: a.sum(dim=1))
        ds = p * (dp - spread(rs))
        ps.append(_rows_from_fragments(p.to(dtype)))
        dss.append(_rows_from_fragments(ds.to(dtype)))
    return torch.cat(ps), torch.cat(dss)


def cluster_attention_vjp(q, k, v, d_o, dtype=torch.bfloat16,
                          split: int = CLUSTER_SPLIT):
    """One window's attention VJP as K1b's C = 256 body splits it over the
    cluster: CTA r owns the channels :func:`cluster_columns` gives it. The
    logits and ``dP = dO v^T`` are sums of the CTAs' partials over their
    channels, taken in rank order; the CTA that owns 16 query rows forms
    their softmax and ``dS = P * (dP - rowsum(dP * P))`` over the 100 real
    keys in f32 and hands bf16 P and dS to all; ``dq = dS k``, ``dv = P^T dO``
    and ``dk = dS^T q`` are then local to a CTA's columns. Returns the f32
    ``(dq, dk, dv)`` (dq without the C^-0.5 the kernel applies at its
    store)."""
    cols = cluster_columns(q.shape[1], split)
    logits = torch.zeros(NQ, NKP)
    dp = torch.zeros(NQ, NKP)
    for r in range(split):
        logits = logits + q[:, cols[r]].float() @ k[:, cols[r]].float().T
        dp = dp + d_o[:, cols[r]].float() @ v[:, cols[r]].float().T
    p = torch.zeros(NQ, NKP)
    p[:, :NK] = torch.softmax(logits[:, :NK], dim=-1)
    ds = (p * (dp - (p * dp).sum(dim=-1, keepdim=True))).to(dtype).float()
    pb = p.to(dtype).float()
    dq, dk, dv = torch.zeros(NQ, q.shape[1]), torch.zeros_like(k.float()), \
        torch.zeros_like(v.float())
    for r in range(split):
        dq[:, cols[r]] = ds @ k[:, cols[r]].float()
        dk[:, cols[r]] = ds.T @ q[:, cols[r]].float()
        dv[:, cols[r]] = pb.T @ d_o[:, cols[r]].float()
    return dq, dk, dv


def window_branch_vjp(x, w_qkv, rel_h, rel_w, s, t, gout, *, x_add=None,
                      r: float = 0.5, levels: int = 0):
    """K1b as its kernels of base width 16 cut it, on tensors, rounding
    where they round. (a) Per 8x8 coarse query block the forward recompute
    of :func:`window_branch` up to P, ``dO = DWT^L(gout)``, then
    :func:`register_softmax_vjp` (at C = 256 :func:`cluster_attention_vjp`),
    ``dq = dS k * C^-0.5``, ``dk = dS^T q``, ``dv = P^T dO`` in f32 per window,
    and the window's rel-pos partials (ten slots a row / column in order).
    (b) Per block the gather through :func:`key_neighbours`, ``dqkv`` rounded,
    the block's ``dW`` partial ``zc^T dqkv`` and ``dzc = dqkv W^T`` (at C = 256
    by the base-channel quarters of :func:`cluster_output_columns`), the
    inverse transform, the residual and the affine's gradients with the
    block's shares of ds and dt. (c) :func:`tree_reduce_rows` over the
    partials. Returns what :func:`cftm_branch_plain_vjp` returns."""
    dt_ = x.dtype
    z = x.float() * s.float()[:, None, None, :] + t.float()[:, None, None, :]
    if x_add is not None:
        z = z + r * x_add.float()
    zc, d_o = z.to(dt_).float(), gout.to(dt_).float()
    for _ in range(levels):
        zc, d_o = haar_dwt(zc), haar_dwt(d_o)
    zc, d_o = zc.to(dt_), d_o.to(dt_)
    bsz, hc, wc, c = zc.shape
    nbh, nbw, c2 = hc // 8, wc // 8, c // 2
    nblk = nbh * nbw
    zp = torch.nn.functional.pad(zc, (0, 0, 1, 1, 1, 1))
    slots, slot_of = window_slots(), slot_of_window_position()
    rel = torch.cat([rel_h.float()[slots[:, 0]], rel_w.float()[slots[:, 1]]], dim=-1)
    wf = w_qkv.float()
    scale = c ** -0.5
    cluster = c == 256 and x.shape[-1] == 16
    dq = torch.zeros(bsz, nblk, NQ, c)
    dk, dv = torch.zeros(bsz, nblk, NKP, c), torch.zeros(bsz, nblk, NKP, c)
    drel_part = torch.zeros(bsz, nblk, 2, 10, c2)
    for b in range(bsz):
        for bi in range(nbh):
            for bj in range(nbw):
                win = bi * nbw + bj
                rows = torch.zeros(NKP, c, dtype=dt_)
                rows[:NK] = zp[b, 8 * bi + slots[:, 0], 8 * bj + slots[:, 1]]
                qkv = rows.float() @ wf
                q = (qkv[:NQ, :c] * scale).to(dt_)
                k = qkv[:, c:2 * c]
                k[:NK] = k[:NK] + rel
                k, v = k.to(dt_), qkv[:, 2 * c:].to(dt_)
                do_w = d_o[b, 8 * bi:8 * bi + 8, 8 * bj:8 * bj + 8].reshape(NQ, c)
                if cluster:
                    dqw, dkw, dvw = cluster_attention_vjp(q, k, v, do_w, dt_)
                else:
                    p, ds = register_softmax_vjp(q, k, v, do_w, dt_)
                    dqw = ds.float() @ k.float()
                    dkw = ds.float().T @ q.float()
                    dvw = p.float().T @ do_w.float()
                dq[b, win], dk[b, win], dv[b, win] = dqw * scale, dkw, dvw
                for u in range(10):  # ten slots a window row / column, in order
                    drel_part[b, win, 0] += dkw[slot_of[:, u], :c2]
                    drel_part[b, win, 1] += dkw[slot_of[u, :], c2:]
    nbrs = key_neighbours(nbh, nbw)
    quarters = (cluster_output_columns(16, levels) if cluster
                else torch.arange(c)[None])
    dzc = torch.zeros(bsz, hc, wc, c)
    dw_part = torch.zeros(bsz, nblk, c, 3 * c)
    for b in range(bsz):
        for (bi, bj), pixels in nbrs.items():
            win = bi * nbw + bj
            dqkv = torch.zeros(NQ, 3 * c)
            dqkv[:, :c] = dq[b, win]
            for p, found in enumerate(pixels):
                for wi, wj, slot in found:
                    dqkv[p, c:2 * c] += dk[b, wi * nbw + wj, slot]
                    dqkv[p, 2 * c:] += dv[b, wi * nbw + wj, slot]
            dqkv = dqkv.to(dt_).float()
            zb = zc[b, 8 * bi:8 * bi + 8, 8 * bj:8 * bj + 8].reshape(NQ, c).float()
            dzb = torch.zeros(NQ, c)
            for cols in quarters:  # a thread block each at C = 256
                dw_part[b, win, cols] = zb[:, cols].T @ dqkv
                dzb[:, cols] = dqkv @ wf[cols].T
            dzc[b, 8 * bi:8 * bi + 8, 8 * bj:8 * bj + 8] = dzb.reshape(8, 8, c)
    dz = dzc
    for _ in range(levels):
        dz = haar_iwt(dz)
    dz = dz + gout.to(dt_).float()
    dx = (dz * s.float()[:, None, None, :]).to(dt_)
    dx_add = None if x_add is None else (r * dz).to(x_add.dtype)
    f = 8 * 2 ** levels  # a block's side in full-resolution pixels

    def block_shares(v):  # (B, H, W, Cb) -> (B, blocks, Cb)
        cb = v.shape[-1]
        return v.reshape(bsz, nbh, f, nbw, f, cb).sum(dim=(2, 4)).reshape(bsz, nblk, cb)

    ds_ = torch.stack([tree_reduce_rows(m) for m in block_shares(dz * x.float())])
    dt_sum = torch.stack([tree_reduce_rows(m) for m in block_shares(dz)])
    dw = tree_reduce_rows(dw_part.reshape(bsz * nblk, c, 3 * c)).to(w_qkv.dtype)
    drel = tree_reduce_rows(drel_part.reshape(bsz * nblk, 2, 10, c2))
    return dx, dx_add, ds_, dt_sum, dw, drel[0], drel[1]


def _check(x, w_qkv, rel_h, rel_w, s, t, x_add, levels, block, halo):
    """Raise unless the operands are what K1, K1b and K1n (``s`` and ``t``
    None) take."""
    bsz, h, w, cb = x.shape
    c = cb * 4 ** levels
    sfull = 2 ** levels
    dev = x.device

    def need(cond, msg):
        if not cond:
            raise ValueError(f"cftm_branch kernel: {msg}")

    need(block == 8 and halo == 1, "only block=8, halo=1")
    need(levels in (0, 1, 2), f"levels must be 0, 1 or 2, got {levels}")
    need(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    need(h % (block * sfull) == 0 and w % (block * sfull) == 0,
         f"H, W must be multiples of {block * sfull}, got {h}x{w}")
    need(c % 16 == 0, f"C = Cb*4^L must be a multiple of 16, got {c}")
    need(x.stride(3) == 1 and x.stride(1) == w * x.stride(2)
         and x.stride(0) == h * x.stride(1),
         "x must be a channel slice of a contiguous NHWC tensor")
    need(w_qkv.shape == (c, 3 * c) and w_qkv.dtype == torch.bfloat16
         and w_qkv.is_contiguous(), f"w_qkv must be contiguous bf16 ({c}, {3 * c})")
    for name, rel in (("rel_h", rel_h), ("rel_w", rel_w)):
        need(rel.shape == (block + 2 * halo, c // 2) and rel.dtype == torch.float32
             and rel.is_contiguous(), f"{name} must be contiguous f32 (10, {c // 2})")
    tensors = [x, w_qkv, rel_h, rel_w]
    if s is not None:  # K1n has no affine
        for name, v in (("s", s), ("t", t)):
            need(v.shape == (bsz, cb) and v.dtype == torch.float32
                 and v.is_contiguous(), f"{name} must be contiguous f32 ({bsz}, {cb})")
        tensors += [s, t]
    if x_add is not None:
        need(x_add.shape == x.shape and x_add.dtype == torch.bfloat16
             and x_add.stride(3) == 1 and x_add.stride(1) == w * x_add.stride(2)
             and x_add.stride(0) == h * x_add.stride(1),
             "x_add must be a bf16 channel slice like x")
        tensors.append(x_add)
    need(all(v.device == dev for v in tensors), "all tensors on one device")
    if cb == 16:  # the bodies of base width 16 read x with vector loads
        for name, v in (("x", x), ("x_add", x_add)):
            need(v is None or (v.data_ptr() % 16 == 0 and v.stride(2) % 8 == 0),
                 f"{name} must be 16-byte aligned with a pixel stride that is "
                 "a multiple of 8")


def _launch(x, w_qkv, rel_h, rel_w, s, t, x_add, r, levels, block, halo):
    _check(x, w_qkv, rel_h, rel_w, s, t, x_add, levels, block, halo)
    bsz, h, w, cb = x.shape
    c = cb * 4 ** levels
    lib = build.lib()
    if lib.m2t_cftm_branch_smem(c) > build.MAX_SMEM:
        raise ValueError(f"cftm_branch kernel: C={c} needs more shared memory "
                         "than a block has")
    dev = x.device
    out = torch.empty((bsz, h, w, cb), dtype=x.dtype, device=dev)
    a = x_add if x_add is not None else x
    code = lib.m2t_cftm_branch(
        x.data_ptr(), x_add.data_ptr() if x_add is not None else None,
        s.data_ptr(), t.data_ptr(), w_qkv.data_ptr(), rel_h.data_ptr(),
        rel_w.data_ptr(), out.data_ptr(), bsz, h, w, cb, levels,
        x.stride(0), x.stride(1), x.stride(2),
        a.stride(0), a.stride(1), a.stride(2), float(r),
        build.stream_ptr(dev))
    build.check(code, "cftm_branch")
    cftm_branch.launches += 1
    return out


def cftm_branch_plain_vjp(x, w_qkv, rel_h, rel_w, s, t, gout, *,
                          x_add=None, r: float = 0.5, levels: int = 0,
                          block: int = 8, halo: int = 1):
    """Plain version of K1b: the gradients of :func:`cftm_branch_plain` by
    autograd, ``(dx, dx_add, ds, dt, dw_qkv, drel_h, drel_w)`` (dx_add None
    without x_add), each in its input's dtype."""
    ins = [v.detach().requires_grad_(True)
           for v in (x, w_qkv, rel_h, rel_w, s, t)]
    add = None if x_add is None else x_add.detach().requires_grad_(True)
    with torch.enable_grad():
        out = cftm_branch_plain(*ins, x_add=add, r=r, levels=levels,
                                block=block, halo=halo)
        grads = torch.autograd.grad(out, ins + ([add] if add is not None else []),
                                    gout)
    dx, dw, drh, drw, ds, dt = grads[:6]
    return dx, (grads[6] if add is not None else None), ds, dt, dw, drh, drw


_BWD_VARIANTS = ("general", "c256_cluster4", "w16_group", "w64_group")
_bwd_scratch = {}  # (device, nwin, c, cb) -> K1b's scratch tensors


def cftm_branch_bwd_variant(cb: int, levels: int) -> str:
    """Name of the body of ``csrc/cftm_branch_bwd.cu`` that K1b launches for
    base width ``cb`` at ``levels``, as the built library decides it."""
    return _BWD_VARIANTS[build.lib().m2t_cftm_branch_bwd_variant(cb, levels)]


def _scratch(dev, bsz: int, nblk: int, c: int, cb: int):
    """What passes between K1b's kernels: dq, dk, dv a window and the
    partials of dW, drel and ds | dt. Kept per (device, shape): the launches
    of a device go to one stream, so the next use is ordered after the last."""
    key = (str(dev), bsz, nblk, c, cb)
    if key not in _bwd_scratch:
        nwin = bsz * nblk

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        _bwd_scratch[key] = (f32(nwin, NQ, c), f32(nwin, NKP, c), f32(nwin, NKP, c),
                             f32(nwin, 2, 10, c // 2), f32(nwin, c, 3 * c),
                             f32(bsz, nblk, 2, cb))
    return _bwd_scratch[key]


def _bwd_launch(lib, x, w_qkv, rel_h, rel_w, s, t, gout, x_add, r, levels):
    """Allocate K1b's outputs, take its scratch and call
    ``m2t_cftm_branch_bwd`` of ``lib`` (the built library, or a timing
    variant of it): three launches. Returns ``(dx, dx_add, st, dw, drel)``:
    dx, dx_add and dw in bf16, ``st`` (B, 2, Cb) f32 holding ds and dt, ``drel``
    (2, 10, C/2) f32 holding drel_h and drel_w."""
    bsz, h, w, cb = x.shape
    c = cb * 4 ** levels
    sfull = 2 ** levels
    nblk = (h // (8 * sfull)) * (w // (8 * sfull))
    dev = x.device
    scratch = _scratch(dev, bsz, nblk, c, cb)
    dx = torch.empty((bsz, h, w, cb), dtype=torch.bfloat16, device=dev)
    dx_add = torch.empty_like(dx) if x_add is not None else None
    st = torch.empty((bsz, 2, cb), dtype=torch.float32, device=dev)
    dw = torch.empty((c, 3 * c), dtype=torch.bfloat16, device=dev)
    drel = torch.empty((2, 10, c // 2), dtype=torch.float32, device=dev)
    a = x_add if x_add is not None else x
    code = lib.m2t_cftm_branch_bwd(
        x.data_ptr(), x_add.data_ptr() if x_add is not None else None,
        s.data_ptr(), t.data_ptr(), w_qkv.data_ptr(), rel_h.data_ptr(),
        rel_w.data_ptr(), gout.data_ptr(), *(v.data_ptr() for v in scratch),
        dx.data_ptr(), dx_add.data_ptr() if dx_add is not None else None,
        dw.data_ptr(), drel.data_ptr(), st.data_ptr(),
        bsz, h, w, cb, levels, x.stride(0), x.stride(1), x.stride(2),
        a.stride(0), a.stride(1), a.stride(2), float(r), build.stream_ptr(dev))
    build.check(code, "cftm_branch_bwd")
    return dx, dx_add, st, dw, drel


def cftm_branch_bwd(x, w_qkv, rel_h, rel_w, s, t, gout, *, x_add=None,
                    r: float = 0.5, levels: int = 0):
    """Launch K1b on CUDA tensors (the operands :func:`_launch` takes, plus
    the output's cotangent ``gout``); returns ``(dx, dx_add, ds, dt, dw_qkv,
    drel_h, drel_w)`` in the inputs' dtypes, all written by the kernels (the
    affine's gradients are the epilogue of its second kernel, every partial
    sum goes through its one reduction)."""
    _check(x, w_qkv, rel_h, rel_w, s, t, x_add, levels, 8, 1)
    if gout.shape != x.shape or gout.device != x.device:
        raise ValueError(f"cftm_branch_bwd: gout {tuple(gout.shape)} on "
                         f"{gout.device} != x {tuple(x.shape)} on {x.device}")
    cb = x.shape[-1]
    lib = build.lib()
    for which in (0, 1):
        if lib.m2t_cftm_branch_bwd_smem(cb, levels, which) > build.MAX_SMEM:
            raise ValueError(f"cftm_branch_bwd kernel: C={cb * 4 ** levels} needs "
                             "more shared memory than a block has")
    gout = gout.to(torch.bfloat16).contiguous()
    dx, dx_add, st, dw, drel = _bwd_launch(lib, x, w_qkv, rel_h, rel_w, s, t, gout,
                                           x_add, r, levels)
    cftm_branch_bwd.launches += 1
    return dx, dx_add, st[:, 0], st[:, 1], dw, drel[0], drel[1]


cftm_branch_bwd.launches = 0  # K1b launch groups (2 kernels + 1 reduction)


class CftmBranchFn(torch.autograd.Function):
    """K1 forward, K1b backward. Saves only the inputs, as the JAX
    custom_vjp's fwd rule does; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, x_add, s, t, w_qkv, rel_h, rel_w, r, levels, block,
                halo):
        ctx.save_for_backward(x, x_add, s, t, w_qkv, rel_h, rel_w)
        ctx.r, ctx.levels = r, levels
        return _launch(x, w_qkv, rel_h, rel_w, s, t, x_add, r, levels, block,
                       halo)

    @staticmethod
    def backward(ctx, gout):
        x, x_add, s, t, w_qkv, rel_h, rel_w = ctx.saved_tensors
        dx, dx_add, ds, dt, dw, drh, drw = cftm_branch_bwd(
            x, w_qkv, rel_h, rel_w, s, t, gout, x_add=x_add, r=ctx.r,
            levels=ctx.levels)
        return dx, dx_add, ds, dt, dw, drh, drw, None, None, None, None


def cftm_branch(x: torch.Tensor, w_qkv: torch.Tensor, rel_h: torch.Tensor,
                rel_w: torch.Tensor, s: torch.Tensor, t: torch.Tensor, *,
                x_add: Optional[torch.Tensor] = None, r: float = 0.5,
                levels: int = 0, block: int = 8, halo: int = 1
                ) -> torch.Tensor:
    """K1 (see module docstring), differentiable. CUDA tensors launch the
    kernel (K1b in the backward), which takes bf16 x / x_add (channel
    slices of a contiguous NHWC tensor), bf16 w_qkv and f32 s, t, rel; CPU
    tensors run the plain version."""
    if x.device.type == "cuda":
        return CftmBranchFn.apply(x, x_add, s, t, w_qkv, rel_h, rel_w, r,
                                  levels, block, halo)
    if x.device.type == "cpu":
        return cftm_branch_plain(x, w_qkv, rel_h, rel_w, s, t, x_add=x_add,
                                 r=r, levels=levels, block=block, halo=halo)
    raise ValueError(f"cftm_branch: unsupported device {x.device}")


cftm_branch.launches = 0  # kernel launches, counted at each launch


def _launch_qkv(x, w_qkv, rel_h, rel_w, levels, block, halo):
    _check(x, w_qkv, rel_h, rel_w, None, None, None, levels, block, halo)
    bsz, h, w, cb = x.shape
    c = cb * 4 ** levels
    lib = build.lib()
    if lib.m2t_cftm_branch_smem(c) > build.MAX_SMEM:
        raise ValueError(f"halo_attention_qkv kernel: C={c} needs more shared "
                         "memory than a block has")
    out = torch.empty((bsz, h, w, cb), dtype=x.dtype, device=x.device)
    code = lib.m2t_halo_attn_qkv(
        x.data_ptr(), w_qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
        out.data_ptr(), bsz, h, w, cb, levels, x.stride(0), x.stride(1),
        x.stride(2), build.stream_ptr(x.device))
    build.check(code, "halo_attention_qkv")
    halo_attention_qkv.launches += 1
    return out


class HaloAttnQkvFn(torch.autograd.Function):
    """K1n forward; the backward is the plain version's VJP, as the TPU
    kernel's custom_vjp differentiates its XLA composition."""

    @staticmethod
    def forward(ctx, x, w_qkv, rel_h, rel_w, levels, block, halo):
        ctx.save_for_backward(x, w_qkv, rel_h, rel_w)
        ctx.cfg = (levels, block, halo)
        return _launch_qkv(x, w_qkv, rel_h, rel_w, levels, block, halo)

    @staticmethod
    def backward(ctx, gout):
        ins = [v.detach().requires_grad_(True) for v in ctx.saved_tensors]
        levels, block, halo = ctx.cfg
        with torch.enable_grad():
            out = halo_attention_qkv_plain(*ins, levels=levels, block=block,
                                           halo=halo)
        return (*torch.autograd.grad(out, ins, gout.to(out.dtype)),
                None, None, None)


def halo_attention_qkv(x: torch.Tensor, w_qkv: torch.Tensor,
                       rel_h: torch.Tensor, rel_w: torch.Tensor, *,
                       levels: int = 0, block: int = 8, halo: int = 1
                       ) -> torch.Tensor:
    """K1n, the bare wavelet branch ``IWT^L(attn(qkv(DWT^L(x))))``,
    differentiable. CUDA tensors launch the kernel (bf16 x, a channel slice
    of a contiguous NHWC tensor, bf16 w_qkv, f32 rel); CPU tensors run the
    plain version."""
    if x.device.type == "cuda":
        return HaloAttnQkvFn.apply(x, w_qkv, rel_h, rel_w, levels, block, halo)
    if x.device.type == "cpu":
        return halo_attention_qkv_plain(x, w_qkv, rel_h, rel_w, levels=levels,
                                        block=block, halo=halo)
    raise ValueError(f"halo_attention_qkv: unsupported device {x.device}")


halo_attention_qkv.launches = 0  # kernel launches, counted at each launch
