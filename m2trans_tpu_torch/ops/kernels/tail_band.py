"""K2, the fused phase-plane upsampling tail: wrapper, launch count and
plain version.

Replaces the TPU kernel m2trans_tpu/ops/pallas/tail_band.py ``_kernel``
(launched by ``tail_band_fused``, entered through ``tail_band_apply``).
The kernel, ``csrc/tail_band.cu``, computes the stage products, exact GELU,
the 3x3 phase-space conv with the HR reflect ring spliced in, and the
clamp: a persistent grid of one block an SM walks 8x16 LR tiles
(:func:`tail_tile_walk`), the weights staged in shared memory once per
block, each warp taking 16 halo pixels through both stages in registers
(``mma.sync``), and the phase conv contracted first and gathered after
(:func:`phase_conv_contract_gather` states that arithmetic on tensors, and
:func:`tail_band_contract_gather` the whole kernel's); its header says what
bounds it on the card and how the design answers that. The weight prep
(``stage_weights``),
the 1-px reflect-ring slices (``phase_edges``) and the final depth-to-space
stay plain torch, as they stayed XLA around the TPU kernel.

K2b, its VJP (``csrc/tail_band_bwd.cu``), replaces the four TPU kernels of
``tail_band_bwd_fused`` (``_bwd_recompute_kernel``, ``_bwd_dk_kernel``,
``_bwd_dph_kernel``, ``_bwd_stage_kernel``); its clip mask comes from K2's
own kernel run with the cotangent, so the two agree bit for bit.
:class:`TailBandFn` ties the
two together for autograd: K2 forward, K2b backward, which returns the
gradients of K2's ten operands; autograd carries them on through the plain
``stage_weights``, ``last_conv_weight`` and ``phase_edges`` (the JAX
backward's ``wvjp``/``evjp``).

:func:`tail_band_fused` launches the kernels for CUDA tensors and runs
:func:`tail_band_plain` (differentiated by autograd) for CPU tensors only;
anything else raises. :func:`tail_band_plain_vjp` is K2b's plain version.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from m2trans_tpu_torch.ops.conv import gelu_exact
from m2trans_tpu_torch.ops.kernels import build
from m2trans_tpu_torch.ops.pixel_shuffle import pixel_shuffle_fast
from m2trans_tpu_torch.ops.tail_phase import (
    _phase_layout,
    expand_phase_kernel,
    last_conv_weight,
    phase_edges,
    stage_weights,
)


TILE = (8, 16)  # LR rows, columns of one step of K2's walk (csrc/tail_band.cu)


def _phase_band(y, w0, b0, w1, b1, lc, rc, top, bot, scale):
    """The (B, H+2, W+2, P*nf) phase band with the reflect ring spliced in,
    rounded to y's dtype where K2 rounds (h before stage 1, the band before
    the conv)."""
    dt = y.dtype
    bsz, h, w, nf = y.shape
    h0 = gelu_exact(y.float() @ w0.float() + b0.float())
    if scale == 4:
        og = h0.to(dt).reshape(-1, nf).float() @ w1.float() + b1.float()
        ph = gelu_exact(og).reshape(bsz, h, w, 16 * nf)
    else:
        ph = h0
    ph = F.pad(ph, (0, 0, 1, 1, 1, 1))
    ph[:, 1:h + 1, 0] = lc[:, 1:h + 1]
    ph[:, 1:h + 1, w + 1] = rc[:, 1:h + 1]
    ph[:, 0] = top
    ph[:, h + 1] = bot
    return ph.to(dt)


def tail_band_plain(y, w0, b0, w1, b1, w3, lc, rc, top, bot, *, scale: int,
                    rgb_range: float) -> torch.Tensor:
    """Plain PyTorch version of K2, rounding where the kernel rounds.

    y: (B, H, W, nf); w0/b0, w1/b1: ps-permuted stage weights (I, O)/(O,);
    w3: HWIO (3, 3, nf, 3); lc, rc: (B, H+2, P*nf) f32 pad columns by
    padded row; top, bot: (B, W+2, P*nf) f32 pad rows. Returns the clamped
    (B, H, W, P*3) phase planes in y's dtype."""
    dt = y.dtype
    ph = _phase_band(y, w0, b0, w1, b1, lc, rc, top, bot, scale)
    K = expand_phase_kernel(w3, scale).float()
    out = F.conv2d(ph.float().permute(0, 3, 1, 2), K.permute(3, 2, 0, 1))
    return out.clamp(0.0, rgb_range).to(dt).permute(0, 2, 3, 1).contiguous()


def tail_tile_walk(h: int, w: int, tile=TILE):
    """The LR tiles K2's persistent grid walks over one (h, w) frame, in its
    order: ``(r0, c0, rows, cols)``, rows and cols cut at the frame."""
    th, tw = tile
    return [(r0, c0, min(th, h - r0), min(tw, w - c0))
            for r0 in range(0, h, th) for c0 in range(0, w, tw)]


def halo_slots(tile=TILE):
    """The order in which K2 keeps the (rows+2) x (cols+2) halo pixels of a
    tile, as (row, column) in the halo: the tile's own pixels row-major, then
    the ring by kind: top row, bottom row, left column, right column, the
    four corners. (K2 pads them to 12 row tiles of 16.)"""
    th, tw = tile
    return ([(1 + r, 1 + c) for r in range(th) for c in range(tw)]
            + [(0, 1 + c) for c in range(tw)] + [(th + 1, 1 + c) for c in range(tw)]
            + [(1 + r, 0) for r in range(th)] + [(1 + r, tw + 1) for r in range(th)]
            + [(r, c) for r in (0, th + 1) for c in (0, tw + 1)])


def halo_needed_blocks(scale: int, tile=TILE):
    """For every slot of :func:`halo_slots` the set of phase blocks that some
    output pixel of the tile reads from it: all of a tile pixel's, of a ring
    pixel only the blocks whose phase row / column faces the tile. K2 skips
    the rest (products and GELU)."""
    th, tw = tile
    s, lay = scale, _phase_layout(scale)
    out = []
    for hy, hx in halo_slots(tile):
        rows = range(s) if 1 <= hy <= th else ([s - 1] if hy == 0 else [0])
        cols = range(s) if 1 <= hx <= tw else ([s - 1] if hx == 0 else [0])
        out.append({int(lay[pi, pj]) for pi in rows for pj in cols})
    return out


def phase_tap_table(scale: int):
    """For every output phase q = i*s + j the nine terms of its 3x3 HR conv
    in K2's order of summation (group of 4 source blocks, then tap):
    ``(tap, block, yo, xo)``: tap ``(dr+1)*3 + dc+1`` reads phase block
    ``block`` of the LR neighbour at offset (yo, xo)."""
    s, lay = scale, _phase_layout(scale)
    table = []
    for q in range(s * s):
        i, j = divmod(q, s)
        terms = []
        for tap in range(9):
            ii, jj = i + tap // 3 - 1, j + tap % 3 - 1
            terms.append((tap, int(lay[ii % s, jj % s]), ii // s, jj // s))
        table.append(sorted(terms, key=lambda t: (t[1] // 4, t[0])))
    return table


def phase_conv_contract_gather(ph: torch.Tensor, w3: torch.Tensor,
                               scale: int) -> torch.Tensor:
    """The 3x3 phase-space conv as K2 computes it. ``ph``: a (..., R+2, S+2,
    P*nf) band with its 1-px ring; contract first, ``T[pix, blk, tap, c] =
    ph[pix, blk, :] . w3[tap, :, c]`` in f32 (one dense product per phase
    block), then every output phase gathers its nine T values of the
    neighbouring pixels in the order of :func:`phase_tap_table`. Returns
    the f32 (..., R, S, P*3) pre-clamp outputs."""
    P, nf = scale * scale, w3.shape[2]
    r, c = ph.shape[-3] - 2, ph.shape[-2] - 2
    blocks = ph.float().reshape(*ph.shape[:-1], P, nf)
    T = torch.einsum("...pc,tcd->...ptd", blocks, w3.float().reshape(9, nf, 3))
    out = []
    for terms in phase_tap_table(scale):
        acc = torch.zeros(*ph.shape[:-3], r, c, 3)
        for tap, blk, yo, xo in terms:
            acc = acc + T[..., 1 + yo:1 + yo + r, 1 + xo:1 + xo + c, blk, tap, :]
        out.append(acc)
    return torch.stack(out, dim=-2).reshape(*ph.shape[:-3], r, c, P * 3)


def tail_band_contract_gather(y, w0, b0, w1, b1, w3, lc, rc, top, bot, *,
                              scale: int, rgb_range: float,
                              tile=TILE) -> torch.Tensor:
    """K2 as its kernel cuts it, on tensors: per tile of
    :func:`tail_tile_walk` the halo of the phase band (ring on the frame
    border, zero beyond it), the contraction with w3 and the gather, the
    clamp; pixels beyond the frame are dropped."""
    bsz, h, w, _ = y.shape
    ph = _phase_band(y, w0, b0, w1, b1, lc, rc, top, bot, scale)
    th, tw = tile
    ph = F.pad(ph, (0, 0, 0, tw, 0, th))  # room for the last tiles' halos
    out = torch.empty(bsz, h, w, scale * scale * 3, dtype=y.dtype)
    nf, P = y.shape[-1], scale * scale
    live = torch.zeros(th + 2, tw + 2, P, 1, dtype=torch.bool)
    for (hy, hx), blocks in zip(halo_slots(tile), halo_needed_blocks(scale, tile)):
        live[hy, hx, sorted(blocks)] = True
    for r0, c0, rows, cols in tail_tile_walk(h, w, tile):
        halo = ph[:, r0:r0 + th + 2, c0:c0 + tw + 2]
        # blocks no output of the tile reads are never computed: NaN them to
        # show that the gather leaves them alone
        halo = torch.where(live, halo.reshape(bsz, th + 2, tw + 2, P, nf),
                           torch.full((), float("nan"), dtype=halo.dtype)
                           ).reshape(halo.shape)
        o = phase_conv_contract_gather(halo, w3, scale)[:, :rows, :cols]
        out[:, r0:r0 + rows, c0:c0 + cols] = o.clamp(0.0, rgb_range).to(y.dtype)
    return out


# K2b's second pass (csrc/tail_band_bwd.cu) gives every thread block a role,
# one phase block, and turns the 3x3 phase conv's adjoint into two dense
# products through a gathered matrix GT. The functions below state that
# arithmetic on tensors.


def phase_tap_adjoint_table(scale: int):
    """For every source phase block the nine ``(tap, q, yo, xo)`` that read
    it: tap ``(dr+1)*3 + dc+1`` of output phase q of the LR pixel at offset
    ``-(yo, xo)`` from the source. Every tap of a block is read by exactly
    one output phase of one neighbour: the transpose of
    :func:`phase_tap_table`."""
    P = scale * scale
    table = [[None] * 9 for _ in range(P)]
    for q, terms in enumerate(phase_tap_table(scale)):
        for tap, blk, yo, xo in terms:
            assert table[blk][tap] is None
            table[blk][tap] = (tap, q, yo, xo)
    return table


def gathered_cotangent(gm: torch.Tensor, scale: int, blk: int) -> torch.Tensor:
    """``GT`` of phase block ``blk`` for every pixel of the band. ``gm``: the
    clip-masked cotangent (B, H, W, P*3). Returns (B, H+2, W+2, 27) with
    ``GT[s, tap*3 + c] = gm[s - (yo, xo), q, c]`` over the band's pixels s
    (the frame and its 1-px ring), zero where the reading output pixel is
    off the frame."""
    bsz, h, w, _ = gm.shape
    pad = F.pad(gm.float(), (0, 0, 2, 2, 2, 2))  # band pixel s -> pad[s + 1]
    cols = []
    for tap, q, yo, xo in phase_tap_adjoint_table(scale)[blk]:
        cols.append(pad[:, 1 - yo:1 - yo + h + 2, 1 - xo:1 - xo + w + 2,
                        3 * q:3 * q + 3])
    return torch.cat(cols, dim=-1)


def phase_conv_adjoint_taps(ph: torch.Tensor, gm: torch.Tensor,
                            w3: torch.Tensor, scale: int):
    """The adjoint of the 3x3 phase-space conv as K2b computes it: per phase
    block two dense products through :func:`gathered_cotangent`,
    ``d(ph)[s, blk, :] = GT[s] w3^T`` and ``dw3 += ph[s, blk, :]^T GT[s]``.
    ``ph``: the (B, H+2, W+2, P*nf) band with its ring; returns the f32
    ``(d(ph), dw3)`` of the band's and of w3's shapes."""
    P, nf = scale * scale, w3.shape[2]
    w27 = w3.float().permute(0, 1, 3, 2).reshape(27, nf)  # [tap*3 + c, ch]
    dph = torch.zeros(ph.shape, dtype=torch.float32)
    dw3 = torch.zeros(27, nf)
    for blk in range(P):
        gt = gathered_cotangent(gm, scale, blk)
        dph[..., blk * nf:(blk + 1) * nf] = gt @ w27
        dw3 = dw3 + torch.einsum("bhwk,bhwc->kc", gt,
                                 ph[..., blk * nf:(blk + 1) * nf].float())
    return dph, dw3.reshape(3, 3, 3, nf).permute(0, 1, 3, 2).contiguous()


def _gelu_grad(v: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1 + torch.erf(v * 2 ** -0.5)) + \
        v * torch.exp(-0.5 * v * v) * (2 * torch.pi) ** -0.5


def tail_band_vjp_by_roles(y, w0, b0, w1, b1, w3, lc, rc, top, bot, g, *,
                           scale: int, rgb_range: float):
    """K2b as its kernels cut it, on tensors, rounding where they round. Pass
    0: K2's pre-clamp outputs (:func:`phase_conv_contract_gather`) give the
    clip mask. Pass 1, one role a phase block blk (x4: stage-0 group blk // 4,
    stage-1 block blk % 4): :func:`gathered_cotangent`, ``d(ph) = GT w3^T``
    (a ring pixel's is its edge gradient), ``dw3 += ph^T GT``, then d(last
    pre-activation) = bf16(d(ph) gelu'), the stage transposes with
    ``d(pre0)`` in bf16, the role's share of ``dw | db`` of each stage and
    its plane of dy. The planes are summed by
    :func:`~m2trans_tpu_torch.ops.kernels.halo_attn.tree_reduce_rows`.
    Returns what :func:`tail_band_plain_vjp` returns."""
    from m2trans_tpu_torch.ops.kernels.halo_attn import tree_reduce_rows

    dt = y.dtype
    bsz, h, w, nf = y.shape
    P = scale * scale
    band = _phase_band(y, w0, b0, w1, b1, lc, rc, top, bot, scale)
    pre = phase_conv_contract_gather(band, w3, scale)
    gm = torch.where((pre >= 0) & (pre <= rgb_range), g.to(dt).float(),
                     torch.zeros(()))
    yf = y.float()
    dw0, db0 = torch.zeros(w0.shape), torch.zeros(b0.shape)
    dw1, db1 = torch.zeros(w1.shape), torch.zeros(b1.shape)
    dw3 = torch.zeros(27, nf)
    w27 = w3.float().permute(0, 1, 3, 2).reshape(27, nf)
    dband = torch.zeros(band.shape, dtype=torch.float32)
    planes = []
    for blk in range(P):
        cols = slice(blk * nf, (blk + 1) * nf)
        gt = gathered_cotangent(gm, scale, blk)
        dph = gt @ w27
        dband[..., cols] = dph
        dw3 = dw3 + torch.einsum("bhwk,bhwc->kc", gt, band[..., cols].float())
        dph = dph[:, 1:h + 1, 1:w + 1]  # interior pixels go down the stages
        if scale == 4:
            gcols = slice((blk // 4) * nf, (blk // 4 + 1) * nf)
            jcols = slice((blk % 4) * nf, (blk % 4 + 1) * nf)
            pre0 = yf @ w0.float()[:, gcols] + b0.float()[gcols]
            hg = gelu_exact(pre0).to(dt).float()
            og = hg @ w1.float()[:, jcols] + b1.float()[jcols]
            dog = (dph * _gelu_grad(og)).to(dt).float()
            dw1[:, jcols] += torch.einsum("bhwi,bhwo->io", hg, dog)
            db1[jcols] += dog.sum(dim=(0, 1, 2))
            dpre = ((dog @ w1.float()[:, jcols].T) * _gelu_grad(pre0)).to(dt).float()
        else:
            gcols = cols
            pre0 = yf @ w0.float()[:, gcols] + b0.float()[gcols]
            dpre = (dph * _gelu_grad(pre0)).to(dt).float()
        dw0[:, gcols] += torch.einsum("bhwi,bhwo->io", yf, dpre)
        db0[gcols] += dpre.sum(dim=(0, 1, 2))
        planes.append(dpre @ w0.float()[:, gcols].T)
    dy = tree_reduce_rows(torch.stack(planes))
    dlc, drc = torch.zeros(lc.shape), torch.zeros(rc.shape)
    dlc[:, 1:h + 1], drc[:, 1:h + 1] = dband[:, 1:h + 1, 0], dband[:, 1:h + 1, w + 1]
    dtop, dbot = dband[:, 0].clone(), dband[:, h + 1].clone()
    dw3 = dw3.reshape(3, 3, 3, nf).permute(0, 1, 3, 2)
    return (dy.to(dt), dw0.to(dt), db0.to(dt), dw1.to(dt), db1.to(dt),
            dw3.contiguous().to(dt), dlc, drc, dtop, dbot)


def _check(y, w0, b0, w1, b1, w3, lc, rc, top, bot, scale):
    """Raise unless the operands are what K2 and K2b take."""
    bsz, h, w, nf = y.shape
    cp = scale * scale * nf
    cp0 = 4 * nf if scale == 4 else cp

    def need(cond, msg):
        if not cond:
            raise ValueError(f"tail_band kernel: {msg}")

    need(scale in (2, 3, 4), f"scale must be 2, 3 or 4, got {scale}")
    need(nf % 16 == 0 and 16 <= nf <= 64,
         f"n_feats must be a multiple of 16, at most 64, got {nf}")
    shapes = {"y": (y, (bsz, h, w, nf), torch.bfloat16),
              "w0": (w0, (nf, cp0), torch.bfloat16),
              "b0": (b0, (cp0,), torch.bfloat16),
              "w1": (w1, (nf, 4 * nf) if scale == 4 else (nf, cp0), torch.bfloat16),
              "b1": (b1, (4 * nf,) if scale == 4 else (cp0,), torch.bfloat16),
              "w3": (w3, (3, 3, nf, 3), torch.bfloat16),
              "lc": (lc, (bsz, h + 2, cp), torch.float32),
              "rc": (rc, (bsz, h + 2, cp), torch.float32),
              "top": (top, (bsz, w + 2, cp), torch.float32),
              "bot": (bot, (bsz, w + 2, cp), torch.float32)}
    for name, (v, shp, dt) in shapes.items():
        need(tuple(v.shape) == shp and v.dtype == dt and v.is_contiguous()
             and v.device == y.device,
             f"{name} must be contiguous {dt} {shp} on {y.device}, got "
             f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _launch(y, w0, b0, w1, b1, w3, lc, rc, top, bot, scale, rgb_range):
    _check(y, w0, b0, w1, b1, w3, lc, rc, top, bot, scale)
    bsz, h, w, nf = y.shape
    lib = build.lib()
    if lib.m2t_tail_band_smem(nf, scale) > build.MAX_SMEM:
        raise ValueError(f"tail_band kernel: n_feats={nf} at x{scale} needs "
                         "more shared memory than a block has")
    out = torch.empty((bsz, h, w, scale * scale * 3), dtype=y.dtype,
                      device=y.device)
    code = lib.m2t_tail_band(
        y.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w3.data_ptr(), lc.data_ptr(), rc.data_ptr(),
        top.data_ptr(), bot.data_ptr(), out.data_ptr(), bsz, h, w, nf, scale,
        float(rgb_range), build.stream_ptr(y.device))
    build.check(code, "tail_band")
    tail_band_fused.launches += 1
    return out


def tail_band_plain_vjp(y, w0, b0, w1, b1, w3, lc, rc, top, bot, g, *,
                        scale: int, rgb_range: float):
    """Plain version of K2b: the gradients of :func:`tail_band_plain` with
    respect to its ten operands by autograd, for the cotangent ``g`` of
    its (B, H, W, P*3) output."""
    ins = [v.detach().requires_grad_(True)
           for v in (y, w0, b0, w1, b1, w3, lc, rc, top, bot)]
    with torch.enable_grad():
        out = tail_band_plain(*ins, scale=scale, rgb_range=rgb_range)
        grads = torch.autograd.grad(out, ins, g, allow_unused=True)
    # w1/b1 repeat w0/b0 and are not read at x2/x3
    return tuple(torch.zeros_like(v) if d is None else d
                 for v, d in zip(ins, grads))


def _bwd_launch(lib, y, w0, b0, w1, b1, w3, lc, rc, top, bot, g, scale,
                rgb_range):
    """Allocate K2b's outputs and scratch and call
    ``m2t_tail_band_bwd`` of ``lib`` (the built library, or a timing variant
    of it). Returns the f32 ``(dy, outA, outB, dw3, dlc, drc, dtop, dbot)``:
    ``outA`` the last stage's ``dw | db`` by phase block (x4: by stage-1 block
    j, (4, nf+1, nf); else by stage-0 block, (P, nf+1, nf)), ``outB`` (x4)
    stage 0's by group (4, nf+1, nf); row nf of each is the bias gradient."""
    bsz, h, w, nf = y.shape
    P = scale * scale
    cp = P * nf
    dev = y.device
    npr = lib.m2t_tail_band_bwd_blocks(scale)
    if npr < 1:
        raise RuntimeError(f"tail_band_bwd: CUDA error {-npr}")
    na = 4 if scale == 4 else P

    def f32(*shape, zero=False):
        make = torch.zeros if zero else torch.empty
        return make(shape, dtype=torch.float32, device=dev)

    gm, part_a = f32(bsz, h, w, P * 3), f32(na, P * npr // na, nf + 1, nf)
    part_b = f32(4, 4 * npr, nf + 1, nf) if scale == 4 else f32(1)
    part3, dy_part = f32(P * npr, 27 * nf), f32(P, bsz, h, w, nf)
    dy, dw3 = f32(bsz, h, w, nf), f32(3, 3, nf, 3)
    out_a, out_b = f32(na, nf + 1, nf), f32(4, nf + 1, nf)
    dlc, drc = f32(bsz, h + 2, cp, zero=True), f32(bsz, h + 2, cp, zero=True)
    dtop, dbot = f32(bsz, w + 2, cp), f32(bsz, w + 2, cp)
    code = lib.m2t_tail_band_bwd(
        y.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w3.data_ptr(), lc.data_ptr(), rc.data_ptr(),
        top.data_ptr(), bot.data_ptr(), g.data_ptr(), gm.data_ptr(),
        part_a.data_ptr(), part_b.data_ptr(), part3.data_ptr(),
        dy_part.data_ptr(), dy.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
        dw3.data_ptr(), dlc.data_ptr(), drc.data_ptr(), dtop.data_ptr(),
        dbot.data_ptr(), bsz, h, w, nf, scale, float(rgb_range),
        build.stream_ptr(dev))
    build.check(code, "tail_band_bwd")
    return dy, out_a, out_b, dw3, dlc, drc, dtop, dbot


def _stage_grads(out: torch.Tensor):
    """(blocks, nf+1, nf) block-wise ``dw | db`` -> ``dw`` (nf, blocks*nf) and
    ``db`` (blocks*nf,), the layout of the permuted stage weights."""
    nb, nf1, nf = out.shape
    return (out[:, :nf].permute(1, 0, 2).reshape(nf, nb * nf),
            out[:, nf].reshape(nb * nf))


def tail_band_bwd(y, w0, b0, w1, b1, w3, lc, rc, top, bot, g, *, scale: int,
                  rgb_range: float):
    """Launch K2b on CUDA tensors (K2's operands and the cotangent ``g``
    of its output); returns the gradients of the ten operands in their
    dtypes."""
    _check(y, w0, b0, w1, b1, w3, lc, rc, top, bot, scale)
    bsz, h, w, nf = y.shape
    P = scale * scale
    if tuple(g.shape) != (bsz, h, w, P * 3) or g.device != y.device:
        raise ValueError(f"tail_band_bwd: g {tuple(g.shape)} on {g.device} != "
                         f"{(bsz, h, w, P * 3)} on {y.device}")
    g = g.to(y.dtype).contiguous()
    lib = build.lib()
    if lib.m2t_tail_band_bwd_smem(nf, 1) > build.MAX_SMEM:
        raise ValueError(f"tail_band_bwd kernel: n_feats={nf} needs more "
                         "shared memory than a block has")
    grads = _bwd_launch(lib, y, w0, b0, w1, b1, w3, lc, rc, top, bot, g, scale,
                        rgb_range)
    tail_band_bwd.launches += 1
    dy, out_a, out_b, dw3, dlc, drc, dtop, dbot = grads
    if scale == 4:
        (dw0, db0), (dw1, db1) = _stage_grads(out_b), _stage_grads(out_a)
    else:  # w1/b1 repeat w0/b0 and are not read at x2/x3
        dw0, db0 = _stage_grads(out_a)
        dw1, db1 = torch.zeros_like(w1), torch.zeros_like(b1)
    grads = (dy, dw0, db0, dw1, db1, dw3)
    ops = (y, w0, b0, w1, b1, w3)
    return (*(gr.to(op.dtype) for gr, op in zip(grads, ops)), dlc, drc, dtop,
            dbot)


tail_band_bwd.launches = 0  # K2b launch groups (2 passes + reductions)


class TailBandFn(torch.autograd.Function):
    """K2 forward, K2b backward; saves only the operands."""

    @staticmethod
    def forward(ctx, y, w0, b0, w1, b1, w3, lc, rc, top, bot, scale,
                rgb_range):
        ctx.save_for_backward(y, w0, b0, w1, b1, w3, lc, rc, top, bot)
        ctx.scale, ctx.rgb_range = scale, rgb_range
        return _launch(y, w0, b0, w1, b1, w3, lc, rc, top, bot, scale,
                       rgb_range)

    @staticmethod
    def backward(ctx, g):
        grads = tail_band_bwd(*ctx.saved_tensors, g, scale=ctx.scale,
                              rgb_range=ctx.rgb_range)
        return (*grads, None, None)


def tail_band_fused(y, w0, b0, w1, b1, w3, lc, rc, top, bot, *, scale: int,
                    rgb_range: float) -> torch.Tensor:
    """K2 on prepared operands (see :func:`tail_band_plain` for shapes),
    differentiable. CUDA tensors launch the kernel (bf16 y and weights, f32
    edges; K2b in the backward); CPU tensors run the plain version."""
    if y.device.type == "cuda":
        return TailBandFn.apply(y, w0, b0, w1, b1, w3, lc, rc, top, bot,
                                scale, rgb_range)
    if y.device.type == "cpu":
        return tail_band_plain(y, w0, b0, w1, b1, w3, lc, rc, top, bot,
                               scale=scale, rgb_range=rgb_range)
    raise ValueError(f"tail_band: unsupported device {y.device}")


tail_band_fused.launches = 0  # kernel launches, counted at each launch


def tail_band_operands(p: Dict[str, Any], x: torch.Tensor, *, scale: int,
                       dtype=torch.bfloat16):
    """Plain-torch prep around the kernel: the stage weights, the HWIO 3x3
    weight and the reflect-ring slices, in the layouts K2 takes."""
    w0, b0, w1, b1 = stage_weights(p, scale=scale, dtype=dtype)
    x = x.to(dtype)
    lc, rc, top, bot = phase_edges(p, x, scale=scale, dtype=dtype)
    w3 = last_conv_weight(p, scale).to(dtype).contiguous()
    return (x.contiguous(), w0.contiguous(), b0.contiguous(), w1.contiguous(),
            b1.contiguous(), w3, lc[:, :, 0].contiguous(),
            rc[:, :, 0].contiguous(), top[:, 0].contiguous(),
            bot[:, 0].contiguous())


def tail_band_apply(p: Dict[str, Any], x: torch.Tensor, *, scale: int,
                    rgb_range: float, dtype=torch.bfloat16,
                    use_kernel: bool = True) -> torch.Tensor:
    """Full phase-plane tail: (B, H, W, nf) -> (B, H*s, W*s, 3), clamped to
    [0, rgb_range]. Mirrors the JAX ``tail_band_apply``; ``use_kernel``
    False runs :func:`tail_band_plain` on any device."""
    ops = tail_band_operands(p, x, scale=scale, dtype=dtype)
    fn = tail_band_fused if use_kernel else tail_band_plain
    return pixel_shuffle_fast(fn(*ops, scale=scale, rgb_range=rgb_range), scale)
