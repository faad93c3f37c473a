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


def tail_band_bwd(y, w0, b0, w1, b1, w3, lc, rc, top, bot, g, *, scale: int,
                  rgb_range: float):
    """Launch K2b on CUDA tensors (K2's operands and the cotangent ``g``
    of its output); returns the gradients of the ten operands in their
    dtypes."""
    _check(y, w0, b0, w1, b1, w3, lc, rc, top, bot, scale)
    bsz, h, w, nf = y.shape
    P = scale * scale
    cp, cp0 = P * nf, (4 * nf if scale == 4 else P * nf)
    if tuple(g.shape) != (bsz, h, w, P * 3) or g.device != y.device:
        raise ValueError(f"tail_band_bwd: g {tuple(g.shape)} on {g.device} != "
                         f"{(bsz, h, w, P * 3)} on {y.device}")
    g = g.to(y.dtype).contiguous()
    lib = build.lib()
    if lib.m2t_tail_band_bwd_smem(nf, 1) > build.MAX_SMEM:
        raise ValueError(f"tail_band_bwd kernel: n_feats={nf} needs more "
                         "shared memory than a block has")
    dev = y.device
    tiles = bsz * (-(-h // 4)) * (-(-w // 16))

    def f32(*shape, zero=False):
        make = torch.zeros if zero else torch.empty
        return make(shape, dtype=torch.float32, device=dev)

    gm, dy = f32(bsz, h, w, P * 3), f32(bsz, h, w, nf)
    part0, part3 = f32(tiles, nf * cp0 + cp0), f32(tiles, 27 * nf)
    part1 = f32(tiles * 4, nf * 4 * nf + 4 * nf) if scale == 4 else f32(1)
    dw0b0, dw1b1 = f32(nf * cp0 + cp0), f32(nf * 4 * nf + 4 * nf)
    dw3 = f32(3, 3, nf, 3)
    dlc, drc = f32(bsz, h + 2, cp, zero=True), f32(bsz, h + 2, cp, zero=True)
    dtop, dbot = f32(bsz, w + 2, cp), f32(bsz, w + 2, cp)
    code = lib.m2t_tail_band_bwd(
        y.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w3.data_ptr(), lc.data_ptr(), rc.data_ptr(),
        top.data_ptr(), bot.data_ptr(), g.data_ptr(), gm.data_ptr(),
        part0.data_ptr(), part1.data_ptr(), part3.data_ptr(), dy.data_ptr(),
        dw0b0.data_ptr(), dw1b1.data_ptr(), dw3.data_ptr(), dlc.data_ptr(),
        drc.data_ptr(), dtop.data_ptr(), dbot.data_ptr(), bsz, h, w, nf,
        scale, float(rgb_range), build.stream_ptr(dev))
    build.check(code, "tail_band_bwd")
    tail_band_bwd.launches += 1
    dw0, db0 = dw0b0[:nf * cp0].view(nf, cp0), dw0b0[nf * cp0:]
    if scale == 4:
        dw1, db1 = dw1b1[:nf * 4 * nf].view(nf, 4 * nf), dw1b1[nf * 4 * nf:]
    else:  # w1/b1 repeat w0/b0 and are not read at x2/x3
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
