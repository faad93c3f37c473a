"""Phase-plane upsampling tail, plain PyTorch; port of
m2trans_tpu/ops/tail_phase.py.

The reference tail (1x1 conv -> PixelShuffle -> GELU stage(s), then a 3x3
reflect conv to RGB) is computed in LR space. The HR image is held as s*s
LR-grid phase planes (HR[s*y+i, s*x+j] = plane (i, j) at LR pixel (y, x)):
each 1x1 stage is a per-pixel matmul whose output channels are phase
planes, and the 3x3 HR conv becomes a 3x3 LR-grid conv over the
(s*s*nf)-channel phase tensor with a block-sparse kernel K: output phase
(i, j), tap (dr, dc) reads source phase ((i+dr)%s, (j+dc)%s) at LR offset
((i+dr)//s, (j+dc)//s). The HR reflect ring maps to phase-remapped edge
columns/rows of the LR phase tensor.

Params: ``{"c0": {"w", "b"}, "c1": {"w", ("b")}, ("c2": {"w"})}`` with the
reference's OIHW conv weights (``tail.0/3/6`` of the state_dict).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from m2trans_tpu_torch.ops.conv import gelu_exact
from m2trans_tpu_torch.ops.pixel_shuffle import pixel_shuffle_fast

Params = Dict[str, Any]


def _phase_layout(scale: int) -> np.ndarray:
    """L[pi, pj] -> channel-block index of HR phase (pi, pj) in the stage
    output layout: (i, j) order for one stage (x2/x3); for the two x2
    stages of x4, group (a, b) of stage 1 maps to phases (2a+c, 2b+d) with
    within-group order (c, d)."""
    if scale == 4:
        L = np.empty((4, 4), np.int32)
        for pi in range(4):
            for pj in range(4):
                a, c = divmod(pi, 2)
                b, d = divmod(pj, 2)
                L[pi, pj] = (a * 2 + b) * 4 + c * 2 + d
        return L
    return np.arange(scale * scale, dtype=np.int32).reshape(scale, scale)


@functools.lru_cache(maxsize=None)
def _k_selector(scale: int) -> np.ndarray:
    """Constant 0/1 tensor M[yo+1, xo+1, src_block, dr+1, dc+1, out_phase]:
    K = einsum('abpdeq,deio->abpiqo', M, w3x3)."""
    s = scale
    L = _phase_layout(s)
    P = s * s
    M = np.zeros((3, 3, P, 3, 3, P), np.float32)
    for i in range(s):
        for j in range(s):
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    pi, yo = (i + dr) % s, (i + dr) // s
                    pj, xo = (j + dc) % s, (j + dc) // s
                    M[yo + 1, xo + 1, L[pi, pj], dr + 1, dc + 1,
                      i * s + j] = 1.0
    return M


def _remap_edge(edge: torch.Tensor, src_of_dst: np.ndarray, nf: int) -> torch.Tensor:
    """Phase-block remap of a thin edge slice (..., P*nf): block k takes
    block src_of_dst[k] (zeros where src_of_dst[k] < 0). Built from views,
    with no index tensor to copy to the device (such a copy from pageable
    memory synchronises the stream)."""
    v = edge.reshape(edge.shape[:-1] + (src_of_dst.shape[0], nf))
    zero = v.new_zeros(v.shape[:-2] + (nf,))
    return torch.stack([v[..., k, :] if k >= 0 else zero
                        for k in src_of_dst.tolist()], dim=-2).reshape(edge.shape)


def _col_map(L: np.ndarray, dst_pj: int, src_pj: int) -> np.ndarray:
    s = L.shape[0]
    m = -np.ones(s * s, np.int64)
    for pi in range(s):
        m[L[pi, dst_pj]] = L[pi, src_pj]
    return m


def _row_map(L: np.ndarray, dst_pi: int, src_pi: int) -> np.ndarray:
    s = L.shape[0]
    m = -np.ones(s * s, np.int64)
    for pj in range(s):
        m[L[dst_pi, pj]] = L[src_pi, pj]
    return m


def _stage_w(sp: Params, r: int, dtype):
    """1x1 conv (O, I, 1, 1) -> (I, O) matmul weight with output channels
    in pixel_shuffle_fast order, and its permuted bias: the permutation
    ``pixel_shuffle.ps_weight_perm`` (c*r*r + k -> k*C + c) taken as a
    transpose."""
    o, i = sp["w"].shape[0], sp["w"].shape[1]
    c = o // (r * r)
    w = sp["w"].reshape(c, r * r, i).permute(2, 1, 0).reshape(i, o)
    b = sp["b"].reshape(c, r * r).t().reshape(o)
    return w.to(dtype), b.to(dtype)


def last_conv_weight(p: Params, scale: int) -> torch.Tensor:
    """The tail's final 3x3 conv weight as HWIO (3, 3, nf, 3)."""
    w = p["c2"]["w"] if scale == 4 else p["c1"]["w"]
    return w.permute(2, 3, 1, 0)


def expand_phase_kernel(w3: torch.Tensor, scale: int) -> torch.Tensor:
    """HWIO (3, 3, nf, 3) -> the selector-expanded (3, 3, P*nf, P*3) K.
    Each entry of K is a single entry of w3 (or 0), so K is exact in any
    dtype."""
    P = scale * scale
    nf = w3.shape[2]
    M = torch.as_tensor(_k_selector(scale), device=w3.device).to(w3.dtype)
    return torch.einsum("abpdeq,deio->abpiqo", M, w3).reshape(
        3, 3, P * nf, P * 3)


def stage_weights(p: Params, *, scale: int, dtype=torch.bfloat16):
    """(w0, b0, w1, b1): the ps-permuted stage weights. For scale != 4,
    w1/b1 repeat w0/b0."""
    if scale == 4:
        w0, b0 = _stage_w(p["c0"], 2, dtype)
        w1, b1 = _stage_w(p["c1"], 2, dtype)
        return w0, b0, w1, b1
    w0, b0 = _stage_w(p["c0"], scale, dtype)
    return w0, b0, w0, b0


def tail_phase_weights(p: Params, *, scale: int, dtype=torch.bfloat16):
    """(w0, b0, w1, b1, K): the stage weights and the selector-expanded
    block-sparse 3x3 kernel."""
    K = expand_phase_kernel(last_conv_weight(p, scale).to(dtype), scale)
    return (*stage_weights(p, scale=scale, dtype=dtype), K)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Flat per-pixel product in the weight's dtype, accumulated in f32 and
    rounded once (the JAX ``preferred_element_type=w.dtype``)."""
    return a.to(w.dtype) @ w


def _stage_pipeline(x, w0, b0, w1, b1, *, scale: int, nf: int):
    """Per-pixel phase stages on an arbitrary (thin) NHWC slice."""
    lead = x.shape[:-1]
    y = gelu_exact(_mm(x.reshape(-1, x.shape[-1]), w0) + b0)
    y = y.reshape(lead + (w0.shape[1],))
    if scale == 4:
        out = _mm(y.reshape(-1, nf), w1)
        y = gelu_exact(out + b1).reshape(lead + (16 * nf,))
    return y


def phase_edges(p: Params, x: torch.Tensor, *, scale: int,
                dtype=torch.bfloat16):
    """HR-reflect phase-remapped pad slices of the body output ``x``
    (B, H, W, nf), computed on 1-px slices:

      left/right: (B, H+2, 1, P*nf) f32 — pad columns by padded-phase-row
        (rows 0 and H+1 unused: the top/bottom rows supply them);
      top/bottom: (B, 1, W+2, P*nf) f32 — pad rows with their corners.
    """
    nf = x.shape[-1]
    s = scale
    w0, b0, w1, b1 = stage_weights(p, scale=scale, dtype=dtype)
    L = _phase_layout(s)

    def stage(z):
        return _stage_pipeline(z.to(dtype), w0, b0, w1, b1, scale=scale,
                               nf=nf)

    cl, cr = _col_map(L, s - 1, 1), _col_map(L, 0, s - 2)
    left = _remap_edge(stage(x[:, :, :1]), cl, nf)
    right = _remap_edge(stage(x[:, :, -1:]), cr, nf)

    def padded_row(row):
        phr = stage(row)
        return torch.cat([_remap_edge(phr[:, :, :1], cl, nf), phr,
                          _remap_edge(phr[:, :, -1:], cr, nf)], dim=2)

    top = _remap_edge(padded_row(x[:, :1]), _row_map(L, s - 1, 1), nf)
    bot = _remap_edge(padded_row(x[:, -1:]), _row_map(L, 0, s - 2), nf)

    zrow = torch.zeros_like(left[:, :1])
    left = torch.cat([zrow, left, zrow], dim=1)
    right = torch.cat([zrow, right, zrow], dim=1)
    return left.float(), right.float(), top.float(), bot.float()


def tail_phase_apply(p: Params, x: torch.Tensor, *, scale: int,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """(B, H, W, nf) -> (B, H*scale, W*scale, 3), unclamped."""
    nf = x.shape[-1]
    s = scale
    w0, b0, w1, b1, K = tail_phase_weights(p, scale=scale, dtype=dtype)
    y = _stage_pipeline(x.to(dtype), w0, b0, w1, b1, scale=s, nf=nf)

    L = _phase_layout(s)
    left = _remap_edge(y[:, :, :1], _col_map(L, s - 1, 1), nf)
    right = _remap_edge(y[:, :, -1:], _col_map(L, 0, s - 2), nf)
    y = torch.cat([left, y, right], dim=2)
    top = _remap_edge(y[:, :1], _row_map(L, s - 1, 1), nf)
    bot = _remap_edge(y[:, -1:], _row_map(L, 0, s - 2), nf)
    y = torch.cat([top, y, bot], dim=1)

    out = F.conv2d(y.permute(0, 3, 1, 2), K.permute(3, 2, 0, 1))
    # out channel (i*s + j)*3 + rgb is pixel_shuffle_fast's order, C=3
    return pixel_shuffle_fast(out.permute(0, 2, 3, 1), s)
