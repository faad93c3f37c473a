"""MedCLIP's Swin window attention: wrapper, launch count and plain version.

Replaces no TPU kernel: the JAX package's MedCLIP attention
(m2trans_tpu/models/medclip/swin.py, ``_attention``) is plain XLA. On the
card the whole attention core of a Swin block, from the q, k, v
projections to the output projection, is one kernel each way
(``csrc/swin_attn.cu``; its header has the design and the bound):

    roll by -shift, window partition, head split, q * hd^-0.5, Q K^T (f32),
    + the relative-position bias, + the SW-MSA -100 mask, softmax (f32),
    P V, head merge, window reverse, roll back by +shift.

q, k, v: (B, H, W, C) in image layout, the projections of the
layer-normed map (a per-token product commutes with the window
permutation); table: the block's ((2*window-1)^2, heads) bias table. The
output is (B, H, W, C), ready for the o-projection.

The kernel's index rules, mirrored here on the host, are the plain
version's too: :func:`window_tokens` (the pixel each window token reads),
:func:`token_regions` (its SW-MSA region) and
:func:`relative_position_index`. :func:`window_attention` launches the
kernels for CUDA tensors (window 7, head dims 8, 16 and 32, f32 or bf16;
anything else raises) and runs :func:`window_attention_plain` for CPU
tensors only.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from m2trans_tpu_torch.ops import on_device
from m2trans_tpu_torch.ops.kernels import build

WINDOW = 7
HEAD_DIMS = (8, 16, 32)


def _rolled_coords(h: int, w: int, window: int):
    """(nW, n) rows and columns of each window token on the rolled map,
    windows row-major, tokens row-major in their window."""
    t = np.arange(window * window)
    wi, wj = np.divmod(np.arange((h // window) * (w // window)), w // window)
    rows = wi[:, None] * window + t[None] // window
    cols = wj[:, None] * window + t[None] % window
    return rows, cols


@lru_cache(maxsize=32)
def window_tokens(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW * n,) the flat pixel of the (H, W) map that each window token
    reads: the map rolled by -shift, so token (r, c) of window (wi, wj) is
    pixel ((wi*window + r + shift) mod H, (wj*window + c + shift) mod W);
    the output goes back to the same pixel."""
    rows, cols = _rolled_coords(h, w, window)
    return (((rows + shift) % h) * w + (cols + shift) % w).reshape(-1)


@lru_cache(maxsize=32)
def token_regions(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, n) the SW-MSA region of each window token: on each axis of the
    rolled map the slices [0, n - window), [n - window, n - shift) and
    [n - shift, n) are regions 0, 1, 2; a token's is 3 * row's + column's."""
    rows, cols = _rolled_coords(h, w, window)

    def region(x, n):
        return np.where(x < n - window, 0, np.where(x < n - shift, 1, 2))

    return (3 * region(rows, h) + region(cols, w)).astype(np.int32)


@lru_cache(maxsize=32)
def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, n, n) additive mask of SW-MSA: -100 where two tokens of a window
    lie in different regions."""
    reg = token_regions(h, w, window, shift)
    return np.where(reg[:, :, None] != reg[:, None, :], -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=8)
def relative_position_index(window: int) -> np.ndarray:
    """(n, n) row of the (2w-1)^2 bias table for tokens i, j of a window:
    (r_i - r_j + w - 1) * (2w - 1) + (c_i - c_j + w - 1)."""
    r, c = np.divmod(np.arange(window * window), window)
    return ((r[:, None] - r[None] + window - 1) * (2 * window - 1)
            + (c[:, None] - c[None] + window - 1)).astype(np.int64)


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           table: torch.Tensor, heads: int, window: int,
                           shift: int) -> torch.Tensor:
    """Plain PyTorch version of the kernels: the windows gathered by
    :func:`window_tokens`, logits and softmax in f32, P cast to v's dtype
    before P V (the JAX encoder's rounding points), the output scattered
    back to its pixels."""
    b, h, w, c = q.shape
    n, hd = window * window, c // heads
    dev = q.device
    tok = on_device(window_tokens, h, w, window, shift, device=dev)

    def windows(t):  # (B, H, W, C) -> (B*nW, heads, n, hd)
        return t.reshape(b, h * w, c)[:, tok].reshape(-1, n, heads, hd).transpose(1, 2)

    attn = (windows(q) * hd ** -0.5).float() @ windows(k).float().transpose(-1, -2)
    rpi = on_device(relative_position_index, window, device=dev)
    bias = table[rpi.reshape(-1)].reshape(n, n, heads).permute(2, 0, 1)
    attn = attn + bias[None].float()
    if shift:
        mask = on_device(shift_attn_mask, h, w, window, shift, device=dev)
        attn = attn.reshape(b, -1, heads, n, n) + mask[None, :, None]
        attn = attn.reshape(-1, heads, n, n)
    p = torch.softmax(attn, dim=-1).to(v.dtype)
    out = (p @ windows(v)).transpose(1, 2).reshape(b, h * w, c)
    inv = on_device(_inverse, h, w, window, shift, device=dev)
    return out[:, inv].reshape(b, h, w, c)


@lru_cache(maxsize=32)
def _inverse(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """The window token each pixel is (the inverse of window_tokens)."""
    return np.argsort(window_tokens(h, w, window, shift))


def _check(q, k, v, table, heads, window, shift):
    """Raise unless the kernels take the operands."""

    def need(cond, msg):
        if not cond:
            raise ValueError(f"swin window attention kernel: {msg}")

    b, h, w, c = q.shape
    need(window == WINDOW, f"the window must be {WINDOW}, got {window}")
    need(c % heads == 0 and c // heads in HEAD_DIMS,
         f"head dim C / heads must be one of {HEAD_DIMS}, got {c} / {heads}")
    need(0 <= shift < window, f"shift must be in [0, {window}), got {shift}")
    need(q.dtype in (torch.float32, torch.bfloat16), f"q must be f32 or bf16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        need(t.shape == q.shape, f"{name} {tuple(t.shape)} != q {tuple(q.shape)}")
    need(table.shape == ((2 * window - 1) ** 2, heads),
         f"table must be ({(2 * window - 1) ** 2}, {heads}), got {tuple(table.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("table", table)):
        need(t.dtype == q.dtype, f"{name} is {t.dtype}, q {q.dtype}")
        need(t.device == q.device, "all tensors on one device")
        need(t.is_contiguous(), f"{name} must be contiguous")
        need(t is table or t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    need(not table.requires_grad,
         "the kernels give the bias table no gradient (MedCLIP's weights are frozen)")


def _args(q, heads, shift):
    b, h, w, c = q.shape
    return (b, h, w, c, heads, shift, (c // heads) ** -0.5,
            int(q.dtype == torch.bfloat16), build.stream_ptr(q.device))


class SwinAttnFn(torch.autograd.Function):
    """The forward kernel; the backward kernel recomputes P from the saved
    q and k and writes dq, dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, table, heads, shift):
        out = torch.empty_like(q)
        if q.numel():
            code = build.lib().m2t_swin_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             table.data_ptr(), out.data_ptr(),
                                             *_args(q, heads, shift))
            build.check(code, "swin window attention")
            window_attention.launches += 1
        ctx.save_for_backward(q, k, v, table)
        ctx.heads, ctx.shift = heads, shift
        return out

    @staticmethod
    def backward(ctx, gout):
        q, k, v, table = ctx.saved_tensors
        gout = gout.to(q.dtype).contiguous()
        if gout.data_ptr() % 16:  # the kernel loads 16-byte vectors
            gout = gout.clone()
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        if q.numel():
            code = build.lib().m2t_swin_attn_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
                gout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *_args(q, ctx.heads, ctx.shift))
            build.check(code, "swin window attention backward")
            window_attention.launches += 1
        return dq, dk, dv, None, None, None


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     table: torch.Tensor, heads: int, window: int,
                     shift: int) -> torch.Tensor:
    """Windowed (optionally shifted) multi-head attention over (B, H, W, C)
    q, k, v (see the module docstring), differentiable in q, k and v. CUDA
    tensors launch the kernels; CPU tensors run the plain version."""
    if q.dim() != 4 or q.shape[1] % window or q.shape[2] % window:
        raise ValueError(f"swin window attention: a (B, H, W, C) map with H and W "
                         f"multiples of the window {window}, got {tuple(q.shape)}")
    if q.device.type == "cuda":
        _check(q, k, v, table, heads, window, shift)
        return SwinAttnFn.apply(q, k, v, table, heads, shift)
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, table, heads, window, shift)
    raise ValueError(f"swin window attention: unsupported device {q.device}")


window_attention.launches = 0  # kernel launches (forward and backward), counted at each
