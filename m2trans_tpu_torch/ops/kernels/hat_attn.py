"""HAT's two attentions: wrappers, launch counts and plain versions.

Replaces no TPU kernel: the JAX package has no HAT. On the card each is one
kernel (``csrc/hat_attn.cu``; its header has the design and the bound), bf16
on the tensor cores, forward only:

- :func:`window_attention_16`: the (shifted) 16x16 window self-attention of
  a hybrid attention block (SW-MSA, kernel ``m2t_hat_wattn``): roll by
  -shift, window partition, head split, q * hd^-0.5, Q K^T, + the relative
  position bias of the ((2*16-1)^2, heads) table, + the -100 SW-MSA mask,
  softmax, P V, head merge, window reverse, roll back. The index rules are
  MedCLIP's (:mod:`.swin_attn`: ``window_tokens``, ``token_regions``,
  ``relative_position_index``), parametric in the window.
- :func:`overlap_attention`: the overlapping cross-attention of a group's
  last block (OCA, kernel ``m2t_hat_oca``): the 16^2 query windows of the
  unshifted map against the 24^2 key windows centred on them, keys and
  values outside the map zero vectors that stay in the softmax, the bias
  of the ((16+24-1)^2, heads) table by :func:`oca_relative_position_index`.

q, k, v: (B, H, W, C) in image layout, the projections of the layer-normed
map; they may be views of one (B, H, W, 3C) qkv tensor (the kernels read a
pixel stride). The table is f32 (the module's own parameter). The output is
(B, H, W, C), ready for the o-projection.

CUDA tensors launch the kernels (bf16, H and W multiples of 16, head dim
even and at most 32; anything else raises); CPU tensors run the plain
versions, which the f32 path also calls by name on any device. There is no
fallback for a CUDA tensor.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from m2trans_tpu_torch.ops import on_device
from m2trans_tpu_torch.ops.kernels import build
from m2trans_tpu_torch.ops.kernels import swin_attn
from m2trans_tpu_torch.ops.kernels.swin_attn import window_attention_plain, window_tokens

WINDOW = 16
OCA_WINDOW = 24  # 16 + int(0.5 * 16): HAT's overlap_ratio 0.5
HEAD_DIM_MAX = 32


@lru_cache(maxsize=8)
def released_oca_index(window: int, key_window: int) -> np.ndarray:
    """(window^2, key_window^2) the released ``calculate_rpi_oca`` for query
    (qr, qc) of the window and key (kr, kc) of the key window: (kr - qr +
    window - key_window + 1) * (window + key_window - 1) + (kc - qc + window
    - key_window + 1), negative for some pairs (the released buffer
    ``relative_position_index_OCA``)."""
    p, off = window + key_window - 1, window - key_window + 1
    qr, qc = np.divmod(np.arange(window * window), window)
    kr, kc = np.divmod(np.arange(key_window * key_window), key_window)
    return ((kr[None] - qr[:, None] + off) * p + (kc[None] - qc[:, None] + off)).astype(np.int64)


@lru_cache(maxsize=8)
def oca_relative_position_index(window: int, key_window: int) -> np.ndarray:
    """The row of the ((window + key_window - 1)^2, heads) OCA bias table
    each (query, key) pair reads: :func:`released_oca_index` wrapped modulo
    the table's rows, as PyTorch indexing wraps its negative entries."""
    return np.mod(released_oca_index(window, key_window), (window + key_window - 1) ** 2)


@lru_cache(maxsize=8)
def bias_rows(window: int, key_window: int) -> np.ndarray:
    """(P*P,) the table row of each entry of the kernels' shared-memory bias
    column, P = window + key_window - 1: entry (kr - qr + window - 1) * P +
    (kc - qc + window - 1) holds the row the released index gives that
    offset (SW-MSA's table read backwards, OCA's rotated)."""
    p, n = window + key_window - 1, (window + key_window - 1) ** 2
    i = np.arange(n)
    if key_window == window:
        return (n - 1 - i).astype(np.int64)
    return ((i + (2 - key_window) * (p + 1)) % n).astype(np.int64)


@lru_cache(maxsize=32)
def _key_pixels(h: int, w: int, window: int, key_window: int) -> np.ndarray:
    """(nW * key_window^2,) the flat pixel each key token of each window
    reads, windows row-major, -1 outside the (H, W) map."""
    pad = (key_window - window) // 2
    t = np.arange(key_window * key_window)
    wi, wj = np.divmod(np.arange((h // window) * (w // window)), w // window)
    rows = wi[:, None] * window - pad + t[None] // key_window
    cols = wj[:, None] * window - pad + t[None] % key_window
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    return np.where(inside, rows * w + cols, -1).reshape(-1)


def overlap_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            table: torch.Tensor, heads: int, window: int = WINDOW,
                            key_window: int = OCA_WINDOW) -> torch.Tensor:
    """Plain PyTorch version of the OCA kernel: each window's keys and values
    gathered from the map with a zero row past its edge, logits and softmax
    in f32, P cast to v's dtype before P V, the output back to its pixels
    (the query windows partition the unshifted map)."""
    b, h, w, c = q.shape
    nq, nk, hd = window * window, key_window * key_window, c // heads
    dev = q.device
    tok = on_device(window_tokens, h, w, window, 0, device=dev)
    keys = on_device(_key_pixels, h, w, window, key_window, device=dev)

    def gather(t, idx, n):  # (B, H, W, C) -> (B*nW, heads, n, hd)
        flat = torch.cat([t.reshape(b, h * w, c), t.new_zeros(b, 1, c)], dim=1)
        return flat[:, idx].reshape(-1, n, heads, hd).transpose(1, 2)

    qw = gather(q, tok, nq) * hd ** -0.5
    attn = qw.float() @ gather(k, keys, nk).float().transpose(-1, -2)
    rpi = on_device(oca_relative_position_index, window, key_window, device=dev)
    bias = table[rpi.reshape(-1)].reshape(nq, nk, heads).permute(2, 0, 1)
    p = torch.softmax(attn + bias[None].float(), dim=-1).to(v.dtype)
    out = (p @ gather(v, keys, nk)).transpose(1, 2).reshape(b, h * w, c)
    inv = on_device(swin_attn._inverse, h, w, window, 0, device=dev)
    return out[:, inv].reshape(b, h, w, c)


def _check(q, k, v, heads, window, what):
    """Raise unless the kernels take the operands: (B, H, W, C) views that
    share one even pixel stride (the kernels read it)."""

    def need(cond, msg):
        if not cond:
            raise ValueError(f"HAT {what} kernel: {msg}")

    b, h, w, c = q.shape
    need(window == WINDOW, f"the window must be {WINDOW}, got {window}")
    need(h % WINDOW == 0 and w % WINDOW == 0,
         f"H and W must be multiples of {WINDOW}, got {h} x {w}")
    need(c % heads == 0 and (c // heads) % 2 == 0 and c // heads <= HEAD_DIM_MAX,
         f"head dim C / heads must be even and at most {HEAD_DIM_MAX}, got {c} / {heads}")
    ps = q.stride(2)
    for name, t in (("q", q), ("k", k), ("v", v)):
        need(t.shape == q.shape, f"{name} {tuple(t.shape)} != q {tuple(q.shape)}")
        need(t.dtype == torch.bfloat16, f"{name} must be bf16, got {t.dtype}")
        need(t.device == q.device, "all tensors on one device")
        need(t.stride() == (h * w * ps, w * ps, ps, 1) and ps % 2 == 0,
             f"{name} must be (B, H, W, C) with an even pixel stride, the same for q, k "
             f"and v, got strides {t.stride()}")
        need(t.data_ptr() % 4 == 0, f"{name} must be 4-byte aligned")


def _table(table, rows, heads, what):
    if table.shape != (rows, heads) or table.dtype != torch.float32:
        raise ValueError(f"HAT {what} kernel: the bias table must be f32 ({rows}, {heads}), "
                         f"got {table.dtype} {tuple(table.shape)}")
    return table.contiguous()


def _launch(entry, q, k, v, table, heads, *extra):
    b, h, w, c = q.shape
    out = torch.empty((b, h, w, c), dtype=q.dtype, device=q.device)
    if q.numel():
        code = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(2),
                     table.data_ptr(), out.data_ptr(), b, h, w, c, heads, *extra,
                     (c // heads) ** -0.5, build.stream_ptr(q.device))
        build.check(code, entry.__name__)
    return out


def _no_grad(q, k, v, what):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(f"HAT {what} kernel: forward only (HAT is served, not trained, "
                         "by the port)")


def window_attention_16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        table: torch.Tensor, heads: int, shift: int,
                        window: int = WINDOW) -> torch.Tensor:
    """SW-MSA at window 16 (see the module docstring): the kernel for CUDA
    tensors, the plain version (at ``window``) for CPU tensors."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, table, heads, window, shift)
    if q.device.type != "cuda":
        raise ValueError(f"HAT window attention: unsupported device {q.device}")
    _check(q, k, v, heads, window, "window attention")
    if not 0 <= shift < WINDOW:
        raise ValueError(f"HAT window attention kernel: shift must be in [0, {WINDOW}), "
                         f"got {shift}")
    _no_grad(q, k, v, "window attention")
    table = _table(table, (2 * WINDOW - 1) ** 2, heads, "window attention")
    out = _launch(build.lib().m2t_hat_wattn, q, k, v, table, heads, shift)
    window_attention_16.launches += 1
    return out


def overlap_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      table: torch.Tensor, heads: int, window: int = WINDOW,
                      key_window: int = OCA_WINDOW) -> torch.Tensor:
    """OCA (see the module docstring): the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return overlap_attention_plain(q, k, v, table, heads, window, key_window)
    if q.device.type != "cuda":
        raise ValueError(f"HAT overlapping attention: unsupported device {q.device}")
    _check(q, k, v, heads, window, "overlapping attention")
    if key_window != OCA_WINDOW:
        raise ValueError(f"HAT overlapping attention kernel: the key window must be "
                         f"{OCA_WINDOW}, got {key_window}")
    _no_grad(q, k, v, "overlapping attention")
    table = _table(table, (WINDOW + OCA_WINDOW - 1) ** 2, heads, "overlapping attention")
    out = _launch(build.lib().m2t_hat_oca, q, k, v, table, heads)
    overlap_attention.launches += 1
    return out


window_attention_16.launches = 0  # kernel launches, counted at each
overlap_attention.launches = 0
