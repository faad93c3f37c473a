"""Bicubic and bilinear resize as two products with interpolation matrices;
port of m2trans_tpu/ops/resize.py.

The reference resizes SR/HR patches to 224x224 with
``F.interpolate(mode='bicubic', align_corners=True)`` before MedCLIP
encoding (losses.py:53-54). Here the resize is ``out = W_h @ x @ W_w^T``
with dense (n_out, n_in) matrices built in numpy (torch's bicubic kernel,
Keys with A = -0.75, edge-clamped taps; align_corners=True maps
src = i * (in-1) / (out-1)). Its backward is two products as well, so it is
deterministic, where ``F.interpolate``'s backward accumulates with atomics.
The matrices are built once per (n_in, n_out, align_corners) and copied to
a device once per device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from m2trans_tpu_torch.ops import on_device


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    return np.where(
        at <= 1.0,
        (a + 2.0) * at ** 3 - (a + 3.0) * at ** 2 + 1.0,
        np.where(at < 2.0,
                 a * at ** 3 - 5.0 * a * at ** 2 + 8.0 * a * at - 4.0 * a,
                 0.0),
    )


@lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) bicubic interpolation weights, edge-clamped taps."""
    if n_out == 1:
        src = np.zeros((1,))
    elif align_corners:
        src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    else:
        src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    mat = np.zeros((n_out, n_in), np.float64)
    for tap in range(-1, 3):
        np.add.at(mat, (np.arange(n_out), np.clip(i0 + tap, 0, n_in - 1)),
                  _cubic_kernel(tap - frac))
    return mat.astype(np.float32)


@lru_cache(maxsize=64)
def _linear_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation weights."""
    if n_out == 1:
        src = np.zeros((1,))
    elif align_corners:
        src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    else:
        src = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    mat = np.zeros((n_out, n_in), np.float64)
    np.add.at(mat, (np.arange(n_out), np.clip(i0, 0, n_in - 1)), 1 - frac)
    np.add.at(mat, (np.arange(n_out), np.clip(i0 + 1, 0, n_in - 1)), frac)
    return mat.astype(np.float32)


def _separable(build, x: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
    h, w = x.shape[1], x.shape[2]
    wh = on_device(build, h, out_hw[0], align_corners, device=x.device)
    ww = on_device(build, w, out_hw[1], align_corners, device=x.device)
    y = torch.einsum("oh,bhwc->bowc", wh, x.float())
    y = torch.einsum("pw,bowc->bopc", ww, y)
    return y.to(x.dtype)


def bicubic_resize(x: torch.Tensor, out_hw, align_corners: bool = True) -> torch.Tensor:
    """NHWC bicubic resize to (out_h, out_w), computed in f32 and returned
    in x's dtype."""
    return _separable(_resize_matrix, x, out_hw, align_corners)


def bilinear_resize(x: torch.Tensor, out_hw, align_corners: bool = False) -> torch.Tensor:
    """NHWC bilinear resize (the JAX trainer's TensorBoard panels)."""
    return _separable(_linear_matrix, x, out_hw, align_corners)
