"""Gradient Magnitude Similarity Deviation (Xue et al. 2013) in the
piq.gmsd pipeline of the reference's test harness (test.py:98-99); port of
m2trans_tpu/metrics/gmsd.py:

  1. scale the input by data_range to [0, 1];
  2. RGB -> YIQ luminance;
  3. 2x2 average-pool downsample (piq quirk: if either H or W is odd, BOTH
     bottom and right are zero-padded by one, and the pool then drops a
     trailing odd row or column);
  4. Prewitt gradients (/3), gradient magnitude;
  5. GMS map = (2 gx gy + c) / (gx^2 + gy^2 + c), c = 170/255^2;
  6. GMSD = population std of the map.

In f32 on the input's device; the 3x3 filters are weighted sums of shifted
slices (no convolution library, so no TF32 rounding on the card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# ITU YIQ luminance row (piq reduces colour with the YIQ transform)
_YIQ_LUMA = (0.299, 0.587, 0.114)

_PREWITT_X = np.array(
    [[1.0, 0.0, -1.0], [1.0, 0.0, -1.0], [1.0, 0.0, -1.0]], np.float32) / 3.0


def conv_same(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Zero-padded SAME cross-correlation of (B, H, W) maps with a small
    2-D kernel, in f32."""
    kh, kw = k.shape
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2))
    out = torch.zeros_like(x)
    for i in range(kh):
        for j in range(kw):
            if k[i, j] != 0:
                out = out + float(k[i, j]) * xp[:, i:i + h, j:j + w]
    return out


def _luma(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3 or 1) -> (B, H, W) luminance."""
    if x.shape[-1] == 3:
        r, g, b = _YIQ_LUMA
        return r * x[..., 0] + g * x[..., 1] + b * x[..., 2]
    return x[..., 0]


def gmsd(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """GMSD per image over an NHWC batch; returns (B,) scores (piq
    reduction='none' semantics). Lower is better."""
    x = _luma(x.float() / data_range)
    y = _luma(y.float() / data_range)

    pad = max(x.shape[1] % 2, x.shape[2] % 2)
    if pad:
        x = F.pad(x, (0, pad, 0, pad))
        y = F.pad(y, (0, pad, 0, pad))
    b, h, w = x.shape

    def pool(img):
        img = img[:, : h // 2 * 2, : w // 2 * 2]
        return img.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    x, y = pool(x), pool(y)

    def grad_mag(img):
        gx = conv_same(img, _PREWITT_X)
        gy = conv_same(img, _PREWITT_X.T)
        return torch.sqrt(gx ** 2 + gy ** 2 + 1e-12)

    gm_x, gm_y = grad_mag(x), grad_mag(y)
    c = 170.0 / (255.0 ** 2)
    gms = (2.0 * gm_x * gm_y + c) / (gm_x ** 2 + gm_y ** 2 + c)
    mean = gms.mean(dim=(1, 2), keepdim=True)
    return torch.sqrt(((gms - mean) ** 2).mean(dim=(1, 2)))
