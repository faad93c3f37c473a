"""SSIM matching ``pytorch_msssim.ssim`` defaults (the reference's SSIM,
utils.py:11,232-234); port of m2trans_tpu/metrics/ssim.py: 11x11 gaussian
window sigma 1.5, K = (0.01, 0.03), data_range 255, VALID filtering, mean
over batch, channels and space.

The separable filter is written as weighted sums of shifted slices, in f32
on any device (no convolution library, so no TF32 rounding on the card).
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_kernel(win_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(win_size, dtype=np.float64) - (win_size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter2d_separable(x: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """VALID filtering of NHWC x with a 1-D kernel along H, then W."""
    n = len(k1d)
    h, w = x.shape[1] - n + 1, x.shape[2] - n + 1
    y = sum(float(k1d[i]) * x[:, i:i + h] for i in range(n))
    return sum(float(k1d[i]) * y[:, :, i:i + w] for i in range(n))


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0,
         win_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over an NHWC batch (size_average=True semantics)."""
    x, y = x.float(), y.float()
    win = _gaussian_kernel(win_size, sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _filter2d_separable(x, win)
    mu_y = _filter2d_separable(y, win)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx = _filter2d_separable(x * x, win) - mu_xx
    sigma_yy = _filter2d_separable(y * y, win) - mu_yy
    sigma_xy = _filter2d_separable(x * y, win) - mu_xy
    cs = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    lum = (2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)
    return (lum * cs).mean()


def calc_ssim(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """Reference utils.calc_ssim: pytorch_msssim defaults on 0-255 inputs."""
    return ssim(sr, hr, data_range=255.0)
