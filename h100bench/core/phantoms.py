"""Seeded ultrasound-like frames.

:func:`speckle_phantom` is a frozen copy of
``m2trans_tpu_torch/tools/train_full_recipe.py::speckle_phantom`` (commit
462c782; itself the JAX scripts' ``_speckle_phantom``, the same draws and
values): smooth tissue blobs and bright curved interfaces, times a
band-limited Rayleigh speckle, as uint8. US1K itself is not in the
repository.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


def speckle_phantom(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(h, w) uint8."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(6):  # smooth tissue regions
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        sy, sx = rng.uniform(h / 8, h / 2), rng.uniform(w / 8, w / 2)
        amp = rng.uniform(0.2, 0.8)
        img += amp * np.exp(-((yy - cy) / sy) ** 2 - ((xx - cx) / sx) ** 2)
    for _ in range(3):  # bright curved interfaces (vessel walls)
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(h / 8, h / 3)
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        img += 0.6 * np.exp(-((d - r) / 2.5) ** 2)
    img = img / (img.max() + 1e-6)
    n = rng.rayleigh(scale=0.4, size=(h, w)).astype(np.float32)
    k = np.ones((2, 2), np.float32) / 4
    npad = np.pad(n, ((0, 1), (0, 1)), mode="edge")
    n = (sliding_window_view(npad, (2, 2)) * k).sum((-1, -2))
    img = np.clip(img * (0.4 + n), 0, 1)
    return (img * 255).astype(np.uint8)


def rgb_frames(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w, 3) float32 in [0, 1]: grey phantoms on three channels, as
    an ultrasound frame is stored."""
    out = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        out[i] = (speckle_phantom(rng, h, w).astype(np.float32) / 255.0)[..., None]
    return out


def downscale(hr_u8: np.ndarray, scale: int) -> np.ndarray:
    """(H, W[, C]) uint8 -> (H/s, W/s[, C]) uint8: bicubic, align_corners
    False, clipped and truncated (how the JAX scripts make LR)."""
    import torch
    import torch.nn.functional as F

    x = torch.from_numpy(np.ascontiguousarray(hr_u8, np.float32))
    x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    h, w = x.shape[2], x.shape[3]
    y = F.interpolate(x, (h // scale, w // scale), mode="bicubic", align_corners=False)
    y = np.clip(y[0].permute(1, 2, 0).numpy(), 0, 255).astype(np.uint8)
    return y[..., 0] if hr_u8.ndim == 2 else y
