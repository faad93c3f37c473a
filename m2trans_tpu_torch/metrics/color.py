"""Color-space conversion of the evaluation path; port of
m2trans_tpu/metrics/color.py."""

from __future__ import annotations

import torch


def rgb_to_ycbcr(image: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 RGB -> YCbCr, NHWC. Bit-matches reference
    utils.py:121-146, including its division of the input by 255: callers
    pass [0,1] images, and the later x255 before calc_psnr cancels it."""
    image = image / 255.0
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    y = 65.481 * r + 128.553 * g + 24.966 * b + 16.0
    cb = -37.797 * r - 74.203 * g + 112.0 * b + 128.0
    cr = 112.0 * r - 93.786 * g - 18.214 * b + 128.0
    return torch.stack((y, cb, cr), dim=-1)
