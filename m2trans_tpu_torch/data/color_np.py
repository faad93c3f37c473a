"""Host-side (numpy) color conversion for the colors==1 data path; port of
m2trans_tpu/data/color_np.py (skimage.color.rgb2ycbcr's arithmetic: BT.601,
uint8 input scaled to [0,1], Y in [16, 235])."""

from __future__ import annotations

import numpy as np

_M = np.array(
    [
        [65.481, 128.553, 24.966],
        [-37.797, -74.203, 112.0],
        [112.0, -93.786, -18.214],
    ],
    np.float64,
)
_OFFSET = np.array([16.0, 128.0, 128.0], np.float64)


def rgb2ycbcr_uint8(img: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> float64 HWC YCbCr."""
    x = img.astype(np.float64) / 255.0
    return x @ _M.T + _OFFSET
