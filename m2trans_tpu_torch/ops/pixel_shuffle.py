"""Sub-pixel (depth-to-space) upsampling, NHWC, PyTorch channel order;
port of m2trans_tpu/ops/pixel_shuffle.py.

``torch.nn.PixelShuffle(r)`` maps in[b, c*r^2 + i*r + j, h, w] ->
out[b, c, h*r + i, w*r + j].
"""

from __future__ import annotations

import numpy as np
import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C*r*r) -> (B, H*r, W*r, C), torch PixelShuffle ordering."""
    bsz, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(bsz, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(bsz, h * r, w * r, c)


def pixel_shuffle_fast(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space for channels pre-ordered (r_i, r_j, c), i.e. channel
    index (i*r + j)*C + c: torch PixelShuffle composed with
    :func:`ps_weight_perm`."""
    bsz, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(bsz, h, w, r, r * c).permute(0, 1, 3, 2, 4)
    return x.reshape(bsz, h * r, w * r, c)


def ps_weight_perm(c_out: int, r: int) -> np.ndarray:
    """Output-channel permutation from torch PixelShuffle order
    (c*r*r + i*r + j) to the (i*r + j)*C + c order of
    :func:`pixel_shuffle_fast`."""
    perm = [c * r * r + i * r + j
            for i in range(r) for j in range(r) for c in range(c_out)]
    return np.asarray(perm, np.int64)
