"""Orthonormal 2x2 Haar analysis/synthesis (NHWC); port of
m2trans_tpu/ops/wavelet.py.

Subband channel order is [LL, HL, LH, HH], each a full C-channel group.
For the pixel quad a=x[2i,2j], b=x[2i+1,2j], c=x[2i,2j+1], d=x[2i+1,2j+1]:
    LL = (a+b+c+d)/2   HL = (-a-b+c+d)/2
    LH = (-a+b-c+d)/2  HH = (a-b-c+d)/2
"""

from __future__ import annotations

import torch


def haar_dwt(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), subband order [LL, HL, LH, HH]."""
    a = x[:, 0::2, 0::2, :]
    b = x[:, 1::2, 0::2, :]
    c = x[:, 0::2, 1::2, :]
    d = x[:, 1::2, 1::2, :]
    return torch.cat([(a + b + c + d) * 0.5, (-a - b + c + d) * 0.5,
                      (-a + b - c + d) * 0.5, (a - b - c + d) * 0.5], dim=-1)


def haar_iwt(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4C) -> (B, 2H, 2W, C); exact inverse of :func:`haar_dwt`."""
    bsz, h, w, c4 = x.shape
    c = c4 // 4
    ll, hl, lh, hh = torch.split(x, c, dim=-1)
    a = (ll - hl - lh + hh) * 0.5   # even row, even col
    b = (ll - hl + lh - hh) * 0.5   # odd row,  even col
    cc = (ll + hl - lh - hh) * 0.5  # even row, odd col
    d = (ll + hl + lh + hh) * 0.5   # odd row,  odd col
    even = torch.stack([a, cc], dim=3).reshape(bsz, h, 2 * w, c)
    odd = torch.stack([b, d], dim=3).reshape(bsz, h, 2 * w, c)
    return torch.stack([even, odd], dim=2).reshape(bsz, 2 * h, 2 * w, c)
