"""Padding utilities (NHWC); port of m2trans_tpu/ops/pad.py.

The reference pads inputs on the bottom/right with reflect padding to a
multiple of LCM(window_sizes)=32 before the transformer body and crops the
output back. Reflection excludes the edge pixel and, like ``jnp.pad`` (and
unlike ``F.pad``), keeps reflecting when the pad is wider than the frame.
"""

from __future__ import annotations

import torch


def _reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source indices of numpy 'reflect' padding along an axis of size n."""
    i = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m >= n, period - m, m)


def reflect_pad_hw(x: torch.Tensor, pad_h: tuple, pad_w: tuple) -> torch.Tensor:
    """Reflect-pad the H and W axes of an NHWC tensor."""
    if pad_h != (0, 0):
        x = x.index_select(1, _reflect_index(x.shape[1], *pad_h, x.device))
    if pad_w != (0, 0):
        x = x.index_select(2, _reflect_index(x.shape[2], *pad_w, x.device))
    return x


def pad_to_multiple(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Reflect-pad H, W (bottom/right only) of NHWC ``x`` up to a multiple."""
    h, w = x.shape[1], x.shape[2]
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    return reflect_pad_hw(x, (0, ph), (0, pw))
