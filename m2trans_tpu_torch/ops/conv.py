"""2-D convolutions in NHWC / HWIO terms; port of m2trans_tpu/ops/conv.py.

The weight is the reference's own OIHW tensor (``nn.Conv2d.weight``); the
activations stay NHWC at the interface. ``x.permute(0, 3, 1, 2)`` of a
contiguous NHWC tensor is a ``channels_last`` NCHW view, so cuDNN runs the
conv without a relayout and returns a ``channels_last`` result whose
inverse permute is contiguous NHWC again.

Padding semantics match the reference: ``'reflect'`` (head / tail 3x3) is
an explicit reflect pad then a VALID conv; ``'zeros'`` (CFTM feed-forward
3x3) is SAME-style zero padding; ``'valid'`` pads nothing.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, padding: str = "zeros", dtype: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """NHWC conv with an OIHW weight. ``padding``: 'zeros' | 'reflect' |
    'valid' (pad = (k-1)//2). With ``dtype`` the input, weight and bias are
    cast to it first (the bias add then rounds in that dtype, as the JAX
    conv2d does)."""
    if dtype is not None:
        x = x.to(dtype)
        w = w.to(dtype)
        b = None if b is None else b.to(dtype)
    kh, kw = w.shape[2], w.shape[3]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xc = x.permute(0, 3, 1, 2)
    pad = 0
    if padding == "reflect" and (ph or pw):
        xc = F.pad(xc, (pw, pw, ph, ph), mode="reflect")
    elif padding == "zeros":
        pad = (ph, pw)
    elif padding not in ("reflect", "valid"):
        raise ValueError(f"unknown padding {padding!r}")
    y = F.conv2d(xc, w, padding=pad)
    if b is not None:
        # bias added after the conv so its rounding point matches the JAX
        # conv2d (conv rounded to dtype, then + bias in dtype)
        y = y + b[None, :, None, None]
    return y.permute(0, 2, 3, 1).contiguous()


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU — the reference ``nn.GELU()`` default."""
    return F.gelu(x, approximate="none")
