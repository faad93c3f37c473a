"""The building blocks the port's transformer and state-space SR baselines
share: HAT (``models/hat.py``) and MambaIR (``models/mambair.py``) both
carry the same stem and tail, the same channel-attention conv block (CAB)
and the same released checkpoint layout.

Parameter holders under the released names (``conv_blk.cab.{0, 2,
3.attention.1, 3.attention.3}`` / ``conv_block.cab.*``, ``patch_embed.norm``,
``conv_before_upsample.0``, ``upsample.{0, 2}``, ``conv_last``), the
weight access of the bf16 path (weights kept on the module in the policy's
dtype, ``models/numerics.py``'s kept operands), and the forward pieces on
NHWC tensors:

- :func:`linear`, :func:`conv` (3x3 zero pad 1, 1x1 or depthwise, cuDNN in
  NHWC), :func:`layer_norm` (one kernel with the residual sum before it or
  the SiLU gate after it taken in, ``ops/kernels/row_norm.py``);
- :func:`cab_apply`: conv 3x3 C -> C / compress, GELU, conv 3x3 back, times
  the sigmoid channel attention of its per-image channel means (squeeze C
  -> C / squeeze -> C), times ``scale`` (HAT's ``conv_scale``; 1 in
  MambaIR);
- :func:`normalised_input` / :func:`tail_apply`: the RGB mean taken off and
  scaled by ``img_range``; the pixel-shuffle tail (3x3 conv with
  LeakyReLU(0.01), log2(scale) x [3x3 conv to 4x, PixelShuffle(2)], 3x3
  ``conv_last``) and the mean added back;
- :func:`release_params`: the state dict inside a released ``.pth``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from m2trans_tpu_torch.models.numerics import ComputePolicy, prepared
from m2trans_tpu_torch.ops import on_device
from m2trans_tpu_torch.ops.kernels.row_norm import row_norm, row_norm_plain
from m2trans_tpu_torch.ops.pixel_shuffle import pixel_shuffle

RGB_MEAN = (0.4488, 0.4371, 0.4040)


# ---------------------------------------------------------------------------
# Modules (parameter holders with the released names)
# ---------------------------------------------------------------------------


class ChannelAttention(nn.Module):
    def __init__(self, dim: int, squeeze: int):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(dim, dim // squeeze, 1), nn.ReLU(),
            nn.Conv2d(dim // squeeze, dim, 1), nn.Sigmoid())


class CAB(nn.Module):
    def __init__(self, dim: int, compress: int, squeeze: int):
        super().__init__()
        self.cab = nn.Sequential(
            nn.Conv2d(dim, dim // compress, 3, 1, 1), nn.GELU(),
            nn.Conv2d(dim // compress, dim, 3, 1, 1), ChannelAttention(dim, squeeze))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)


def add_pixelshuffle_tail(model: nn.Module, dim: int, num_feat: int, scale: int,
                          colors: int = 3) -> None:
    """The released ``pixelshuffle`` upsampler's modules on ``model``:
    ``conv_before_upsample.0``, ``upsample.{0, 2, ...}``, ``conv_last``."""
    model.conv_before_upsample = nn.Sequential(nn.Conv2d(dim, num_feat, 3, 1, 1),
                                               nn.LeakyReLU(inplace=True))
    ups = []
    for _ in range(int(math.log2(scale))):
        ups += [nn.Conv2d(num_feat, 4 * num_feat, 3, 1, 1), nn.PixelShuffle(2)]
    model.upsample = nn.Sequential(*ups)
    model.conv_last = nn.Conv2d(num_feat, colors, 3, 1, 1)


def release_params(ckpt: Any, keys=("params_ema", "params")) -> Dict[str, Any]:
    """The state dict inside a loaded ``.pth``: the first of ``keys`` it
    holds (HAT's release: ``params_ema``, else ``params``), else the dict
    itself."""
    if isinstance(ckpt, dict):
        for key in keys:
            if key in ckpt:
                return ckpt[key]
    return ckpt


def release_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model as the release writes it, on the CPU (``{"params_ema":
    this}`` is a ``.pth``)."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# Forward pieces (NHWC)
# ---------------------------------------------------------------------------


def params(mod: nn.Module, dtype):
    """The module's weight and bias (None where it has none) in ``dtype``:
    themselves where they are (the f32 path), else copies kept on the
    module (``numerics.prepared``)."""
    if mod.weight.dtype == dtype:
        return mod.weight, mod.bias
    if mod.bias is None:
        return prepared(mod, "w", dtype, (mod.weight,), lambda w: (w,))[0], None
    return prepared(mod, "wb", dtype, (mod.weight, mod.bias), lambda w, b: (w, b))


def linear(mod: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    return F.linear(x, *params(mod, dtype))


def conv(mod: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """3x3 (zero pad 1), 1x1 or depthwise conv of NHWC ``x``; the weight
    kept as a channels-last OIHW view, so cuDNN runs NHWC without a
    relayout."""
    if dtype != mod.weight.dtype:
        w, b = prepared(mod, "wb", dtype, (mod.weight, mod.bias),
                        lambda w, b: (w.permute(0, 2, 3, 1), b))
        w = w.permute(0, 3, 1, 2)
    else:
        w, b = mod.weight, mod.bias
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=mod.padding, groups=mod.groups)
    return y.permute(0, 2, 3, 1)


def layer_norm(mod: nn.LayerNorm, x: torch.Tensor, policy: ComputePolicy,
               add: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None,
               gate: Optional[torch.Tensor] = None):
    """``mod``'s LayerNorm of NHWC ``x`` over its channels, in the form of
    ``ops/kernels/row_norm.py`` that the arguments name: plain; with ``add``
    the residual ``x * scale + add`` normed, returned as (residual, normed);
    with ``gate`` the normed map times SiLU(gate). The wrapper where the
    policy runs kernels (forward only on the card; the plain version for
    CPU tensors), else the plain torch composition."""
    w, b = params(mod, policy.dtype)
    if not policy.kernels:
        return row_norm_plain(x, w, b, mod.eps, add=add, scale=scale, gate=gate)
    return row_norm(x.contiguous(), w, b, mod.eps,
                    add=None if add is None else add.contiguous(), scale=scale,
                    gate=None if gate is None else gate.contiguous())


def cab_apply(cab: CAB, x: torch.Tensor, dtype, scale: float = 1.0) -> torch.Tensor:
    """The CAB of NHWC ``x`` (module docstring), times ``scale`` unless it
    is 1."""
    c0, _, c2, ca = cab.cab
    y = conv(c2, F.gelu(conv(c0, x, dtype)), dtype)
    sq, ex = ca.attention[1], ca.attention[3]
    m = y.mean(dim=(1, 2), keepdim=True)  # (B, 1, 1, C): the per-image channel means
    m = torch.sigmoid(conv(ex, torch.relu(conv(sq, m, dtype)), dtype))
    return y * m if scale == 1.0 else y * m * scale


def _rgb_mean(rgb_mean) -> np.ndarray:
    return np.asarray(rgb_mean, np.float32)


def rgb_mean(mean, device) -> torch.Tensor:
    """The (3,) f32 RGB mean on ``device`` (copied there once)."""
    return on_device(_rgb_mean, tuple(mean), device=device)


def normalised_input(x: torch.Tensor, mean: torch.Tensor, img_range: float, dtype):
    """(x - mean) * img_range in ``dtype``, from f32."""
    return ((x.float() - mean) * img_range).to(dtype)


def tail_apply(model: nn.Module, y: torch.Tensor, mean: torch.Tensor, img_range: float,
               dtype) -> torch.Tensor:
    """The pixel-shuffle tail of :func:`add_pixelshuffle_tail`'s modules on
    the body's output plus residual ``y``, the mean added back."""
    y = F.leaky_relu(conv(model.conv_before_upsample[0], y, dtype), 0.01)
    for c in model.upsample[::2]:
        y = pixel_shuffle(conv(c, y, dtype), 2)
    return conv(model.conv_last, y, dtype) / img_range + mean.to(dtype)
