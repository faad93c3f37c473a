"""The reference's evaluation recipe; port of
m2trans_tpu/metrics/eval_recipe.py.

Reference recipe (train.py:298-312, test.py:101-116): colors==3 -> RGB to
YCbCr, keep Y; shave a ``scale``-px border; x255 when rgb_range==1; then
PSNR and SSIM, always in f32 (a bf16 SR tensor is promoted first); the
test harness (test.py:95-99) adds FSIM and GMSD on full RGB.
"""

from __future__ import annotations

from typing import Dict

import torch

from m2trans_tpu_torch.metrics.color import rgb_to_ycbcr
from m2trans_tpu_torch.metrics.fsim import fsim
from m2trans_tpu_torch.metrics.gmsd import gmsd
from m2trans_tpu_torch.metrics.psnr import calc_psnr
from m2trans_tpu_torch.metrics.ssim import calc_ssim


def sr_eval_metrics(sr: torch.Tensor, hr: torch.Tensor, *, scale: int,
                    colors: int = 3, rgb_range: float = 1.0
                    ) -> Dict[str, torch.Tensor]:
    """PSNR/SSIM of an SR/HR pair (NHWC, [0, rgb_range])."""
    sr, hr = sr.float(), hr.float()
    if colors == 3:
        sr_y = rgb_to_ycbcr(sr)[..., 0:1]
        hr_y = rgb_to_ycbcr(hr)[..., 0:1]
    else:
        sr_y, hr_y = sr, hr
    sr_y = sr_y[:, scale:-scale, scale:-scale, :]
    hr_y = hr_y[:, scale:-scale, scale:-scale, :]
    if rgb_range == 1:
        sr_y = sr_y * 255.0
        hr_y = hr_y * 255.0
    return {"psnr": calc_psnr(sr_y, hr_y), "ssim": calc_ssim(sr_y, hr_y)}


METRICS = ("psnr", "ssim", "fsim", "gmsd")


def frame_metrics(sr: torch.Tensor, hr: torch.Tensor, *, scale: int,
                  colors: int = 3, rgb_range: float = 1.0,
                  full_metrics: bool = False) -> torch.Tensor:
    """A frame's (4,) f32 row of :data:`METRICS`: PSNR/SSIM by
    :func:`sr_eval_metrics`, and with ``full_metrics`` FSIM and GMSD of the
    first image on RGB (else 0). One function for the eager evaluation and
    the metrics graph (``train/evaluate.py``), on the device, no host
    read."""
    m = sr_eval_metrics(sr, hr, scale=scale, colors=colors, rgb_range=rgb_range)
    zero = torch.zeros((), device=sr.device)
    full = ((fsim(hr, sr, data_range=rgb_range)[0], gmsd(hr, sr, data_range=rgb_range)[0])
            if full_metrics else (zero, zero))
    return torch.stack([m["psnr"], m["ssim"], *full])
