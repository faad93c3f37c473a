"""PSNR matching reference utils.py:179-184; port of
m2trans_tpu/metrics/psnr.py."""

from __future__ import annotations

import torch


def calc_psnr(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """-10*log10(mean(((sr-hr)/255)^2)) on 0-255-range inputs, in f32."""
    diff = (sr.float() - hr.float()) / 255.0
    return -10.0 * torch.log10((diff * diff).mean())
