"""Pixel-space reconstruction losses; port of
m2trans_tpu/losses/pixel.py."""

from __future__ import annotations

import torch


def l1_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """Mean absolute error in f32 (reference train.py:76,198-199)."""
    return (sr.float() - hr.float()).abs().mean()


def charbonnier_loss(sr: torch.Tensor, hr: torch.Tensor,
                     eps2: float = 1e-6) -> torch.Tensor:
    """L1-Charbonnier (reference losses.py:287-297; unused by the default
    training recipe)."""
    diff = sr.float() - hr.float()
    return torch.sqrt(diff * diff + eps2).mean()
