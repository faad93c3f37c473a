"""Normalization ops (NHWC); port of m2trans_tpu/ops/norm.py."""

from __future__ import annotations

import torch


def in_stats(x: torch.Tensor, eps: float = 1e-5):
    """Per image x channel instance-norm affine ``(inv_std, -mean*inv_std)``,
    both (B, C) f32, statistics taken in f32 with the biased variance
    E[x^2] - E[x]^2 (the fused CFTM's form, m2trans_tpu/models/m2trans.py
    ``_cftm_apply_fused``)."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2))
    var = xf.square().mean(dim=(1, 2)) - mean.square()
    inv = torch.rsqrt(var + eps)
    return inv, -mean * inv


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Instance normalization over H, W of an NHWC tensor, no affine.

    Matches ``torch.nn.InstanceNorm2d(nf)`` defaults (biased variance,
    eps 1e-5). Statistics are taken in f32 whatever the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = x32.var(dim=(1, 2), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
