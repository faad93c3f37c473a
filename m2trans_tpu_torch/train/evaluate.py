"""Benchmark evaluation; port of m2trans_tpu/train/evaluate.py for the
training loop's validation: the forward under ``torch.inference_mode``,
then the reference's train-val recipe (train.py:258-339), Y-channel
PSNR/SSIM with shave, averaged with the biases ``round(avg + 5e-3, 2)`` /
``round(avg + 5e-5, 4)``. Frames are padded only by the model's own
pad-to-32 rule, so the metrics compare with the reference's.

Not ported yet: FSIM/GMSD (``full_metrics``, the eval CLI's), the
TensorBoard comparison panels (they need ``ops/resize.py``) and bucketed
padding.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data.images import write_image
from m2trans_tpu_torch.metrics.eval_recipe import sr_eval_metrics
from m2trans_tpu_torch.models.m2trans import (
    ComputePolicy,
    M2Trans,
    m2trans_apply,
    policy_from_config,
)


def evaluate_dataset(model: M2Trans, cfg: Config, dataset, *,
                     policy: Optional[ComputePolicy] = None,
                     full_metrics: bool = False,
                     save_dir: Optional[str] = None) -> Dict[str, float]:
    """PSNR/SSIM averaged over a benchmark set, with the reference's
    rounding biases, on the model's device."""
    if full_metrics:
        raise NotImplementedError("full_metrics (FSIM/GMSD) is not yet ported")
    policy = policy or policy_from_config(cfg)
    dev = next(model.parameters()).device
    sums = {"psnr": 0.0, "ssim": 0.0}
    n = 0
    with torch.inference_mode():
        for lr, hr, name in dataset:
            sr = m2trans_apply(model, torch.from_numpy(lr).to(dev), cfg, policy)
            hr_t = torch.from_numpy(hr).to(dev)
            assert sr.shape == hr_t.shape, (sr.shape, hr_t.shape)
            m = sr_eval_metrics(sr, hr_t, scale=cfg.scale, colors=cfg.colors,
                                rgb_range=cfg.rgb_range)
            sums["psnr"] += float(m["psnr"])
            sums["ssim"] += float(m["ssim"])
            n += 1
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                save_image(sr[0].float().cpu().numpy(), os.path.join(save_dir, name))
    return {"psnr": round(sums["psnr"] / n + 5e-3, 2),
            "ssim": round(sums["ssim"] / n + 5e-5, 4)}


def save_image(img_hwc: np.ndarray, path: str) -> None:
    """[0, 1] HWC float -> uint8 image file (round half up, clipped)."""
    write_image(path, np.clip(img_hwc * 255.0 + 0.5, 0, 255).astype(np.uint8))


def evaluate_all(model: M2Trans, cfg: Config, eval_sets: List[Dict], *,
                 policy: Optional[ComputePolicy] = None,
                 full_metrics: bool = False,
                 save_root: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    results = {}
    for item in eval_sets:
        save_dir = os.path.join(save_root, item["name"]) if save_root else None
        results[item["name"]] = evaluate_dataset(
            model, cfg, item["dataset"], policy=policy,
            full_metrics=full_metrics, save_dir=save_dir)
    return results
