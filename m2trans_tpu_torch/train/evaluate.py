"""Benchmark evaluation; port of m2trans_tpu/train/evaluate.py: the
forward under ``torch.inference_mode``, then the metrics on the model's
device in f32. Both of the reference's recipes:

  * train-val (train.py:258-339): Y-channel PSNR/SSIM with shave, averaged
    with the biases ``round(avg + 5e-3, 2)`` / ``round(avg + 5e-5, 4)``;
  * the test harness (test.py:77-122): also FSIM/GMSD on full RGB *before*
    the Y conversion, with their own +5e-5 biases (``full_metrics``).

By default frames are padded only by the model's own pad-to-32 rule, so the
metrics compare with the reference's; ``bucket`` pads further.

Not ported yet: the TensorBoard comparison panels (they need
``ops/resize.py``) and the automatic spatial sharding of large frames
(one device).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data.images import write_image
from m2trans_tpu_torch.metrics import fsim, gmsd, sr_eval_metrics
from m2trans_tpu_torch.ops.pad import pad_to_multiple
from m2trans_tpu_torch.models.m2trans import (
    ComputePolicy,
    M2Trans,
    m2trans_apply,
    policy_from_config,
)


def evaluate_dataset(model: M2Trans, cfg: Config, dataset, *,
                     policy: Optional[ComputePolicy] = None,
                     full_metrics: bool = False,
                     save_dir: Optional[str] = None,
                     bucket: int = 0) -> Dict[str, float]:
    """PSNR/SSIM (and with ``full_metrics`` FSIM/GMSD) averaged over a
    benchmark set, with the reference's rounding biases, on the model's
    device.

    ``bucket > 0`` reflect-pads every LR frame up to a multiple of
    ``bucket`` before the forward and crops the SR back, so frames of many
    sizes share a few shapes. APPROXIMATE: the extra padding context
    perturbs border pixels slightly; the default (0) evaluates exactly
    like the reference."""
    policy = policy or policy_from_config(cfg)
    dev = next(model.parameters()).device
    sums = {"psnr": 0.0, "ssim": 0.0, "fsim": 0.0, "gmsd": 0.0}
    n = 0
    with torch.inference_mode():
        for lr, hr, name in dataset:
            lr_t = torch.from_numpy(lr).to(dev)
            if bucket > 0:
                h0, w0 = lr_t.shape[1], lr_t.shape[2]
                sr = m2trans_apply(model, pad_to_multiple(lr_t, bucket), cfg,
                                   policy)[:, : h0 * cfg.scale, : w0 * cfg.scale]
            else:
                sr = m2trans_apply(model, lr_t, cfg, policy)
            hr_t = torch.from_numpy(hr).to(dev)
            if sr.shape != hr_t.shape:
                raise ValueError(f"{name}: SR {tuple(sr.shape)} != HR "
                                 f"{tuple(hr_t.shape)}")
            if full_metrics:
                sums["fsim"] += float(fsim(hr_t, sr, data_range=cfg.rgb_range)[0])
                sums["gmsd"] += float(gmsd(hr_t, sr, data_range=cfg.rgb_range)[0])
            m = sr_eval_metrics(sr, hr_t, scale=cfg.scale, colors=cfg.colors,
                                rgb_range=cfg.rgb_range)
            sums["psnr"] += float(m["psnr"])
            sums["ssim"] += float(m["ssim"])
            n += 1
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                save_image(sr[0].float().cpu().numpy(), os.path.join(save_dir, name))
    out = {"psnr": round(sums["psnr"] / n + 5e-3, 2),
           "ssim": round(sums["ssim"] / n + 5e-5, 4)}
    if full_metrics:
        out["fsim"] = round(sums["fsim"] / n + 5e-5, 4)
        out["gmsd"] = round(sums["gmsd"] / n + 5e-5, 4)
    return out


def save_image(img_hwc: np.ndarray, path: str) -> None:
    """[0, 1] HWC float -> uint8 image file (round half up, clipped)."""
    write_image(path, np.clip(img_hwc * 255.0 + 0.5, 0, 255).astype(np.uint8))


def evaluate_all(model: M2Trans, cfg: Config, eval_sets: List[Dict], *,
                 policy: Optional[ComputePolicy] = None,
                 full_metrics: bool = False,
                 save_root: Optional[str] = None,
                 bucket: int = 0) -> Dict[str, Dict[str, float]]:
    results = {}
    for item in eval_sets:
        save_dir = os.path.join(save_root, item["name"]) if save_root else None
        results[item["name"]] = evaluate_dataset(
            model, cfg, item["dataset"], policy=policy,
            full_metrics=full_metrics, save_dir=save_dir, bucket=bucket)
    return results
