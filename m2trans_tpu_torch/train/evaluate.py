"""Benchmark evaluation; port of m2trans_tpu/train/evaluate.py: the
forward under ``torch.inference_mode``, then the metrics on the model's
device in f32. Both of the reference's recipes:

  * train-val (train.py:258-339): Y-channel PSNR/SSIM with shave, averaged
    with the biases ``round(avg + 5e-3, 2)`` / ``round(avg + 5e-5, 4)``;
  * the test harness (test.py:77-122): also FSIM/GMSD on full RGB *before*
    the Y conversion, with their own +5e-5 biases (``full_metrics``).

By default frames are padded only by the model's own pad-to-32 rule, so the
metrics compare with the reference's; ``bucket`` pads further.

On a CUDA model the single-device forward replays a CUDA graph per LR
shape (JAX ``fwd_single``, jitted per shape): :func:`eval_runner`, one
``models/graphed.py::GraphedForward`` a (model, policy), kept on the model
so that every set and every later evaluation of the same weights replays
the graphs already captured. Its graphs are dropped when a weight moves
(the next frame captures again) and bounded: at most ``EVAL_MAX_GRAPHS``
shapes are held, the least recently replayed dropped first, so the pool
holds at most that many shapes' static tensors (two serving captures, 8 x
96x96 and 1 x 512x512, held ~380 MiB on the card, PERF.md §5). A capture
costs about 3-7 eager forwards of its frame (PERF.md §6), so a set
with a shape a frame pays a capture a frame; ``bucket`` pads the frames to
a few shapes, which is what lets a set of mixed sizes replay its graphs.
``graphs=False`` runs the forward eagerly, as the Trainer's validation
does (``train/loop.py``): its weights moved since the last validation, so
every shape would capture again. The sharded forward stays eager, as the
JAX package's does.

With more than one rank (``python -m torch.distributed.run``) every rank
runs the same evaluation and bf16 frames of 512x512 pixels or more are
sharded by rows over the ranks (:func:`make_forward_fn`, JAX
``make_forward_fn(auto_space=True)``); f32 parity stays single-device.

With a TensorBoard ``writer`` every 20th frame of a set adds a [bilinear
LR-up | SR | HR] panel, ``Valid_<set>/lr_sr_hr_image`` at step
``writer_step + n`` (reference train.py:281-296).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data.images import write_image
from m2trans_tpu_torch.metrics import fsim, gmsd, sr_eval_metrics
from m2trans_tpu_torch.models.graphed import GraphedForward
from m2trans_tpu_torch.ops.pad import pad_to_multiple
from m2trans_tpu_torch.models.m2trans import (
    ComputePolicy,
    M2Trans,
    m2trans_apply,
    policy_from_config,
)
from m2trans_tpu_torch.parallel import spatial


EVAL_MAX_GRAPHS = 8  # shapes whose graphs an eval runner holds


def eval_runner(model: M2Trans, cfg: Config, policy: ComputePolicy) -> GraphedForward:
    """The graphed eval forward of ``model`` under ``policy``: one
    ``GraphedForward`` kept on the model (not in its state_dict) and made
    anew only for another config, so that it outlives an evaluation."""
    runners = model.__dict__.setdefault("_eval_runners", {})
    runner = runners.get(policy)
    if runner is None or runner.cfg != cfg:
        runner = runners[policy] = GraphedForward(model, cfg, policy,
                                                  max_graphs=EVAL_MAX_GRAPHS)
    return runner


def make_forward_fn(model: M2Trans, cfg: Config,
                    policy: Optional[ComputePolicy] = None,
                    auto_space: bool = True, graphs: bool = True):
    """A forward ``lr -> sr``. With ``auto_space`` a frame that
    :func:`~m2trans_tpu_torch.parallel.spatial.auto_space_mesh` picks a mesh
    for (bf16, more than one rank, a large frame) goes through the sharded
    forward over the ranks, which must all call it with the same frame; a
    rank outside that mesh runs the single-device forward. On a CUDA model
    with ``graphs`` the single-device forward replays :func:`eval_runner`'s
    graphs; its result (f32) is valid until the next call."""
    policy = policy or policy_from_config(cfg)
    cuda = next(model.parameters()).device.type == "cuda"
    runner = eval_runner(model, cfg, policy) if graphs and cuda else None

    def fwd(lr: torch.Tensor) -> torch.Tensor:
        mesh = (spatial.auto_space_mesh(lr.shape[1], lr.shape[2], cfg, policy)
                if auto_space else None)
        if mesh is None or mesh.rank < 0:
            if runner is not None:
                return runner(lr)
            return m2trans_apply(model, lr, cfg, policy)
        return spatial.spatial_sharded_forward(model, lr, cfg, mesh=mesh,
                                               policy=policy)

    return fwd


def evaluate_dataset(model: M2Trans, cfg: Config, dataset, *,
                     policy: Optional[ComputePolicy] = None,
                     full_metrics: bool = False,
                     save_dir: Optional[str] = None,
                     writer=None,
                     writer_tag: Optional[str] = None,
                     writer_step: int = 0,
                     bucket: int = 0,
                     auto_space: bool = True,
                     graphs: bool = True) -> Dict[str, float]:
    """PSNR/SSIM (and with ``full_metrics`` FSIM/GMSD) averaged over a
    benchmark set, with the reference's rounding biases, on the model's
    device. ``auto_space`` and ``graphs``: see :func:`make_forward_fn`.
    With a ``writer`` every 20th frame emits its comparison panel (see the
    module docstring).

    ``bucket > 0`` reflect-pads every LR frame up to a multiple of
    ``bucket`` before the forward and crops the SR back, so frames of many
    sizes share a few shapes. APPROXIMATE: the extra padding context
    perturbs border pixels slightly; the default (0) evaluates exactly
    like the reference."""
    fwd = make_forward_fn(model, cfg, policy, auto_space, graphs)
    dev = next(model.parameters()).device
    sums = {"psnr": 0.0, "ssim": 0.0, "fsim": 0.0, "gmsd": 0.0}
    n = 0
    with torch.inference_mode():
        for lr, hr, name in dataset:
            lr_t = torch.from_numpy(lr).to(dev)
            if bucket > 0:
                h0, w0 = lr_t.shape[1], lr_t.shape[2]
                sr = fwd(pad_to_multiple(lr_t, bucket))[:, : h0 * cfg.scale,
                                                         : w0 * cfg.scale]
            else:
                sr = fwd(lr_t)
            hr_t = torch.from_numpy(hr).to(dev)
            if sr.shape != hr_t.shape:
                raise ValueError(f"{name}: SR {tuple(sr.shape)} != HR "
                                 f"{tuple(hr_t.shape)}")
            if writer is not None and n % 20 == 0:
                from m2trans_tpu_torch.train.loop import _comparison_panel

                panel = _comparison_panel(lr[0], sr[0].float().cpu().numpy(), hr[0],
                                          cfg.rgb_range)
                writer.add_image(f"Valid_{writer_tag}/lr_sr_hr_image", panel,
                                 writer_step + n, dataformats="HWC")
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
                 writer=None,
                 writer_step: int = 0,
                 bucket: int = 0,
                 auto_space: bool = True,
                 graphs: bool = True) -> Dict[str, Dict[str, float]]:
    results = {}
    for item in eval_sets:
        save_dir = os.path.join(save_root, item["name"]) if save_root else None
        results[item["name"]] = evaluate_dataset(
            model, cfg, item["dataset"], policy=policy,
            full_metrics=full_metrics, save_dir=save_dir, writer=writer,
            writer_tag=item["name"], writer_step=writer_step, bucket=bucket,
            auto_space=auto_space, graphs=graphs)
    return results
