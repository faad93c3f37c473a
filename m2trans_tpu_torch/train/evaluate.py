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
shape (JAX ``fwd_single``, jitted per shape, its weights an argument):
:func:`eval_runner`, one ``models/graphed.py::GraphedForward`` a (model,
policy), kept on the model so that every set, every later evaluation and
every validation of a training run replays the graphs already captured.
A weight written in place (an optimizer step, ``load_state_dict``) does
not drop them: their operands are refreshed in place before the next
replay. At most ``EVAL_MAX_GRAPHS`` shapes get a graph, the first ones
seen; a later shape runs the eager forward for as long as the runner
lives, so no shape is captured twice in a run and the pool holds at most
that many shapes' static tensors (two serving captures, 8 x 96x96 and 1 x
512x512, held ~380 MiB on the card, PERF.md §5). ``bucket`` pads the
frames to a few shapes, which is what lets a set of mixed sizes replay
graphs. The sharded forward stays eager, as the JAX package's does.

The metrics (JAX ``_psnr_ssim`` and ``_fsim_pair``, jitted) are a graph
per HR shape too (:class:`GraphedMetrics`, kept on the model beside the
runner): ``metrics/eval_recipe.py::frame_metrics`` of a static SR (a copy
of the forward's output, cropped under ``bucket``) and a static HR, whose
(4,) row of PSNR, SSIM, FSIM and GMSD is kept on the device. Nothing is
read on the host until the set's end, where the rows come back in one copy
and are summed in f64 in frame order: the sums a per-frame host read
gives. ``graphs=False`` runs the same functions eagerly (the CPU always
does). Each frame's LR and HR reach the card through page-locked buffers
(``utils/staging.py``).

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
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data.images import write_image
from m2trans_tpu_torch.metrics import METRICS, frame_metrics
from m2trans_tpu_torch.metrics.fsim import bank_for_frame
from m2trans_tpu_torch.models.graphed import GraphCache, GraphedForward
from m2trans_tpu_torch.ops.pad import pad_to_multiple
from m2trans_tpu_torch.models.m2trans import (
    ComputePolicy,
    M2Trans,
    m2trans_apply,
    policy_from_config,
)
from m2trans_tpu_torch.parallel import spatial
from m2trans_tpu_torch.utils.staging import HostStager


EVAL_MAX_GRAPHS = 8  # shapes an eval runner (and a metrics runner) captures


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


class GraphedMetrics(GraphCache):
    """:func:`~m2trans_tpu_torch.metrics.frame_metrics` replayed from a CUDA
    graph per HR shape (``models/graphed.py::GraphCache``: at most
    ``max_graphs`` shapes, the first ones seen; later shapes run eagerly),
    all in one pool. A call ``(sr, hr)`` returns the graph's static (4,)
    row, valid until the next call; on the CPU the eager row. A graph holds
    the FSIM filter bank it reads (``metrics/fsim.py`` keeps a few banks and
    drops the oldest)."""

    n_inputs = 2  # the SR and the HR frame

    def __init__(self, cfg: Config, full_metrics: bool, device,
                 max_graphs: Optional[int] = EVAL_MAX_GRAPHS):
        super().__init__(device, max_graphs)
        self.kw = dict(scale=cfg.scale, colors=cfg.colors, rgb_range=cfg.rgb_range,
                       full_metrics=full_metrics)

    def _fn(self, sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        return frame_metrics(sr, hr, **self.kw)

    def _capture(self, shape: Tuple[int, ...]):
        entry = super()._capture(shape)
        if self.kw["full_metrics"]:
            entry.held = bank_for_frame(shape[1], shape[2], self.device)
        return entry


def metrics_runner(model: M2Trans, cfg: Config, full_metrics: bool) -> GraphedMetrics:
    """The metrics graphs of evaluations of ``model``: one
    :class:`GraphedMetrics` a recipe, kept on the model beside
    :func:`eval_runner`'s forwards."""
    runners = model.__dict__.setdefault("_metric_runners", {})
    key = (cfg.scale, cfg.colors, cfg.rgb_range, full_metrics)
    if key not in runners:
        runners[key] = GraphedMetrics(cfg, full_metrics, next(model.parameters()).device)
    return runners[key]


def set_means(rows: torch.Tensor) -> Dict[str, float]:
    """The (N, 4) per-frame rows of a set, summed in f64 in frame order
    (the sums a host float holds when each frame's values are read and
    added as they come), over N."""
    sums = [0.0] * len(METRICS)
    for row in rows.cpu().tolist():
        for k, v in enumerate(row):
            sums[k] += v
    return {name: s / rows.shape[0] for name, s in zip(METRICS, sums)}


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
    runner = eval_runner(model, cfg, policy) if graphs else None  # eager on a CPU model

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
    if graphs:
        metrics = metrics_runner(model, cfg, full_metrics)
    else:
        def metrics(sr, hr):
            return frame_metrics(sr, hr, scale=cfg.scale, colors=cfg.colors,
                                 rgb_range=cfg.rgb_range, full_metrics=full_metrics)
    stager = HostStager(dev)
    rows = []
    n = 0
    with torch.inference_mode():
        for lr, hr, name in dataset:
            lr_t, hr_t = stager.stage([lr, hr])
            if bucket > 0:
                h0, w0 = lr_t.shape[1], lr_t.shape[2]
                sr = fwd(pad_to_multiple(lr_t, bucket))[:, : h0 * cfg.scale,
                                                         : w0 * cfg.scale]
            else:
                sr = fwd(lr_t)
            if sr.shape != hr_t.shape:
                raise ValueError(f"{name}: SR {tuple(sr.shape)} != HR "
                                 f"{tuple(hr_t.shape)}")
            if writer is not None and n % 20 == 0:
                from m2trans_tpu_torch.train.loop import _comparison_panel

                panel = _comparison_panel(lr[0], sr[0].float().cpu().numpy(), hr[0],
                                          cfg.rgb_range)
                writer.add_image(f"Valid_{writer_tag}/lr_sr_hr_image", panel,
                                 writer_step + n, dataformats="HWC")
            rows.append(metrics(sr, hr_t).clone())
            n += 1
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                save_image(sr[0].float().cpu().numpy(), os.path.join(save_dir, name))
        means = set_means(torch.stack(rows))
    out = {"psnr": round(means["psnr"] + 5e-3, 2),
           "ssim": round(means["ssim"] + 5e-5, 4)}
    if full_metrics:
        out["fsim"] = round(means["fsim"] + 5e-5, 4)
        out["gmsd"] = round(means["gmsd"] + 5e-5, 4)
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
