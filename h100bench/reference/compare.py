"""The numbers that decide ``correct``, each held to its own limit.

A cell's limits are in ``h100bench/limits/<cell>.json`` (``{"number":
limit}``); ``PERF.md`` gives the readings each was set from. A run is
correct when every number it compares lies at or under its limit and
every structural check (counts, shapes) holds; a number that could not be
computed (NaN) fails.

Serving (:func:`served_numbers`): over a sample of the requests the window
finished, drawn from the seed, each served frame against the reference's
forward of the same input, in output units ([0, 1], u8 levels / 255):
``mean_abs``, the mean over the sampled frames of a frame's mean |served -
reference|. A mean over the sample and not the worst frame: bf16 rounding
tips near-ties of the seeded, untrained network on a rare frame (one seed
in twelve read 0.0019 on one frame, the port's plain bf16 path as much),
which lies too near the fp8 control's 0.004 (PERF.md).

Training (:func:`train_numbers`): the first steps, as the program took them
and as the reference takes them from the same weights and batches, each
leaf's gap |‖prog‖ - ‖ref‖| over the larger of ‖ref‖ and the median leaf's
‖ref‖: ``loss_gap`` the largest |loss - reference loss| / |reference loss|
over the steps; ``grad_median_gap`` the median leaf's gap of the first
gradient (the program's read from Adam's first moment after one step, m /
(1 - beta1)); ``change_gap`` the worst leaf's gap of the parameters' change
over the steps, leaving out leaves whose reference gradient is under a
thousandth of the median leaf's (they move under Adam by round-off alone);
``sr_gap`` the mean |SR - reference SR| of the first checked batch's LR
through each side's forward from its parameters after the steps, in
output units. ``sr_gap`` is the number a program computing below bf16
fails: a gap of norms grows only with the square of unbiased rounding
noise, and at lambda_clip 0 the fp8 control's gradient and change gaps
stay under three times the sound runs' (PERF.md).
The median leaf and not the worst for the gradient: bf16 rounding moves a
few small leaves of the first blocks by up to 36% on rare seeds, the port's
plain bf16 path as much (PERF.md).
"""

from __future__ import annotations

import json
import math
import os
import statistics
from typing import Dict, List, Sequence

import torch

from h100bench.core.spec import HERE


def limits(cell: str, here: str = HERE) -> Dict[str, float]:
    with open(os.path.join(here, "limits", f"{cell}.json"), encoding="utf-8") as fh:
        return json.load(fh)


def judged(numbers: Dict[str, float], lim: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}`` for every number that has a limit."""
    return {k: {"value": float(numbers[k]), "limit": float(lim[k])} for k in lim}


def passes(checked: Dict[str, Dict[str, float]]) -> bool:
    return all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
               for c in checked.values())


def served_numbers(pairs: Sequence, out: str) -> Dict[str, float]:
    """``pairs``: (served, reference) batches of frames of one request
    each, the reference already as a server hands it out
    (``reference.m2trans.served``)."""
    means: List[float] = []
    for served, ref in pairs:
        if tuple(served.shape) != tuple(ref.shape):
            return {"mean_abs": float("nan")}
        d = (served.float() - ref.float()).abs()
        if out == "u8":
            d = d / 255.0
        means += d.reshape(d.shape[0], -1).mean(dim=1).tolist()
    return {"mean_abs": statistics.fmean(means) if means else float("nan")}


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Sequence[str]) -> List[float]:
    """Each leaf of ``keep``: |‖prog‖ - ‖ref‖| / max(‖ref‖, the median
    leaf's ‖ref‖)."""
    pn, rn = _norms({k: prog[k] for k in keep}), _norms({k: ref[k] for k in keep})
    med = statistics.median(rn.values())
    return [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep]


def moving_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    rn = _norms(ref_grad)
    med = statistics.median(rn.values())
    return [k for k, v in rn.items() if v >= 1e-3 * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` / ``ref``: ``losses`` (one a step), ``grad`` (leaf -> first
    gradient), ``change`` (leaf -> parameters after the steps less before),
    ``sr`` (the first batch's forward after the steps)."""
    if (len(prog["losses"]) != len(ref["losses"]) or set(prog["grad"]) != set(ref["grad"])
            or prog["sr"].shape != ref["sr"].shape):
        return dict.fromkeys(("loss_gap", "grad_median_gap", "change_gap", "sr_gap"),
                             float("nan"))
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    if not all(math.isfinite(a) for a in prog["losses"]):
        loss_gap = float("nan")
    grad = leaf_gaps(prog["grad"], ref["grad"], sorted(ref["grad"]))
    change = leaf_gaps(prog["change"], ref["change"], moving_leaves(ref["grad"]))
    sr_gap = float((prog["sr"].float() - ref["sr"].float()).abs().mean())
    return {"loss_gap": loss_gap, "grad_median_gap": statistics.median(grad),
            "change_gap": max(change), "sr_gap": sr_gap}
