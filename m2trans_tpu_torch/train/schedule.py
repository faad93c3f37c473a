"""Learning-rate schedule; port of m2trans_tpu/train/schedule.py: torch
CosineAnnealingLR stepped per epoch (reference train.py:82,358), in closed
form: lr(e) = eta_min + (lr0 - eta_min) * (1 + cos(pi * e / T_max)) / 2,
with e the completed epochs (0-based during epoch e+1) and T_max the total
epochs."""

from __future__ import annotations

import math


def cosine_annealing_lr(epoch0: int, *, base_lr: float, eta_min: float,
                        t_max: int) -> float:
    """LR used during epoch ``epoch0 + 1`` (0-based completed-epoch count)."""
    return eta_min + (base_lr - eta_min) * (
        1.0 + math.cos(math.pi * epoch0 / t_max)) / 2.0
