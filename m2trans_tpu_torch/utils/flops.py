"""Model complexity report; port of m2trans_tpu/utils/flops.py, the
equivalent of the reference's ptflops startup report (train.py:148-152) on
the same input: one (384/scale, 384/scale) LR frame.

The JAX package counts with XLA's cost analysis, which also counts the
elementwise work; here ``torch.utils.flop_counter.FlopCounterMode`` counts
the products: the convolutions and the attention's batched matmuls. At x4,
n_feats 64, 8 blocks the two give 17.28 and 13.56 G. The count runs the
plain f32 forward: the counter cannot see a kernel launched through ctypes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import ComputePolicy, M2Trans, m2trans_apply, param_count


def model_flops(model: M2Trans, cfg: Config, h: Optional[int] = None,
                w: Optional[int] = None, batch: int = 1) -> float:
    """Operations of one plain f32 forward of ``batch`` frames at the given
    LR size (default 384/scale square), on the model's device, whatever
    ``cfg``'s dtype and ``use_pallas`` say."""
    h = h or 384 // cfg.scale
    w = w or 384 // cfg.scale
    x = torch.zeros(batch, h, w, cfg.colors, device=next(model.parameters()).device)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        m2trans_apply(model, x, cfg, ComputePolicy())
    return float(counter.get_total_flops())


def model_complexity_report(model: M2Trans, cfg: Config) -> str:
    flops = model_flops(model, cfg)
    n = param_count(model, trainable_only=True)
    return (f"## Flops: {flops / 1e9:.2f} GMac-equiv (torch flop_counter, "
            f"{384 // cfg.scale}x{384 // cfg.scale} input), "
            f"Params: {n / 1e6:.2f} M")
