"""MambaIR's work, counted from shapes alone (see :mod:`.counts` for the
HBM rate).

- Per kernel: the port's SS2D scan (``m2t_ss2d_scan``, one launch an SS2D,
  36 a forward). A launch's operands counted once: x read (bf16, d_inner
  channels a pixel), the projected dt / B / C of the four directions read
  (bf16, 4 (R + 2N) a pixel), y written (bf16, d_inner a pixel), the f32
  tables (dt_proj's weight and bias, A, D). Its work: B * 4 * d_inner * N *
  L state updates at 6 FP32 operations each (delta A, delta x B, the FMA
  into h, the FMA into y) at the H100 SXM's non-tensor FP32 peak,
  67 TFLOP/s. The exponential of each update is not counted, so a kernel
  that computes it on either pipe cannot read over 100%.
- Per program: the operations of the plain reference
  (:mod:`h100bench.reference.mambair`) in f32, counted by
  ``FlopCounterMode`` on the meta device: convolutions and matrix
  products, x_proj and dt_proj included. The scan's elementwise work is not
  in it (it is no product).
"""

from __future__ import annotations

from h100bench.core.counts import HBM_BYTES_PER_S

FP32_FLOP_PER_S = 67e12
OPS_PER_UPDATE = 6


def scan_bound_ms(model: dict, bsz: int, h: int, w: int) -> float:
    """The bound of a forward's scan launches (one an SS2D) on (bsz, h, w)
    LR frames: each the larger of its bytes over the HBM rate and its FP32
    operations over the FP32 peak."""
    from h100bench.reference.mambair import K, sizes

    s = sizes(model)
    d, n, r, px = s["d_inner"], s["d_state"], s["dt_rank"], bsz * h * w
    nbytes = 2 * px * (2 * d + K * (r + 2 * n)) + 4 * K * d * (r + 2 + n)
    ops = OPS_PER_UPDATE * float(px * K * d * n)
    one = max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S) * 1e3
    return one * s["groups"] * s["depth"]


def forward_flops(model: dict, bsz: int, h: int, w: int) -> float:
    """Operations of the reference's f32 forward of (bsz, h, w) frames."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from h100bench.reference import mambair as ref

    with torch.device("meta"):
        sd = {n: torch.empty(s) for n, s, _ in ref.param_shapes(model)}
        x = torch.empty(bsz, h, w, model["colors"])
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.forward(sd, x, model)
    return float(counter.get_total_flops())
