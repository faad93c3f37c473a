"""The work of a forward or a train step, counted from shapes alone.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM.

- Per kernel: K1 (the fused CFTM branch) and K1b (its VJP), each launch's
  operands counted once and its products from the shapes: frozen copies of
  ``m2trans_tpu_torch/utils/roofline.py::branch_flops`` / ``bound`` and of
  the K1 / K1b bounds ``chip_smoke.py`` builds on them (commit 462c782).
  The count does not depend on how a kernel works.
- Per program: the operations of the plain reference in f32
  (:mod:`h100bench.reference`), counted by ``FlopCounterMode`` on the meta
  device (shapes only, no data): the convolutions and matrix products of
  the forward, or of the train step (forward, L1, the semantic loss, the
  backward to the trainable parameters; Adam's elementwise update has no
  product). This stands in for ``utils/flops.py::model_flops`` and
  ``utils/roofline.py::step_flops``, which count the port's own plain path.
"""

from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
PAD_MULTIPLE = 32
BRANCHES = ((0, False), (1, True), (2, True), (2, True))  # (levels, cascade input)


def bound_ms(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the bf16 tensor-core peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3


def branch_flops(bsz: int, h: int, w: int, cb: int, levels: int) -> float:
    """Operations of one wavelet branch on (B, H, W, cb): the qkv projection,
    2 * 3C^2 per coarse pixel, and q k^T and P v over the 100 keys of each
    query, 2 * 2 * 100 * C per coarse pixel (C = cb * 4^levels)."""
    c, n = cb * 4 ** levels, bsz * h * w // 4 ** levels
    return n * (6.0 * c * c + 400.0 * c)


def _branch_bytes(bsz: int, h: int, w: int, cb: int, levels: int, cascade: bool):
    """Operand bytes of one K1 launch: x (bf16), the qkv weight (bf16,
    C x 3C), rel_h and rel_w (f32, 10 x C/2 each), s and t (f32, B x cb),
    the cascade input where there is one (bf16); and its output (bf16)."""
    c = cb * 4 ** levels
    act = 2 * bsz * h * w * cb
    return act * (2 if cascade else 1), 2 * c * 3 * c + 2 * 4 * 10 * (c // 2) + 2 * 4 * bsz * cb, act


def padded(n: int) -> int:
    return -(-n // PAD_MULTIPLE) * PAD_MULTIPLE


def k1_bound_ms(model: dict, bsz: int, h: int, w: int) -> float:
    """The bound of a forward's K1 launches (4 a CFTM) on a batch of
    (bsz, h, w) LR frames (padded to 32): each launch reads its operands and
    writes its output once."""
    hp, wp, cb = padded(h), padded(w), model["n_feats"] // 4
    total = 0.0
    for levels, cascade in BRANCHES:
        acts, weights, out = _branch_bytes(bsz, hp, wp, cb, levels, cascade)
        total += bound_ms(acts + weights + out, branch_flops(bsz, hp, wp, cb, levels))
    return total * model["n_blocks"]


def k1b_bound_ms(model: dict, bsz: int, h: int, w: int) -> float:
    """The bound of a step's K1b launch groups (one a branch): each reads
    the forward's operands and the cotangent and writes a gradient for each
    operand, with twice the forward's products."""
    hp, wp, cb = padded(h), padded(w), model["n_feats"] // 4
    total = 0.0
    for levels, cascade in BRANCHES:
        acts, weights, out = _branch_bytes(bsz, hp, wp, cb, levels, cascade)
        total += bound_ms(2 * (acts + weights) + out,
                          2 * branch_flops(bsz, hp, wp, cb, levels))
    return total * model["n_blocks"]


def forward_flops(model: dict, bsz: int, h: int, w: int) -> float:
    """Operations of the reference's f32 forward of (bsz, h, w) frames."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from h100bench.reference import m2trans as ref

    with torch.device("meta"):
        sd = {n: torch.empty(s) for n, s, _ in ref.param_shapes(model)}
        x = torch.empty(bsz, h, w, model["colors"])
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.forward(sd, x, model)
    return float(counter.get_total_flops())


def step_flops(model: dict, bsz: int, h: int, w: int, clip: Optional[dict],
               lambda_clip: float, tokens: int = 64) -> float:
    """Operations of the reference's f32 train step on (bsz, h, w) LR
    frames: forward, L1, with ``clip`` (the MedCLIP sizes) and
    ``lambda_clip`` > 0 the semantic loss (BERT on ``tokens`` tokens, both
    sides' vision encoders), and the backward to the trainable
    parameters."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from h100bench.reference import m2trans as ref
    from h100bench.reference import medclip as ref_clip

    s = model["scale"]
    with torch.device("meta"):
        sd = {n: torch.empty(sh, requires_grad=n not in ref.FROZEN)
              for n, sh, _ in ref.param_shapes(model)}
        x = torch.empty(bsz, h, w, model["colors"])
        hr = torch.empty(bsz, h * s, w * s, 3)
        csd = ({n: torch.empty(sh) for n, sh, _ in ref_clip.param_shapes(clip)}
               if clip and lambda_clip > 0 else None)
        ids = torch.zeros(bsz, tokens, dtype=torch.long)
    counter = FlopCounterMode(display=False)
    with counter:
        sr = ref.forward(sd, x, model)
        loss = (sr - hr).abs().mean()
        if csd is not None:
            zeros = [[0] * bsz] * (clip["n_patches"] - 1)
            loss = loss + lambda_clip * ref_clip.semantic_loss(
                csd, clip, sr, hr, ids, ids, zeros, zeros)
        torch.autograd.grad(loss, [p for n, p in sd.items() if n not in ref.FROZEN])
    return float(counter.get_total_flops())
