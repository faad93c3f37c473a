"""One count of the work, shared by ``chip_smoke.py``'s kernel bounds and
``python -m m2trans_tpu_torch.tools.roofline``.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in f32 outside
them, 3.35 TB/s of HBM.

Per kernel (:func:`bound` and the counts beside it): the bytes its operands
take, each once, and its operations, counted from the shapes of one call.

Per program: the function's operations, counted once by
``torch.utils.flop_counter.FlopCounterMode`` on the plain f32 path
(:func:`step_flops`; the forward's is ``utils/flops.py::model_flops``),
which sees the convolutions and matrix products, whatever runs the function
on the card (the counter cannot see a kernel launched through ctypes, and a
count must not move when a kernel changes how it works); and the bytes the
program must move at least (:func:`forward_bytes`, :func:`step_bytes`).
Both depend only on the shapes, the scale, the width, the depth and the
loss, never on ``use_pallas`` or the config's dtype.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

HBM_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM, data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak, data sheet
F32_FLOP_PER_S = 67e12      # f32 outside the tensor cores, data sheet
TOKENS = 64                 # the semantic loss's token ids a caption


def nbytes(*tensors) -> int:
    """Bytes of the operands, each counted once (a channel slice counts its
    own elements)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: float, flops: float, flop_per_s: float = BF16_FLOP_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over ``flop_per_s`` (the bf16
    tensor-core peak; the f32 rate for a kernel whose products are f32
    FMAs)."""
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_f = flops / flop_per_s * 1e3
    return {"bound_ms": max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def add_bounds(*bs) -> dict:
    """The bound of several launches in a row (their sum); bound_by is that
    of the largest share."""
    top = max(bs, key=lambda b: b["bound_ms"])
    return {"bound_ms": sum(b["bound_ms"] for b in bs), "bound_by": top["bound_by"]}


def swin_attn_flops(x, heads: int, window: int = 7, backward: bool = False) -> float:
    """Operations of MedCLIP's window attention on the (B, H, W, C) map x:
    Q K^T and P V, 2 n^2 hd each per window and head (n = window^2); the
    backward recomputes Q K^T and forms dP, dV, dK and dQ, five such
    products."""
    b, h, w, c = x.shape
    n = window * window
    per = 2 * n * n * (c // heads) * (5 if backward else 2)
    return float(per * b * (h // window) * (w // window) * heads)


def branch_flops(x, levels: int) -> float:
    """Operations of one wavelet branch on x (B, H, W, cb): the qkv
    projection, 2 * 3C^2 per coarse pixel, and q k^T and P v over the 100
    keys of each query, 2 * 2 * 100 * C per coarse pixel."""
    bsz, h, w, cb = x.shape
    c, n = cb * 4 ** levels, bsz * h * w // 4 ** levels
    return n * (6.0 * c * c + 400.0 * c)


def tail_flops(y, scale: int) -> float:
    """Operations of the tail on y (B, H, W, nf): the 1x1 stages and the 3x3
    conv to 3 channels at the output resolution."""
    n, nf = y.shape[0] * y.shape[1] * y.shape[2], y.shape[3]
    if scale == 4:
        stages = 2.0 * n * nf * 4 * nf + 2.0 * 4 * n * nf * 4 * nf
    else:
        stages = 2.0 * n * nf * nf * scale * scale
    return stages + 2.0 * scale * scale * n * 9 * nf * 3


def step_flops(model, cfg, batch: int, h: int, w: int,
               semantic_loss_fn=None) -> float:
    """Operations of one train step of ``batch`` LR frames of h x w on the
    plain f32 path: the forward, L1 and, with ``semantic_loss_fn``, the
    semantic loss (its constant stage: BERT on ``TOKENS`` tokens and the
    HR-side MedCLIP forward; its SR-side forward), and the backward to the
    trainable parameters (through the SR-side MedCLIP where the loss is on).
    Adam's elementwise update has no product to count. Runs on the model's
    device; the model is not changed."""
    from m2trans_tpu_torch.models.m2trans import ComputePolicy, m2trans_apply

    dev = next(model.parameters()).device
    s = cfg.scale
    gen = torch.Generator().manual_seed(0)
    lr = torch.rand(batch, h, w, cfg.colors, generator=gen).to(dev)
    hr = torch.rand(batch, h * s, w * s, 3, generator=gen).to(dev)
    params = [p for p in model.parameters() if p.requires_grad]
    counter = FlopCounterMode(display=False)
    with counter:
        sr = m2trans_apply(model, lr, cfg, ComputePolicy())
        loss = (sr - hr).abs().mean()
        if semantic_loss_fn is not None:
            fn = semantic_loss_fn
            caps = {"input_ids": np.full((batch, TOKENS), 5, np.int64),
                    "attention_mask": np.ones((batch, TOKENS), np.int64)}
            with torch.no_grad():
                const = fn.const_stage_from_params(fn.model, hr, caps,
                                                   rng=np.random.default_rng(0))
            loss = loss + fn.loss_staged_from_params(fn.model, sr, const)
        torch.autograd.grad(loss, params, allow_unused=True)
    return float(counter.get_total_flops())


def forward_bytes(cfg, n_params: int, batch: int, h: int, w: int, itemsize: int) -> float:
    """Compulsory bytes of a forward: the LR input, the SR output and the
    weights, each once, at ``itemsize`` bytes (the policy's dtype)."""
    s = cfg.scale
    return float(itemsize * (batch * h * w * cfg.colors + batch * h * s * w * s * 3
                             + n_params))


def step_bytes(cfg, n_params: int, batch: int, h: int, w: int, itemsize: int,
               medclip_params: int = 0) -> float:
    """Compulsory bytes of a train step: the forward's (:func:`forward_bytes`),
    the HR target, the f32 gradients and Adam's two f32 moments each read and
    written once, the f32 parameters written once; with the semantic loss
    MedCLIP's f32 weights read once and the int64 token ids and mask."""
    s = cfg.scale
    hr = itemsize * batch * h * s * w * s * 3
    adam = 4 * n_params * (2 + 2 * 2 + 1)
    clip = (medclip_params * 4 + 2 * 8 * batch * TOKENS
            if medclip_params else 0)
    return forward_bytes(cfg, n_params, batch, h, w, itemsize) + hr + adam + clip


def shares(flops: float, bytes_moved: float, device_ms: Optional[float],
           f32: bool = False) -> Dict[str, Optional[float]]:
    """A program's shares of the card's peaks over its device time:
    ``mfu`` = operations / (device s x 989e12), ``hbm_floor_share`` = bytes /
    (device s x 3.35e12) and, for a program with f32 products,
    ``mfu_f32_peak`` = operations / (device s x 67e12). None where the
    device time was not measured."""
    sec = None if device_ms is None else device_ms / 1e3
    out = {"mfu": None if sec is None else flops / (sec * BF16_FLOP_PER_S),
           "hbm_floor_share": None if sec is None else bytes_moved / (sec * HBM_BYTES_PER_S)}
    if f32:
        out["mfu_f32_peak"] = None if sec is None else flops / (sec * F32_FLOP_PER_S)
    return out
