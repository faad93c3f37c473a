"""The first steps of M2Trans training, in plain PyTorch.

From the same f32 weights and the same batches the program took: the
reference forward (:mod:`.m2trans`), L1 (the mean of |SR - HR|) times
``lambda_l1``, plus ``lambda_clip`` times the semantic loss
(:mod:`.medclip`) where it is on, the gradient of that loss to every
trainable tensor (all but the frozen MeanShift convs), and Adam (betas 0.9
/ 0.999, eps 1e-8, no weight decay, bias-corrected as ``torch.optim.Adam``
does) at a fixed ``lr``. Returns each step's loss, the first step's
gradients, the parameters' change over the steps and the forward of the
first batch's LR from the parameters after them (``sr``).

``fault`` plants a fault in the reference put in the program's place:
"half_batch" drops the second half of every batch and takes the mean
over the rest.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from h100bench.reference import m2trans as ref
from h100bench.reference import medclip as ref_clip
from h100bench.reference.precision import F32, Precision, full_f32

BETAS, EPS = (0.9, 0.999), 1e-8


def train_steps(sd0: Dict[str, torch.Tensor], model: dict, batches: Sequence,
                *, lr: float, lambda_l1: float = 1.0, lambda_clip: float = 0.0,
                clip: Optional[dict] = None, prec: Precision = F32,
                fault: Optional[str] = None) -> dict:
    """``batches``: (lr, hr) float32 NHWC arrays a step; ``clip``: the
    semantic loss's ``sd`` and ``cfg`` and, a step, its ``tokens`` ((ids,
    mask) tensors) and ``offsets`` ((ys, xs) arrays, crop-major)."""
    dev = next(iter(sd0.values())).device
    names = [k for k in sd0 if k not in ref.FROZEN]
    params = {k: v.detach().clone().requires_grad_(k in names) for k, v in sd0.items()}
    m = {k: torch.zeros_like(params[k]) for k in names}
    v = {k: torch.zeros_like(params[k]) for k in names}
    losses, first = [], None
    with full_f32():
        for step, (lr_np, hr_np) in enumerate(batches, 1):
            x = torch.as_tensor(lr_np).to(dev).float()
            y = torch.as_tensor(hr_np).to(dev).float()
            keep = x.shape[0] // 2 if fault == "half_batch" else x.shape[0]
            x, y = x[:keep], y[:keep]
            sr = ref.forward(params, x, model, prec)
            loss = lambda_l1 * (sr - y).abs().mean()
            if clip is not None and lambda_clip > 0:
                ids, mask = (t[:keep] for t in clip["tokens"][step - 1])
                ys, xs = ([row[:keep] for row in o] for o in clip["offsets"][step - 1])
                loss = loss + lambda_clip * ref_clip.semantic_loss(
                    clip["sd"], clip["cfg"], sr, y, ids, mask, ys, xs, prec)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in zip(names, grads)}
            with torch.no_grad():
                b1, b2 = BETAS
                for k, g in zip(names, grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[k].sqrt() / (1 - b2 ** step) ** 0.5).add_(EPS)
                    params[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** step))
        with torch.no_grad():
            x = torch.as_tensor(batches[0][0]).to(dev).float()
            sr = ref.forward(params, x, model, prec)
    change = {k: params[k].detach() - sd0[k] for k in names}
    return {"losses": losses, "grad": first, "change": change, "sr": sr.cpu()}
