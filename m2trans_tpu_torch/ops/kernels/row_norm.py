"""LayerNorm over the channels of NHWC rows, with the residual sum before it
or the SiLU gate after it taken in: wrapper, launch count and plain version.

Replaces no TPU kernel: the JAX package has neither HAT nor MambaIR. On the
card it is one kernel, ``csrc/row_norm.cu`` (``m2t_row_norm``; its header
has the design and the bound), forward only, in three forms chosen by the
arguments:

    out = row_norm(x, w, b, eps)                        # plain: LN(x)
    x2, out = row_norm(a, w, b, eps, add=b2, scale=s)   # residual in: x2 = a * s + b2, LN(x2)
    out = row_norm(y, w, b, eps, gate=z)                # gated out: LN(y) * SiLU(z)

``scale`` (per channel) is optional in the residual form and belongs to it
alone. :func:`row_norm_plain` is the plain torch composition of each form,
so in bf16 every product, sum and activation rounds to bf16 where the
composition rounds; the kernel rounds at the same places, so ``x2`` is the
plain version's bits and ``out`` differs from it only through the order of
the statistics' f32 sums.

:func:`row_norm` launches the kernel for CUDA tensors (bf16, contiguous, C
a multiple of 4 up to 384, no gradient wanted) and runs the plain version
for CPU tensors only; anything else raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from m2trans_tpu_torch.ops.kernels import build

MAX_C = 384  # the kernel's rows: 96 8-byte vectors a warp (csrc/row_norm.cu)


def row_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                   add: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None,
                   gate: Optional[torch.Tensor] = None):
    """Plain PyTorch version of :func:`row_norm`: the composition the
    kernel replaces, op for op."""
    shape = (x.shape[-1],)
    if add is not None:
        x = (x if scale is None else x * scale) + add
        return x, F.layer_norm(x, shape, weight, bias, eps)
    out = F.layer_norm(x, shape, weight, bias, eps)
    return out if gate is None else out * F.silu(gate)


def _check(x, weight, bias, add, scale, gate):
    """Raise unless the kernel takes the operands."""

    def need(cond, msg):
        if not cond:
            raise ValueError(f"row_norm kernel: {msg}")

    need(x.dim() >= 1 and x.numel() > 0, f"x must be non-empty rows, got {tuple(x.shape)}")
    c = x.shape[-1]
    maps = {"x": x, "add": add, "gate": gate}
    rows = {k: t for k, t in maps.items() if t is not None}
    vecs = {"weight": weight, "bias": bias, "scale": scale}
    vecs = {k: t for k, t in vecs.items() if t is not None}
    need(weight is not None and bias is not None, "weight and bias are required")
    need(add is None or gate is None, "add and gate are two forms, not one")
    need(scale is None or add is not None, "scale belongs to the residual form")
    for name, t in {**rows, **vecs}.items():
        need(t.dtype == torch.bfloat16, f"{name} must be bf16, got {t.dtype}")
        need(t.device == x.device, "all tensors on one device")
        need(t.is_contiguous(), f"{name} must be contiguous rows")
        need(t.data_ptr() % 8 == 0, f"{name} must be 8-byte aligned")
    for name, t in rows.items():
        need(t.shape == x.shape, f"{name} must be {tuple(x.shape)}, got {tuple(t.shape)}")
    for name, t in vecs.items():
        need(t.shape == (c,), f"{name} must be ({c},), got {tuple(t.shape)}")
    need(c % 4 == 0 and 0 < c <= MAX_C, f"C must be a multiple of 4 up to {MAX_C}, got {c}")
    need(not (torch.is_grad_enabled()
              and any(t.requires_grad for t in (*rows.values(), *vecs.values()))),
         "forward only (HAT and MambaIR are served, not trained, by the port)")


def row_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
             add: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None,
             gate: Optional[torch.Tensor] = None):
    """The LayerNorm of ``x``'s rows in the form the arguments name (module
    docstring): the kernel for CUDA tensors, the plain version for CPU
    tensors. Returns ``(x2, out)`` with ``add``, else ``out``."""
    if x.device.type == "cpu":
        return row_norm_plain(x, weight, bias, eps, add, scale, gate)
    if x.device.type != "cuda":
        raise ValueError(f"row_norm: unsupported device {x.device}")
    _check(x, weight, bias, add, scale, gate)
    out = torch.empty_like(x)
    xout = None if add is None else torch.empty_like(x)
    other = add if gate is None else gate

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = build.lib().m2t_row_norm(
        x.data_ptr(), ptr(other), ptr(scale), weight.data_ptr(), bias.data_ptr(), ptr(xout),
        out.data_ptr(), x.numel() // x.shape[-1], x.shape[-1], int(gate is not None),
        float(eps), build.stream_ptr(x.device))
    build.check(code, "m2t_row_norm")
    row_norm.launches += 1
    return out if add is None else (xout, out)


row_norm.launches = 0  # kernel launches, counted at each
