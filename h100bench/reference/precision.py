"""The precision a reference computes its products in.

``Precision("f32")`` leaves every operand as it is. ``Precision("fp8")`` is
the control of a bf16 configuration: every operand of a product (a
convolution, a matrix product, the attention's two products) is rounded to
float8 e4m3 with a per-tensor scale (448 over its largest magnitude), the
way an fp8 path feeds the tensor cores, and so is the gradient that flows
back into each product's output (:meth:`Precision.out`), so the backward's
products take fp8 operands too; the products accumulate in f32 and
everything between products stays f32.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, as f32."""
    scale = E4M3_MAX / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class _GradFp8(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient to fp8."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Precision:
    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a product's operand in this precision (straight through
        in the backward)."""
        if self.kind == "f32":
            return t
        with torch.no_grad():
            q = _fp8(t.detach())
        return t + (q - t.detach())

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output ``y``: in fp8 the gradient into it is rounded
        to fp8 before the backward's products take it."""
        if self.kind == "f32" or not y.requires_grad:
            return y
        return _GradFp8.apply(y)


F32 = Precision("f32")


@contextlib.contextmanager
def full_f32():
    """Matrix products and convolutions in full f32 (TF32 off)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
