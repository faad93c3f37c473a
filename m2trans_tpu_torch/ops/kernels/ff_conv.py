"""K3, the CFTM's fused feed-forward conv: wrapper, launch count and plain
version.

Replaces the TPU kernels ``ff_pair_conv_fused``
(m2trans_tpu/ops/pallas/ff_pair.py, ``_kernel``) and ``packed_ff_conv``
(m2trans_tpu/ops/pallas/ff_packed.py, ``_kernel``). Lane packing and the
pair-major permutation were TPU choices; on the card they are one kernel,
``csrc/ff_conv.cu``. Bytes bind it (three tensors moved for 2*9*C FLOP a
value), so its design keeps the memory system busy while the tensor cores
work: a persistent grid of one block per SM that holds the 9*C*C weight in
shared memory for all its 8x16-pixel tiles, up to four groups of four warps
that each fill their own 10x18xC window buffer with ``cp.async`` (zero-fill
beyond the frame) while the other groups multiply or store, the nine
shifted products on ``mma.sync.m16n8k16`` with ``ldmatrix`` operands, and
an epilogue of 16-byte vectors. Its header has the detail and the reason
``wgmma`` was not taken.

    out = bf16( bf16( bf16(conv3x3_zeros(oc, w)) + b ) + x )

oc, x: (B, H, W, C) contiguous NHWC bf16; w: (3, 3, C_in, C_out) bf16
(:func:`ff_weight_hwio` lays it out from the module's OIHW weight);
b: (C,) bf16.

:func:`ff_conv` launches the kernel for CUDA tensors and runs
:func:`ff_conv_plain` for CPU tensors only; anything else raises. The TPU
kernels have no backward kernel (their custom_vjp differentiates the XLA
composition), so :class:`FfConvFn`'s backward is the plain version's VJP.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from m2trans_tpu_torch.ops.kernels import build


def ff_weight_hwio_view(w_oihw: torch.Tensor) -> torch.Tensor:
    """The module's (C_out, C_in, 3, 3) conv weight as a (3, 3, C_in,
    C_out) view."""
    return w_oihw.permute(2, 3, 1, 0)


def ff_weight_hwio(w_oihw: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The module's (C_out, C_in, 3, 3) conv weight as K3's contiguous
    (3, 3, C_in, C_out)."""
    return ff_weight_hwio_view(w_oihw).to(dtype).contiguous()


def ff_conv_plain(oc: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: the conv in the operands' dtype (f32
    accumulation, rounded once), then the bias add and the residual add,
    each rounding in that dtype."""
    y = F.conv2d(oc.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = y + b[None, :, None, None]
    return y.permute(0, 2, 3, 1).contiguous() + x


def _check(oc, x, w, b):
    """Raise unless the operands are what K3 takes."""

    def need(cond, msg):
        if not cond:
            raise ValueError(f"ff_conv kernel: {msg}")

    need(oc.dim() == 4, f"oc must be (B, H, W, C), got {tuple(oc.shape)}")
    c = oc.shape[-1]
    need(c % 16 == 0, f"C must be a multiple of 16, got {c}")
    need(x.shape == oc.shape, f"x {tuple(x.shape)} != oc {tuple(oc.shape)}")
    need(w.shape == (3, 3, c, c), f"w must be (3, 3, {c}, {c}), got {tuple(w.shape)}")
    need(b.shape == (c,), f"b must be ({c},), got {tuple(b.shape)}")
    for name, v in (("oc", oc), ("x", x), ("w", w), ("b", b)):
        need(v.dtype == torch.bfloat16, f"{name} must be bf16, got {v.dtype}")
        need(v.is_contiguous(), f"{name} must be contiguous")
        need(v.device == oc.device, "all tensors on one device")
        need(v.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _launch(oc, x, w, b):
    _check(oc, x, w, b)
    bsz, h, wd, c = oc.shape
    lib = build.lib()
    if lib.m2t_ff_conv_smem(c) > build.MAX_SMEM:  # the 9*C*C weight: C <= 96
        raise ValueError(f"ff_conv kernel: C={c} needs more shared memory "
                         "than a block has")
    out = torch.empty_like(oc)
    if out.numel():
        code = lib.m2t_ff_conv(oc.data_ptr(), x.data_ptr(), w.data_ptr(),
                               b.data_ptr(), out.data_ptr(), bsz, h, wd, c,
                               build.stream_ptr(oc.device))
        build.check(code, "ff_conv")
        ff_conv.launches += 1
    return out


class FfConvFn(torch.autograd.Function):
    """K3 forward; the backward is the plain version's VJP, as the TPU
    kernel's custom_vjp differentiates its XLA composition."""

    @staticmethod
    def forward(ctx, oc, x, w, b):
        ctx.save_for_backward(oc, x, w, b)
        return _launch(oc, x, w, b)

    @staticmethod
    def backward(ctx, gout):
        ins = [v.detach().requires_grad_(True) for v in ctx.saved_tensors]
        with torch.enable_grad():
            out = ff_conv_plain(*ins)
        return torch.autograd.grad(out, ins, gout.to(out.dtype))


def ff_conv(oc: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """K3 (see module docstring), differentiable. CUDA tensors launch the
    kernel, which takes contiguous bf16 operands; CPU tensors run the plain
    version."""
    if oc.device.type == "cuda":
        return FfConvFn.apply(oc, x, w, b)
    if oc.device.type == "cpu":
        return ff_conv_plain(oc, x, w, b)
    raise ValueError(f"ff_conv: unsupported device {oc.device}")


ff_conv.launches = 0  # kernel launches, counted at each launch
