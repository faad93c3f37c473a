"""K1, the fused CFTM wavelet branch: wrapper, launch count and plain
version.

Replaces the TPU kernels behind ``cftm_branch_fused``
(m2trans_tpu/ops/pallas/halo_attn.py: ``_cascade_kernel`` via
``_cascade_banded_impl``, ``_cascade_tile_kernel`` via
``_cascade_tiled_impl``; m2trans_tpu/ops/pallas/halo_attn_packed.py:
``_packed_cascade_kernel`` via ``packed_cascade_core``,
``_packed_front_kernel`` via ``packed_front_core``). Row bands, column
slabs and lane packing were TPU choices; on the card they are one kernel,
``csrc/cftm_branch.cu``, whose header says what bounds it and how its
design answers that.

K1b, its VJP (``csrc/cftm_branch_bwd.cu``), replaces the TPU backward
kernels of ``cftm_branch_fused``'s custom_vjp (halo_attn.py
``_cascade_bwd_kernel``, ``_cascade_bwd_tile_kernel``; halo_attn_packed.py
``_packed_bwd_kernel``, ``_packed_bwd_tile_kernel``,
``_packed_front_bwd_kernel``). :class:`CftmBranchFn` ties the two together
for autograd: its forward launches K1 and saves only the inputs, its
backward launches K1b (:func:`cftm_branch_bwd`).

    out = B(z) + z,   z = (x*s + t) [+ r*x_add]   (zero outside the frame)
    B   = DWT^L -> qkv -> 8x8-block / 10x10-window halo attention -> IWT^L

K1n, the bare wavelet branch (``halo_attention_qkv_fused`` of halo_attn.py:
``_kernel`` via ``_halo_attention_banded_impl``, ``_tile_kernel`` via
``_halo_attention_tiled_impl``, ``_multiband_kernel`` via
``_halo_attention_whole_impl``), is B alone, no affine and no residual: a
second entry of ``csrc/cftm_branch.cu`` (:func:`halo_attention_qkv`). Its
TPU custom_vjp differentiates the XLA composition, so
:class:`HaloAttnQkvFn`'s backward is the plain version's VJP.

:func:`cftm_branch` launches the kernels for CUDA tensors and runs
:func:`cftm_branch_plain` (differentiated by autograd) for CPU tensors
only; anything else raises. :func:`cftm_branch_plain_vjp` is K1b's plain
version.
"""

from __future__ import annotations

from typing import Optional

import torch

from m2trans_tpu_torch.ops.halo_attention import (
    add_rel_pos_to_k,
    blockify,
    extract_halo_windows,
    unblockify,
)
from m2trans_tpu_torch.ops.kernels import build
from m2trans_tpu_torch.ops.wavelet import haar_dwt, haar_iwt


def _branch_plain_f32(z: torch.Tensor, w_qkv, rel_h, rel_w, levels: int,
                      block: int, halo: int) -> torch.Tensor:
    """``IWT^L(attn(qkv(DWT^L(z))))`` in f32, rounding to ``z``'s dtype
    where K1 rounds: the DWT output, q/k(+rel)/v after f32 products, the
    probabilities after an f32 softmax; P v and the IWT stay f32."""
    dt = z.dtype
    zc = z.float()
    for _ in range(levels):
        zc = haar_dwt(zc)
    qkv = zc.to(dt).float() @ w_qkv.float()
    c = qkv.shape[-1] // 3
    bsz, hc, wc, _ = qkv.shape
    win = block + 2 * halo
    q = blockify((qkv[..., :c] * c ** -0.5).to(dt), block).float()
    k = add_rel_pos_to_k(extract_halo_windows(qkv[..., c:2 * c], block, halo),
                         rel_h.float(), rel_w.float(), win).to(dt).float()
    v = extract_halo_windows(qkv[..., 2 * c:].to(dt), block, halo).float()
    attn = torch.softmax(torch.einsum("bnmqc,bnmkc->bnmqk", q, k), dim=-1)
    o = torch.einsum("bnmqk,bnmkc->bnmqc", attn.to(dt).float(), v)
    o = unblockify(o, hc, wc)
    for _ in range(levels):
        o = haar_iwt(o)
    return o


def cftm_branch_plain(x: torch.Tensor, w_qkv: torch.Tensor,
                      rel_h: torch.Tensor, rel_w: torch.Tensor,
                      s: torch.Tensor, t: torch.Tensor, *,
                      x_add: Optional[torch.Tensor] = None, r: float = 0.5,
                      levels: int = 0, block: int = 8, halo: int = 1
                      ) -> torch.Tensor:
    """Plain PyTorch version of K1, rounding where the kernel rounds: z and
    the DWT output to the input dtype, q/k(+rel)/v to it after f32
    products, softmax in f32, the probabilities to it, then f32 P v, IWT
    and residual, one final rounding. In f32 every rounding is a no-op and
    this is the XLA composition ``_cascade_xla`` of the JAX package.

    x, x_add: (B, H, W, Cb); s, t: (B, Cb) f32; w_qkv: (C, 3C) with
    C = Cb * 4**levels; rel_h, rel_w: (block + 2*halo, C/2)."""
    dt = x.dtype
    z = x.float() * s.float()[:, None, None, :] + t.float()[:, None, None, :]
    if x_add is not None:
        z = z + r * x_add.float()
    z = z.to(dt)
    o = _branch_plain_f32(z, w_qkv, rel_h, rel_w, levels, block, halo)
    return (o + z.float()).to(dt)


def halo_attention_qkv_plain(x: torch.Tensor, w_qkv: torch.Tensor,
                             rel_h: torch.Tensor, rel_w: torch.Tensor, *,
                             levels: int = 0, block: int = 8, halo: int = 1
                             ) -> torch.Tensor:
    """Plain PyTorch version of K1n, the bare wavelet branch
    ``IWT^L(attn(qkv(DWT^L(x))))``: no affine, no residual, rounded once
    from the f32 IWT result. In f32 it is ``_xla_reference`` of the JAX
    package."""
    return _branch_plain_f32(x, w_qkv, rel_h, rel_w, levels, block,
                             halo).to(x.dtype)


def _check(x, w_qkv, rel_h, rel_w, s, t, x_add, levels, block, halo):
    """Raise unless the operands are what K1, K1b and K1n (``s`` and ``t``
    None) take."""
    bsz, h, w, cb = x.shape
    c = cb * 4 ** levels
    sfull = 2 ** levels
    dev = x.device

    def need(cond, msg):
        if not cond:
            raise ValueError(f"cftm_branch kernel: {msg}")

    need(block == 8 and halo == 1, "only block=8, halo=1")
    need(levels in (0, 1, 2), f"levels must be 0, 1 or 2, got {levels}")
    need(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    need(h % (block * sfull) == 0 and w % (block * sfull) == 0,
         f"H, W must be multiples of {block * sfull}, got {h}x{w}")
    need(c % 16 == 0, f"C = Cb*4^L must be a multiple of 16, got {c}")
    need(x.stride(3) == 1 and x.stride(1) == w * x.stride(2)
         and x.stride(0) == h * x.stride(1),
         "x must be a channel slice of a contiguous NHWC tensor")
    need(w_qkv.shape == (c, 3 * c) and w_qkv.dtype == torch.bfloat16
         and w_qkv.is_contiguous(), f"w_qkv must be contiguous bf16 ({c}, {3 * c})")
    for name, rel in (("rel_h", rel_h), ("rel_w", rel_w)):
        need(rel.shape == (block + 2 * halo, c // 2) and rel.dtype == torch.float32
             and rel.is_contiguous(), f"{name} must be contiguous f32 (10, {c // 2})")
    tensors = [x, w_qkv, rel_h, rel_w]
    if s is not None:  # K1n has no affine
        for name, v in (("s", s), ("t", t)):
            need(v.shape == (bsz, cb) and v.dtype == torch.float32
                 and v.is_contiguous(), f"{name} must be contiguous f32 ({bsz}, {cb})")
        tensors += [s, t]
    if x_add is not None:
        need(x_add.shape == x.shape and x_add.dtype == torch.bfloat16
             and x_add.stride(3) == 1 and x_add.stride(1) == w * x_add.stride(2)
             and x_add.stride(0) == h * x_add.stride(1),
             "x_add must be a bf16 channel slice like x")
        tensors.append(x_add)
    need(all(v.device == dev for v in tensors), "all tensors on one device")


def _launch(x, w_qkv, rel_h, rel_w, s, t, x_add, r, levels, block, halo):
    _check(x, w_qkv, rel_h, rel_w, s, t, x_add, levels, block, halo)
    bsz, h, w, cb = x.shape
    c = cb * 4 ** levels
    lib = build.lib()
    if lib.m2t_cftm_branch_smem(c) > build.MAX_SMEM:
        raise ValueError(f"cftm_branch kernel: C={c} needs more shared memory "
                         "than a block has")
    dev = x.device
    out = torch.empty((bsz, h, w, cb), dtype=x.dtype, device=dev)
    a = x_add if x_add is not None else x
    code = lib.m2t_cftm_branch(
        x.data_ptr(), x_add.data_ptr() if x_add is not None else None,
        s.data_ptr(), t.data_ptr(), w_qkv.data_ptr(), rel_h.data_ptr(),
        rel_w.data_ptr(), out.data_ptr(), bsz, h, w, cb, levels,
        x.stride(0), x.stride(1), x.stride(2),
        a.stride(0), a.stride(1), a.stride(2), float(r),
        build.stream_ptr(dev))
    build.check(code, "cftm_branch")
    cftm_branch.launches += 1
    return out


def cftm_branch_plain_vjp(x, w_qkv, rel_h, rel_w, s, t, gout, *,
                          x_add=None, r: float = 0.5, levels: int = 0,
                          block: int = 8, halo: int = 1):
    """Plain version of K1b: the gradients of :func:`cftm_branch_plain` by
    autograd, ``(dx, dx_add, ds, dt, dw_qkv, drel_h, drel_w)`` (dx_add None
    without x_add), each in its input's dtype."""
    ins = [v.detach().requires_grad_(True)
           for v in (x, w_qkv, rel_h, rel_w, s, t)]
    add = None if x_add is None else x_add.detach().requires_grad_(True)
    with torch.enable_grad():
        out = cftm_branch_plain(*ins, x_add=add, r=r, levels=levels,
                                block=block, halo=halo)
        grads = torch.autograd.grad(out, ins + ([add] if add is not None else []),
                                    gout)
    dx, dw, drh, drw, ds, dt = grads[:6]
    return dx, (grads[6] if add is not None else None), ds, dt, dw, drh, drw


def cftm_branch_bwd(x, w_qkv, rel_h, rel_w, s, t, gout, *, x_add=None,
                    r: float = 0.5, levels: int = 0):
    """Launch K1b on CUDA tensors (the operands :func:`_launch` takes, plus
    the output's cotangent ``gout``); returns ``(dx, dx_add, ds, dt, dw_qkv,
    drel_h, drel_w)`` in the inputs' dtypes. The kernels give dz and the
    weight gradients; dx, dx_add, ds, dt are the elementwise and reduction
    glue that stayed XLA around the TPU kernel."""
    _check(x, w_qkv, rel_h, rel_w, s, t, x_add, levels, 8, 1)
    if gout.shape != x.shape or gout.device != x.device:
        raise ValueError(f"cftm_branch_bwd: gout {tuple(gout.shape)} on "
                         f"{gout.device} != x {tuple(x.shape)} on {x.device}")
    bsz, h, w, cb = x.shape
    c = cb * 4 ** levels
    sfull = 2 ** levels
    lib = build.lib()
    for which in (0, 1):
        if lib.m2t_cftm_branch_bwd_smem(c, which) > build.MAX_SMEM:
            raise ValueError(f"cftm_branch_bwd kernel: C={c} needs more shared "
                             "memory than a block has")
    gout = gout.to(torch.bfloat16).contiguous()
    nwin = bsz * (h // (8 * sfull)) * (w // (8 * sfull))
    dev = x.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    d_o = torch.empty((nwin, 64, c), dtype=torch.bfloat16, device=dev)
    dp, dq = f32(nwin, 64, 112), f32(nwin, 64, c)
    dk, dv = f32(nwin, 112, c), f32(nwin, 112, c)
    drel_part, dw_part = f32(nwin, 10, c), f32(nwin, c, 3 * c)
    dz, dw, drel = f32(bsz, h, w, cb), f32(c, 3 * c), f32(10, c)
    a = x_add if x_add is not None else x
    code = lib.m2t_cftm_branch_bwd(
        x.data_ptr(), x_add.data_ptr() if x_add is not None else None,
        s.data_ptr(), t.data_ptr(), w_qkv.data_ptr(), rel_h.data_ptr(),
        rel_w.data_ptr(), gout.data_ptr(), d_o.data_ptr(), dp.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), drel_part.data_ptr(),
        dw_part.data_ptr(), dz.data_ptr(), dw.data_ptr(), drel.data_ptr(),
        bsz, h, w, cb, levels, x.stride(0), x.stride(1), x.stride(2),
        a.stride(0), a.stride(1), a.stride(2), float(r), build.stream_ptr(dev))
    build.check(code, "cftm_branch_bwd")
    cftm_branch_bwd.launches += 1
    dx = (dz * s[:, None, None, :]).to(x.dtype)
    dx_add = None if x_add is None else (r * dz).to(x_add.dtype)
    ds = (dz * x.float()).sum(dim=(1, 2))
    dt = dz.sum(dim=(1, 2))
    return (dx, dx_add, ds, dt, dw.to(w_qkv.dtype), drel[:, :c // 2].contiguous(),
            drel[:, c // 2:].contiguous())


cftm_branch_bwd.launches = 0  # K1b launch groups (2 kernels + 2 reductions)


class CftmBranchFn(torch.autograd.Function):
    """K1 forward, K1b backward. Saves only the inputs, as the JAX
    custom_vjp's fwd rule does; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, x_add, s, t, w_qkv, rel_h, rel_w, r, levels, block,
                halo):
        ctx.save_for_backward(x, x_add, s, t, w_qkv, rel_h, rel_w)
        ctx.r, ctx.levels = r, levels
        return _launch(x, w_qkv, rel_h, rel_w, s, t, x_add, r, levels, block,
                       halo)

    @staticmethod
    def backward(ctx, gout):
        x, x_add, s, t, w_qkv, rel_h, rel_w = ctx.saved_tensors
        dx, dx_add, ds, dt, dw, drh, drw = cftm_branch_bwd(
            x, w_qkv, rel_h, rel_w, s, t, gout, x_add=x_add, r=ctx.r,
            levels=ctx.levels)
        return dx, dx_add, ds, dt, dw, drh, drw, None, None, None, None


def cftm_branch(x: torch.Tensor, w_qkv: torch.Tensor, rel_h: torch.Tensor,
                rel_w: torch.Tensor, s: torch.Tensor, t: torch.Tensor, *,
                x_add: Optional[torch.Tensor] = None, r: float = 0.5,
                levels: int = 0, block: int = 8, halo: int = 1
                ) -> torch.Tensor:
    """K1 (see module docstring), differentiable. CUDA tensors launch the
    kernel (K1b in the backward), which takes bf16 x / x_add (channel
    slices of a contiguous NHWC tensor), bf16 w_qkv and f32 s, t, rel; CPU
    tensors run the plain version."""
    if x.device.type == "cuda":
        return CftmBranchFn.apply(x, x_add, s, t, w_qkv, rel_h, rel_w, r,
                                  levels, block, halo)
    if x.device.type == "cpu":
        return cftm_branch_plain(x, w_qkv, rel_h, rel_w, s, t, x_add=x_add,
                                 r=r, levels=levels, block=block, halo=halo)
    raise ValueError(f"cftm_branch: unsupported device {x.device}")


cftm_branch.launches = 0  # kernel launches, counted at each launch


def _launch_qkv(x, w_qkv, rel_h, rel_w, levels, block, halo):
    _check(x, w_qkv, rel_h, rel_w, None, None, None, levels, block, halo)
    bsz, h, w, cb = x.shape
    c = cb * 4 ** levels
    lib = build.lib()
    if lib.m2t_cftm_branch_smem(c) > build.MAX_SMEM:
        raise ValueError(f"halo_attention_qkv kernel: C={c} needs more shared "
                         "memory than a block has")
    out = torch.empty((bsz, h, w, cb), dtype=x.dtype, device=x.device)
    code = lib.m2t_halo_attn_qkv(
        x.data_ptr(), w_qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
        out.data_ptr(), bsz, h, w, cb, levels, x.stride(0), x.stride(1),
        x.stride(2), build.stream_ptr(x.device))
    build.check(code, "halo_attention_qkv")
    halo_attention_qkv.launches += 1
    return out


class HaloAttnQkvFn(torch.autograd.Function):
    """K1n forward; the backward is the plain version's VJP, as the TPU
    kernel's custom_vjp differentiates its XLA composition."""

    @staticmethod
    def forward(ctx, x, w_qkv, rel_h, rel_w, levels, block, halo):
        ctx.save_for_backward(x, w_qkv, rel_h, rel_w)
        ctx.cfg = (levels, block, halo)
        return _launch_qkv(x, w_qkv, rel_h, rel_w, levels, block, halo)

    @staticmethod
    def backward(ctx, gout):
        ins = [v.detach().requires_grad_(True) for v in ctx.saved_tensors]
        levels, block, halo = ctx.cfg
        with torch.enable_grad():
            out = halo_attention_qkv_plain(*ins, levels=levels, block=block,
                                           halo=halo)
        return (*torch.autograd.grad(out, ins, gout.to(out.dtype)),
                None, None, None)


def halo_attention_qkv(x: torch.Tensor, w_qkv: torch.Tensor,
                       rel_h: torch.Tensor, rel_w: torch.Tensor, *,
                       levels: int = 0, block: int = 8, halo: int = 1
                       ) -> torch.Tensor:
    """K1n, the bare wavelet branch ``IWT^L(attn(qkv(DWT^L(x))))``,
    differentiable. CUDA tensors launch the kernel (bf16 x, a channel slice
    of a contiguous NHWC tensor, bf16 w_qkv, f32 rel); CPU tensors run the
    plain version."""
    if x.device.type == "cuda":
        return HaloAttnQkvFn.apply(x, w_qkv, rel_h, rel_w, levels, block, halo)
    if x.device.type == "cpu":
        return halo_attention_qkv_plain(x, w_qkv, rel_h, rel_w, levels=levels,
                                        block=block, halo=halo)
    raise ValueError(f"halo_attention_qkv: unsupported device {x.device}")


halo_attention_qkv.launches = 0  # kernel launches, counted at each launch
