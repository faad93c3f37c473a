"""K4, the lane relayouts: wrappers, launch count and plain versions.

Replaces the TPU kernels of m2trans_tpu/ops/pallas/halo_attn_packed.py:
``pack_batch_dma`` (``_pack_kernel``), ``pack_body_dma``
(``_pack_body_kernel``), ``unpack_body_dma`` (``_unpack_body_kernel``) and
``unpack_batch_dma`` (``_unpack_kernel``). They lay ``g`` images side by
side on the channel axis,

    packed[bp, h, w, k*g*cb + s*cb + c] = image[bp*g + s, h, w, k*cb + c]

for branch k of nb, slot s of g, channel c of cb = C / nb: ``pack_batch`` is
nb = 1 (lane ``s*cb + c``), ``pack_body`` nb = 4 (branch-major). On the card
they are one copy kernel, ``csrc/relayout.cu``. Nothing on the model's path
calls them (the port's kernels do not pack lanes); they are standalone ops,
as they are in the JAX package.

Each wrapper launches the kernel for a CUDA tensor (contiguous bf16, cb a
multiple of 8) and runs its plain version, a reshape / permute composition,
for a CPU tensor only; anything else raises.
"""

from __future__ import annotations

import torch

from m2trans_tpu_torch.ops.kernels import build


def pack_body_plain(x: torch.Tensor, g: int, nb: int = 4) -> torch.Tensor:
    """(B, H, W, C) -> (B/g, H, W, g*C), lane ``k*g*cb + s*cb + c``."""
    b, h, w, c = x.shape
    cb = c // nb
    y = x.reshape(b // g, g, h, w, nb, cb).permute(0, 2, 3, 4, 1, 5)
    return y.reshape(b // g, h, w, g * c)


def unpack_body_plain(x: torch.Tensor, g: int, nb: int = 4) -> torch.Tensor:
    """Inverse of :func:`pack_body_plain`."""
    bp, h, w, gc = x.shape
    cb = gc // (g * nb)
    y = x.reshape(bp, h, w, nb, g, cb).permute(0, 4, 1, 2, 3, 5)
    return y.reshape(bp * g, h, w, nb * cb)


def pack_batch_plain(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, H, W, cb) -> (B/g, H, W, g*cb), lane ``s*cb + c``."""
    return pack_body_plain(x, g, nb=1)


def unpack_batch_plain(x: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse of :func:`pack_batch_plain`."""
    return unpack_body_plain(x, g, nb=1)


def _check(x, g, nb, pack):
    """Raise unless K4 takes ``x``; returns the image-major (B, C)."""

    def need(cond, msg):
        if not cond:
            raise ValueError(f"relayout kernel: {msg}")

    need(x.dim() == 4, f"x must be (B, H, W, C), got {tuple(x.shape)}")
    need(g >= 1 and nb >= 1, f"g and nb must be positive, got {g}, {nb}")
    need(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    need(x.is_contiguous() and x.data_ptr() % 16 == 0,
         "x must be contiguous and 16-byte aligned")
    if pack:
        b, c = x.shape[0], x.shape[3]
        need(b % g == 0, f"batch {b} is not a multiple of g={g}")
    else:
        need(x.shape[3] % g == 0, f"{x.shape[3]} lanes do not hold g={g} images")
        b, c = x.shape[0] * g, x.shape[3] // g
    need(c % nb == 0 and (c // nb) % 8 == 0,
         f"cb = C/nb must be a multiple of 8, got C={c}, nb={nb}")
    return b, c


def _launch(x, g, nb, pack):
    b, c = _check(x, g, nb, pack)
    _, h, w, _ = x.shape
    out = torch.empty((b // g, h, w, g * c) if pack else (b, h, w, c),
                      dtype=x.dtype, device=x.device)
    if out.numel():
        code = build.lib().m2t_relayout(x.data_ptr(), out.data_ptr(), b, h, w,
                                        g, nb, c // nb, int(pack),
                                        build.stream_ptr(x.device))
        build.check(code, "relayout")
        relayout.launches += 1
    return out


def relayout(x: torch.Tensor, g: int, nb: int, pack: bool) -> torch.Tensor:
    """The pack (or, with ``pack`` false, unpack) of ``g`` images with
    ``nb`` branches: K4 for a CUDA tensor, the plain version for a CPU
    tensor."""
    if x.device.type == "cuda":
        return _launch(x, g, nb, pack)
    if x.device.type == "cpu":
        return (pack_body_plain if pack else unpack_body_plain)(x, g, nb)
    raise ValueError(f"relayout: unsupported device {x.device}")


relayout.launches = 0  # kernel launches, counted at each launch


def pack_body(x: torch.Tensor, g: int, nb: int = 4) -> torch.Tensor:
    """(B, H, W, C) -> (B/g, H, W, g*C), branch-major lanes."""
    return relayout(x, g, nb, True)


def unpack_body(x: torch.Tensor, g: int, nb: int = 4) -> torch.Tensor:
    """Inverse of :func:`pack_body`."""
    return relayout(x, g, nb, False)


def pack_batch(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, H, W, cb) -> (B/g, H, W, g*cb), slot-major lanes; ``g == 1``
    returns ``x``."""
    return x if g == 1 else relayout(x, g, 1, True)


def unpack_batch(x: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse of :func:`pack_batch`; ``g == 1`` returns ``x``."""
    return x if g == 1 else relayout(x, g, 1, False)
