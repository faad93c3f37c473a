"""The CFTM's instance-norm statistics as K1's per-branch affine: wrapper,
launch count and plain version.

Replaces no TPU kernel: the JAX package takes the statistics in plain XLA
(m2trans_tpu/models/m2trans.py ``_cftm_apply_fused``), and the port took
them in plain torch (``ops/norm.py::in_stats``, then a slice, a copy and a
halving a branch): about 24 small launches a CFTM. On the card they are one
pass over the bf16 map, ``csrc/in_stats.cu``: its header has the design.

    st = in_stats_affine(x)       # x: (B, H, W, C) NHWC bf16, C = 4 * cb
    st[0, k], st[1, k]            # branch k's s and t, each (B, cb) f32

with s = rsqrt(var + 1e-5), t = -mean * s over H, W (biased variance, f32
statistics, as ``in_stats``), both halved for branches 1-3: the cascade's
r = 0.5 (``models/m2trans.py``'s docstring).

:func:`in_stats_affine` launches the kernel for CUDA tensors and runs
:func:`in_stats_affine_plain` for CPU tensors only; anything else raises.
The kernel has no backward: the fused CFTM calls it only where no gradient
flows to its input, and runs the plain version under autograd.
"""

from __future__ import annotations

import torch

from m2trans_tpu_torch.ops.kernels import build
from m2trans_tpu_torch.ops.norm import in_stats

EPS = 1e-5
BRANCHES = 4


def in_stats_affine_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``in_stats`` laid out as (2, 4, B, cb), branches
    1-3 halved."""
    inv, t = in_stats(x, EPS)
    bsz, c = inv.shape
    st = torch.stack((inv, t)).view(2, bsz, BRANCHES, c // BRANCHES).transpose(1, 2)
    st = st.contiguous()
    st[:, 1:] *= 0.5
    return st


def _check(x):
    """Raise unless ``x`` is what the kernel takes."""

    def need(cond, msg):
        if not cond:
            raise ValueError(f"in_stats kernel: {msg}")

    need(x.dim() == 4, f"x must be (B, H, W, C), got {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    need(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    need(x.is_contiguous(), "x must be contiguous")
    need(c % 32 == 0 and 0 < c <= 2048,
         f"C must be a multiple of 32 up to 2048, got {c}")
    need(bsz * h * w > 0, f"x must not be empty, got {tuple(x.shape)}")
    need(bsz <= 65535, f"at most 65535 images, got {bsz}")
    need(x.numel() <= 2 ** 31, f"at most 2^31 elements, got {x.numel()}")
    need(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")


def _launch(x):
    _check(x)
    bsz, h, w, c = x.shape
    lib = build.lib()
    part = torch.empty(lib.m2t_in_stats_part_floats(bsz, h * w, c),
                       dtype=torch.float32, device=x.device)
    st = torch.empty((2, BRANCHES, bsz, c // BRANCHES), dtype=torch.float32,
                     device=x.device)
    code = lib.m2t_in_stats(x.data_ptr(), part.data_ptr(), st.data_ptr(), bsz,
                            h * w, c, EPS, build.stream_ptr(x.device))
    build.check(code, "in_stats")
    in_stats_affine.launches += 2  # the chunks' sums, then s and t
    return st


def in_stats_affine(x: torch.Tensor) -> torch.Tensor:
    """The (2, 4, B, cb) f32 affine of K1's four branches (module docstring).
    CUDA tensors launch the kernel, which takes contiguous bf16; CPU tensors
    run the plain version."""
    if x.device.type == "cuda":
        return _launch(x)
    if x.device.type == "cpu":
        return in_stats_affine_plain(x)
    raise ValueError(f"in_stats_affine: unsupported device {x.device}")


in_stats_affine.launches = 0  # kernel launches, counted at each launch
