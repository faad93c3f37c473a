"""The numerics the port's models, its loss, its sharded forward and its
graphs share: the policy, f32 parity (TF32 off), and the kernel operands
laid out from a module's parameters and kept on it between calls, which
the serving graphs (``models/graphed.py``) refresh in place after a weight
write."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from m2trans_tpu_torch.config import Config


@dataclasses.dataclass(frozen=True)
class ComputePolicy:
    """Numerics policy threaded through the forward pass. ``use_kernels``
    is the config's ``use_pallas``: in bf16 it routes the models' hot
    paths through their kernel wrappers."""

    dtype: torch.dtype = torch.float32
    use_kernels: bool = False

    @property
    def kernels(self) -> bool:
        """Whether the kernel wrappers run: bf16 with ``use_kernels``."""
        return self.use_kernels and self.dtype == torch.bfloat16


def policy_from_config(cfg: Config) -> ComputePolicy:
    """Numerics policy for ``cfg``, for serving and training alike. The JAX
    package's ``for_training`` flag turns off a forward-only packed flow
    that the port does not have; the port's bf16 kernels carry their
    backward."""
    if cfg.dtype == "bfloat16":
        return ComputePolicy(dtype=torch.bfloat16, use_kernels=cfg.use_pallas)
    return ComputePolicy()


@contextlib.contextmanager
def no_tf32():
    """Full-f32 matmuls and convolutions for f32 parity mode."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def f32_parity(policy: ComputePolicy):
    """:func:`no_tf32` under the f32 policy, else a context that does
    nothing."""
    return no_tf32() if policy.dtype == torch.float32 else contextlib.nullcontext()


def param_key(p: torch.Tensor) -> Tuple[int, int]:
    """``(data_ptr, version)`` of a parameter: what is kept across calls
    from its values is stale when either differs. An inference tensor has no
    version counter and keys by 0, so an in-place write into one (possible
    only under ``torch.inference_mode``) is not seen."""
    return p.data_ptr(), 0 if p.is_inference() else p._version


class Operands:
    """Kernel operands laid out from a module's parameters: ``layout``
    gives views of the parameters (differentiable), each operand is one of
    them in ``dtype``, contiguous, in storage of its own."""

    def __init__(self, dtype, params, layout):
        self.dtype, self.params, self.layout = dtype, params, layout
        self.key = self._key()
        with torch.no_grad(), torch.inference_mode(False):
            self.ops = tuple(torch.empty(v.shape, dtype=dtype, device=v.device).copy_(v)
                             for v in self._views())

    def _key(self):
        return (self.dtype, *(param_key(p) for p in self.params))

    def _views(self):
        return self.layout(*(p.detach() for p in self.params))

    def of(self, dtype, params) -> bool:
        """Whether these are the operands of ``params`` in ``dtype``, in the
        storage they were laid out from (perhaps written in place since)."""
        return (dtype == self.dtype and all(a is b for a, b in zip(params, self.params))
                and all(p.data_ptr() == k[0] for p, k in zip(params, self.key[1:])))

    def refresh(self) -> None:
        """Rewrite the operands in place from the parameters as they stand
        (same storage, no new allocation; a graph that reads them sees the
        new values). Never under inference mode: the operands are plain
        tensors, whatever mode first built them."""
        key = self._key()
        if key != self.key:
            with torch.no_grad(), torch.inference_mode(False):
                for o, v in zip(self.ops, self._views()):
                    o.copy_(v)
            self.key = key


def prepared(mod: nn.Module, slot: str, dtype, params, layout):
    """The kernel operands ``layout(*params)`` (a tuple of views) in
    ``dtype``, contiguous. Where a gradient is wanted they are built
    through autograd; otherwise they are kept on the module between calls
    (not in its state_dict, :class:`Operands`): rewritten in place when a
    parameter's :func:`param_key` moves and its storage does not (an
    optimizer step, an in-place ``load_state_dict``), built anew when a
    parameter is replaced or the dtype differs."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return tuple(v.to(dtype).contiguous() for v in layout(*params))
    cache = mod.__dict__.setdefault("_operands", {})
    hit = cache.get(slot)
    if hit is not None and hit.of(dtype, params):
        hit.refresh()
    else:
        hit = cache[slot] = Operands(dtype, tuple(params), layout)
    return hit.ops


def cached_operands(model: nn.Module):
    """Every operand set :func:`prepared` keeps on ``model``'s modules."""
    return [op for mod in model.modules()
            for op in mod.__dict__.get("_operands", {}).values()]


def refresh_operands(model: nn.Module) -> None:
    """Rewrite every kept operand whose parameters were written in place
    (:meth:`Operands.refresh`), before a graph that reads them replays."""
    for op in cached_operands(model):
        op.refresh()
