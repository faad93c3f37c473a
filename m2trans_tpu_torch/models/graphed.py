"""The serving forward as one CUDA graph per input shape; the port's
counterpart of ``jax.jit`` in m2trans_tpu/parallel/streaming.py.

The JAX package compiles the serving forward once per frame shape and then
dispatches one executable a frame. Run eagerly, the port's forward is about
250 launches from Python a frame, and on the card the host, not the device,
bounds it. :class:`GraphedForward` captures the served model's forward
(:func:`serving_forward`: M2Trans's
:func:`~m2trans_tpu_torch.models.m2trans.m2trans_apply_microbatched`, or
HAT's :func:`~m2trans_tpu_torch.models.hat.hat_apply`) and the output cast
(f32, or u8 as ``round(y * 255)`` in the forward's dtype) into
a ``torch.cuda.CUDAGraph`` the first time it sees an input shape, as
``jax.jit`` traces on a first call, and replays it after: one launch from
the host a frame.

Capture (:func:`capture`) runs the function once on a side stream first, so
that everything built at first use is built outside the capture: the
kernel library, the weight operands that ``models/m2trans.py::_prepared``
keeps on the modules, the constants of ``ops.on_device``, cuBLAS and cuDNN
state. The f32 policy's forward sets its TF32-off flags
(``m2trans.py::_no_tf32``) inside the captured function, so the captured
cuBLAS and cuDNN calls are the TF32-off ones.

A graph replays the pointers it was captured with, as a JAX executable
reads its arguments: the weights, and the operands ``_prepared`` laid out
from them (``models/m2trans.py``: the bf16 qkv weights, K3's weight and
bias). A graph outlives a write into the weights in place (an optimizer
step, ``load_state_dict`` into the same model): before a replay whose
:func:`weights_key` (pointer and version counter of every parameter) has
moved, the kept operands are rewritten in place, once, eagerly
(``refresh_operands``), and the graph reads the new weights. The graphs
are keyed by storage (:func:`storage_key`: the parameters' pointers and
those of the operands of the runner's dtype); when that moves (a
parameter replaced, the model moved) every graph is dropped and the next
call captures again, so a stale graph is never replayed. Each graph
holds the operands it reads, so none is freed under it. Parameters made
under ``torch.inference_mode`` have no version counter: a write into one
in place, which only inference mode allows, is not seen, by the graphs as
by ``_prepared``.

All graphs of one runner share one memory pool and are replayed on one
stream, so their intermediates share memory; the tensor a call returns is
the graph's static output and stays valid until the next call of the runner
(of any shape). With ``max_graphs`` a runner holds at most that many
shapes' graphs: a shape beyond them runs the eager forward on every call,
so no shape is captured twice while the storage stands (a runner kept for
a whole training run captures each validation shape once). A capture with
no graph left takes a new pool: the allocator refuses a capture into a pool
that no graph uses while a tensor of it is still alive (a returned output
the caller holds), and the old pool is freed with its last tensor. A CPU
model runs the same forward eagerly. There is no fallback: a capture or a
replay that fails raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.hat import HAT, hat_apply
from m2trans_tpu_torch.models.m2trans import (
    ComputePolicy,
    cached_operands,
    m2trans_apply_microbatched,
    param_key,
    refresh_operands,
)
from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv
from m2trans_tpu_torch.ops.kernels.halo_attn import cftm_branch
from m2trans_tpu_torch.ops.kernels.hat_attn import overlap_attention, window_attention_16
from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_fused

# the serving forward's kernel wrappers and their launch counters: M2Trans's,
# and HAT's (36 SW-MSA + 6 OCA launches a forward at HAT_SRx4's depth)
COUNTED = {"cftm_branch": cftm_branch, "ff_conv": ff_conv,
           "tail_band": tail_band_fused}
HAT_COUNTED = {"hat_wattn": window_attention_16, "hat_oca": overlap_attention}


def counted_kernels(model: torch.nn.Module) -> Dict[str, Callable]:
    """The kernel wrappers the model's serving forward launches."""
    return HAT_COUNTED if isinstance(model, HAT) else COUNTED


def served(y: torch.Tensor, output_u8: bool) -> torch.Tensor:
    """A forward's output as a server hands it out: f32, or u8
    ``round(y * 255)`` with ``output_u8``, the product and the rounding in
    the forward's own dtype (bf16 under the bf16 policy), as the JAX
    ``StreamingSR`` quantises (m2trans_tpu/parallel/streaming.py:72-74)."""
    if output_u8:
        return torch.round(y * 255.0).to(torch.uint8)
    return y.float()


def serving_forward(model: torch.nn.Module, x: torch.Tensor, cfg: Config,
                    policy: ComputePolicy, output_u8: bool) -> torch.Tensor:
    """The forward a server runs on one device: (B, H, W, colors) f32 in
    [0, 1] -> (B, H*s, W*s, 3), :func:`served`. M2Trans runs
    :func:`~m2trans_tpu_torch.models.m2trans.m2trans_apply_microbatched`
    (clamped to [0, 1]); HAT :func:`~m2trans_tpu_torch.models.hat.hat_apply`,
    clamped to [0, 1] only for u8 (its forward is not clamped)."""
    if isinstance(model, HAT):
        y = hat_apply(model, x, cfg, policy)
        return served(y.clamp(0.0, 1.0) if output_u8 else y, output_u8)
    return served(m2trans_apply_microbatched(model, x, cfg, policy), output_u8)


def weights_key(model: torch.nn.Module) -> Tuple[Tuple[int, int], ...]:
    """:func:`~m2trans_tpu_torch.models.m2trans.param_key` of every
    parameter of ``model``: it changes when a parameter is written in place
    or replaced."""
    return tuple(param_key(p) for p in model.parameters())


def storage_key(model: torch.nn.Module, dtype) -> Tuple[int, ...]:
    """The storage a graph of ``model``'s forward in ``dtype`` reads: every
    parameter's pointer and those of the kept operands of that dtype."""
    return (*(p.data_ptr() for p in model.parameters()),
            *(o.data_ptr() for op in cached_operands(model) if op.dtype == dtype
              for o in op.ops))


def capture(fn: Callable[[], torch.Tensor], pool):
    """``fn()`` run once on a side stream, then captured; returns the graph
    and the tensor ``fn`` returned during capture (its static output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return graph, out


class _Entry:
    """One captured shape: the static input, the graph, its static output,
    and the kept operands the graph reads."""

    def __init__(self, inp: torch.Tensor, graph, out: torch.Tensor, held=()):
        self.inp, self.graph, self.out, self.held = inp, graph, out, held


class GraphedForward:
    """:func:`serving_forward` replayed from a CUDA graph per input shape.

    Args:
      model: the port's M2Trans or HAT, on its device.
      cfg: model Config.
      policy: numerics policy.
      output_u8: quantise the output to u8 on the device.
      max_graphs: the most shapes whose graphs are kept (None: no bound);
        a shape beyond them runs eagerly.

    ``captures``, ``replays`` and ``eager_calls`` (shapes beyond
    ``max_graphs``) count what it did; ``refreshes`` the operand
    rewrites before a replay after a weight write; ``capture_launches``
    holds, for each captured shape, the launches of the model's kernel
    wrappers (:func:`counted_kernels`) during the capture itself (the
    side-stream run before it excluded): the kernels each replay runs.
    """

    def __init__(self, model: torch.nn.Module, cfg: Config, policy: ComputePolicy, *,
                 output_u8: bool = False, max_graphs: Optional[int] = None):
        self.model, self.cfg, self.policy = model, cfg, policy
        self.output_u8 = output_u8
        self.max_graphs = max_graphs
        self.device = next(model.parameters()).device
        self.graphs = self.device.type == "cuda"  # False: the eager forward
        self._pool = None  # the live graphs' memory pool
        self._graphs: Dict[Tuple[int, ...], _Entry] = {}
        self._weights = self._storage = None  # the keys the graphs stand on
        self.captures = self.replays = self.eager_calls = self.refreshes = 0
        self.capture_launches: Dict[Tuple[int, ...], Dict[str, int]] = {}
        self.counted = counted_kernels(model)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return serving_forward(self.model, x, self.cfg, self.policy,
                               self.output_u8)

    def _ready(self) -> None:
        """Refresh the kept operands after a weight write in place; drop
        every graph when the storage they read has moved."""
        weights = weights_key(self.model)
        if weights != self._weights:
            refresh_operands(self.model)
            self._weights = weights
            self.refreshes += bool(self._graphs)
        storage = storage_key(self.model, self.policy.dtype)
        if storage != self._storage:
            self._graphs.clear()
            self._storage = storage

    def _entry(self, shape: Tuple[int, ...]) -> Optional[_Entry]:
        """The graph for ``shape``, captured now if it has none; None for a
        shape beyond ``max_graphs``."""
        self._ready()
        if shape in self._graphs:
            return self._graphs[shape]
        if self.max_graphs is not None and len(self._graphs) >= self.max_graphs:
            return None
        if not self._graphs:
            self._pool = torch.cuda.graph_pool_handle()
        inp = torch.zeros(shape, dtype=torch.float32, device=self.device)
        counts = []  # the wrappers' launches in each call of fn

        def fn():
            before = {k: f.launches for k, f in self.counted.items()}
            out = self._forward(inp)
            counts.append({k: f.launches - before[k] for k, f in self.counted.items()})
            return out

        graph, out = capture(fn, self._pool)
        self.capture_launches[shape] = counts[-1]  # the captured call's
        held = [op for op in cached_operands(self.model) if op.dtype == self.policy.dtype]
        self._graphs[shape] = _Entry(inp, graph, out, held)
        self.captures += 1
        # the capture's first use built the operands: the keys now include them
        self._weights = weights_key(self.model)
        self._storage = storage_key(self.model, self.policy.dtype)
        return self._graphs[shape]

    @torch.inference_mode()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The forward of ``x`` (B, H, W, colors) f32. On a CUDA model ``x``
        may lie on the card or on the host (a pinned host tensor is copied
        in without a wait); the result is the graph's static output, valid
        until the next call (an eager result for a shape beyond
        ``max_graphs``). On a CPU model: the eager forward."""
        if not self.graphs:
            return self._forward(x)
        entry = self._entry(tuple(x.shape))
        if entry is None:
            self.eager_calls += 1
            return self._forward(x.to(self.device, non_blocking=True))
        entry.inp.copy_(x, non_blocking=True)
        entry.graph.replay()
        self.replays += 1
        return entry.out
