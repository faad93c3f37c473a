"""The serving forward as one CUDA graph per input shape; the port's
counterpart of ``jax.jit`` in m2trans_tpu/parallel/streaming.py.

The JAX package compiles the serving forward once per frame shape and then
dispatches one executable a frame. Run eagerly, the port's forward is about
250 launches from Python a frame, and on the card the host, not the device,
bounds it. :class:`GraphedForward` captures
:func:`~m2trans_tpu_torch.models.m2trans.m2trans_apply_microbatched` and the
output cast (f32, or u8 as ``round(y * 255)`` in the forward's dtype) into
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

A graph replays the pointers it was captured with: the weights, and the
operands ``_prepared`` laid out from them. Every graph is therefore keyed
by :func:`weights_key`, the storage pointer and version counter of every
parameter (``models/m2trans.py::param_key``, the key ``_prepared`` keeps its
operands by); when any differs from the key at capture (an in-place
``load_state_dict``, an optimizer step, a move), all graphs are dropped and
the next call captures again. A stale graph is never replayed. Parameters
made under ``torch.inference_mode`` have no version counter: a write into
one in place, which only inference mode allows, is not seen, by the graphs
as by ``_prepared``.

All graphs of one runner share one memory pool and are replayed on one
stream, so their intermediates share memory; the tensor a call returns is
the graph's static output and stays valid until the next call of the runner
(of any shape). With ``max_graphs`` a runner holds at most that many
shapes' graphs: capturing one more drops the least recently replayed, whose
static tensors the pool then reuses. A capture with no graph left takes a
new pool: the allocator refuses a capture into a pool that no graph uses
while a tensor of it is still alive (a returned output the caller holds),
and the old pool is freed with its last tensor. A CPU model runs the same
forward eagerly. There is no fallback: a capture or a replay that fails
raises.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import (
    ComputePolicy,
    M2Trans,
    m2trans_apply_microbatched,
    param_key,
)
from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv
from m2trans_tpu_torch.ops.kernels.halo_attn import cftm_branch
from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_fused

# the serving forward's kernel wrappers and their launch counters
COUNTED = {"cftm_branch": cftm_branch, "ff_conv": ff_conv,
           "tail_band": tail_band_fused}


def served(y: torch.Tensor, output_u8: bool) -> torch.Tensor:
    """A forward's output as a server hands it out: f32, or u8
    ``round(y * 255)`` with ``output_u8``, the product and the rounding in
    the forward's own dtype (bf16 under the bf16 policy), as the JAX
    ``StreamingSR`` quantises (m2trans_tpu/parallel/streaming.py:72-74)."""
    if output_u8:
        return torch.round(y * 255.0).to(torch.uint8)
    return y.float()


def serving_forward(model: M2Trans, x: torch.Tensor, cfg: Config,
                    policy: ComputePolicy, output_u8: bool) -> torch.Tensor:
    """The forward a server runs on one device: (B, H, W, colors) f32 in
    [0, 1] -> (B, H*s, W*s, 3), :func:`served`."""
    return served(m2trans_apply_microbatched(model, x, cfg, policy), output_u8)


def weights_key(model: torch.nn.Module) -> Tuple[Tuple[int, int], ...]:
    """:func:`~m2trans_tpu_torch.models.m2trans.param_key` of every
    parameter of ``model``: it changes when a parameter is written in place
    or replaced."""
    return tuple(param_key(p) for p in model.parameters())


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
    """One captured shape: the static input, the graph, its static output."""

    def __init__(self, inp: torch.Tensor, graph, out: torch.Tensor):
        self.inp, self.graph, self.out = inp, graph, out


class GraphedForward:
    """:func:`serving_forward` replayed from a CUDA graph per input shape.

    Args:
      model: the port's M2Trans, on its device.
      cfg: model Config.
      policy: numerics policy.
      output_u8: quantise the output to u8 on the device.
      max_graphs: the most shapes whose graphs are kept (None: no bound);
        the least recently replayed is dropped first.

    ``captures`` and ``replays`` count what it did; ``capture_launches``
    holds, for each captured shape, the launches of the kernel wrappers
    during the capture itself (the side-stream run before it excluded):
    the kernels each replay runs.
    """

    def __init__(self, model: M2Trans, cfg: Config, policy: ComputePolicy, *,
                 output_u8: bool = False, max_graphs: Optional[int] = None):
        self.model, self.cfg, self.policy = model, cfg, policy
        self.output_u8 = output_u8
        self.max_graphs = max_graphs
        self.device = next(model.parameters()).device
        self._pool = None  # the live graphs' memory pool
        self._graphs: "OrderedDict[Tuple[int, ...], _Entry]" = OrderedDict()
        self._key = None
        self.captures = self.replays = 0
        self.capture_launches: Dict[Tuple[int, ...], Dict[str, int]] = {}

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return serving_forward(self.model, x, self.cfg, self.policy,
                               self.output_u8)

    def _entry(self, shape: Tuple[int, ...]) -> _Entry:
        """The graph for ``shape``; captured now if there is none, or if a
        parameter changed since the graphs were captured (all are dropped)."""
        key = weights_key(self.model)
        if key != self._key:
            self._graphs.clear()
            self._key = key
        if shape in self._graphs:
            self._graphs.move_to_end(shape)
        else:
            if self.max_graphs is not None and len(self._graphs) >= self.max_graphs:
                self._graphs.popitem(last=False)
            if not self._graphs:
                self._pool = torch.cuda.graph_pool_handle()
            inp = torch.zeros(shape, dtype=torch.float32, device=self.device)
            counts = []  # the wrappers' launches in each call of fn

            def fn():
                before = {k: f.launches for k, f in COUNTED.items()}
                out = self._forward(inp)
                counts.append({k: f.launches - before[k]
                               for k, f in COUNTED.items()})
                return out

            graph, out = capture(fn, self._pool)
            self.capture_launches[shape] = counts[-1]  # the captured call's
            self._graphs[shape] = _Entry(inp, graph, out)
            self.captures += 1
        return self._graphs[shape]

    @torch.inference_mode()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The forward of ``x`` (B, H, W, colors) f32. On a CUDA model ``x``
        may lie on the card or on the host (a pinned host tensor is copied
        in without a wait); the result is the graph's static output, valid
        until the next call. On a CPU model: the eager forward."""
        if self.device.type != "cuda":
            return self._forward(x)
        entry = self._entry(tuple(x.shape))
        entry.inp.copy_(x, non_blocking=True)
        entry.graph.replay()
        self.replays += 1
        return entry.out
