"""The serving forward as one CUDA graph per input shape; the port's
counterpart of ``jax.jit`` in m2trans_tpu/parallel/streaming.py.

The JAX package compiles the serving forward once per frame shape and then
dispatches one executable a frame. Run eagerly, the port's forward is about
250 launches from Python a frame, and on the card the host, not the device,
bounds it. :class:`GraphedForward` captures the served model's forward
(:func:`serving_forward`: the forward of the model's ``models/served.py``
entry) and the output cast (f32, or u8 as ``round(y * 255)`` in the
forward's dtype) into a ``torch.cuda.CUDAGraph`` the first time it sees an
input shape, as ``jax.jit`` traces on a first call, and replays it after:
one launch from the host a frame.

Capture (:func:`capture`) runs the function once on a side stream first, so
that everything built at first use is built outside the capture: the
kernel library, the weight operands that ``models/numerics.py::prepared``
keeps on the modules, the constants of ``ops.on_device``, cuBLAS and cuDNN
state. The f32 policy's forward sets its TF32-off flags
(``numerics.no_tf32``) inside the captured function, so the captured
cuBLAS and cuDNN calls are the TF32-off ones.

A graph replays the pointers it was captured with, as a JAX executable
reads its arguments: the weights, and the operands ``prepared`` laid out
from them (M2Trans's bf16 qkv weights and K3's weight and bias, HAT's bf16
weights). A graph outlives a write into the weights in place (an optimizer
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
by ``prepared``.

The per-shape cache is :class:`GraphCache`, which
``train/evaluate.py::GraphedMetrics`` shares. Its graphs share one memory
pool and one stream: a call returns the graph's static output, valid until
the next call (of any shape). A shape beyond ``max_graphs`` runs eagerly on
every call, so none is captured twice while the graphs stand. A capture
with no graph left takes a new pool: the allocator refuses a capture into a
pool that no graph uses while a tensor of it is alive (an output the caller
holds). There is no fallback: a capture or a replay that fails raises.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models import served as served_models
from m2trans_tpu_torch.models.numerics import (
    ComputePolicy,
    cached_operands,
    param_key,
    refresh_operands,
)


@contextlib.contextmanager
def counting(counted: Dict[str, Callable]):
    """Yields a dict that holds, once the block has run, the launches each
    kernel wrapper of ``counted`` (by name) counted inside it."""
    before = {k: f.launches for k, f in counted.items()}
    launches: Dict[str, int] = {}
    yield launches
    launches.update({k: f.launches - before[k] for k, f in counted.items()})


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
    [0, 1] -> (B, H*s, W*s, 3), :func:`served`; the forward is that of the
    model's ``models/served.py`` entry, clamped by its own rule."""
    forward = served_models.of(model).forward
    return served(forward(model, x, cfg, policy, output_u8), output_u8)


def weights_key(model: torch.nn.Module) -> Tuple[Tuple[int, int], ...]:
    """:func:`~m2trans_tpu_torch.models.numerics.param_key` of every
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
    """One captured shape: static inputs, graph, static output, and what the
    graph reads that it keeps alive."""

    def __init__(self, inputs: Tuple[torch.Tensor, ...], graph, out: torch.Tensor,
                 held: Any = ()):
        self.inputs, self.graph, self.out, self.held = inputs, graph, out, held


class GraphCache:
    """``_fn`` (a subclass's, on ``n_inputs`` f32 tensors of one shape)
    replayed from a CUDA graph per shape, at most ``max_graphs`` (None: no
    bound) shapes, the rest eager; off CUDA ``device`` every call is eager.
    ``captures``, ``replays`` and ``eager_calls`` count what it did;
    ``capture_launches`` holds, a captured shape, the launches of the
    wrappers ``counted`` (by name) in the capture itself, the side-stream
    run excluded: the kernels each replay runs."""

    n_inputs = 1

    def __init__(self, device, max_graphs: Optional[int] = None,
                 counted: Optional[Dict[str, Callable]] = None):
        self.device = torch.device(device)
        self.graphs = self.device.type == "cuda"  # False: eager
        self.max_graphs = max_graphs
        self.counted = counted or {}
        self._pool = None  # the live graphs' memory pool
        self._graphs: Dict[Tuple[int, ...], _Entry] = {}
        self.captures = self.replays = self.eager_calls = 0
        self.capture_launches: Dict[Tuple[int, ...], Dict[str, int]] = {}

    def _fn(self, *inputs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _capture(self, shape: Tuple[int, ...]) -> _Entry:
        """A graph of ``_fn`` on static zero inputs of ``shape``."""
        inputs = tuple(torch.zeros(shape, dtype=torch.float32, device=self.device)
                       for _ in range(self.n_inputs))
        counts = []  # the wrappers' launches in each call of fn

        def fn():
            with counting(self.counted) as launches:
                out = self._fn(*inputs)
            counts.append(launches)
            return out

        graph, out = capture(fn, self._pool)
        self.capture_launches[shape] = counts[-1]  # the captured call's
        return _Entry(inputs, graph, out)

    def _entry(self, shape: Tuple[int, ...]) -> Optional[_Entry]:
        """The graph for ``shape``, captured now if it has none; None for a
        shape beyond ``max_graphs``."""
        if shape in self._graphs:
            return self._graphs[shape]
        if self.max_graphs is not None and len(self._graphs) >= self.max_graphs:
            return None
        if not self._graphs:
            self._pool = torch.cuda.graph_pool_handle()
        self._graphs[shape] = self._capture(shape)
        self.captures += 1
        return self._graphs[shape]

    @torch.inference_mode()
    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        """``_fn(*inputs)``, the inputs of one shape: on CUDA the graph's
        static output, valid until the next call (inputs on the host are
        copied in without a wait if pinned; an eager result for a shape
        beyond ``max_graphs``); off CUDA the eager result."""
        if not self.graphs:
            return self._fn(*inputs)
        entry = self._entry(tuple(inputs[-1].shape))
        if entry is None:
            self.eager_calls += 1
            return self._fn(*(t.to(self.device, non_blocking=True) for t in inputs))
        for static, t in zip(entry.inputs, inputs):
            static.copy_(t, non_blocking=True)
        entry.graph.replay()
        self.replays += 1
        return entry.out


class GraphedForward(GraphCache):
    """:func:`serving_forward` of a served model (``models/served.py``, on
    its device) replayed from a CUDA graph per input shape: a call takes
    ``x`` (B, H, W, colors) f32, on the card or on the host. Counters as
    :class:`GraphCache`'s, the launches those of the model's entry's
    ``counted``; ``refreshes`` counts the operand rewrites before a replay
    after a weight write."""

    def __init__(self, model: torch.nn.Module, cfg: Config, policy: ComputePolicy, *,
                 output_u8: bool = False, max_graphs: Optional[int] = None):
        super().__init__(next(model.parameters()).device, max_graphs,
                         served_models.of(model).counted)
        self.model, self.cfg, self.policy = model, cfg, policy
        self.output_u8 = output_u8
        self._weights = self._storage = None  # the keys the graphs stand on
        self.refreshes = 0

    def _fn(self, x: torch.Tensor) -> torch.Tensor:
        return serving_forward(self.model, x, self.cfg, self.policy, self.output_u8)

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

    def _capture(self, shape: Tuple[int, ...]) -> _Entry:
        entry = super()._capture(shape)
        entry.held = [op for op in cached_operands(self.model) if op.dtype == self.policy.dtype]
        # the capture's first use built the operands: the keys now include them
        self._weights = weights_key(self.model)
        self._storage = storage_key(self.model, self.policy.dtype)
        return entry

    def _entry(self, shape: Tuple[int, ...]) -> Optional[_Entry]:
        self._ready()
        return super()._entry(shape)
