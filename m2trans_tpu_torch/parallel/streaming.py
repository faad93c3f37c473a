"""Streaming cine-loop super-resolution; port of
m2trans_tpu/parallel/streaming.py.

Frames go through the model's serving forward
(``models/graphed.py::serving_forward``, a model of ``models/served.py``)
on the model's device or, for a model whose entry allows sharding by rows
(``row_sharded``) with a ``mesh``, through
:func:`~m2trans_tpu_torch.parallel.spatial.spatial_sharded_forward` over
its ranks: every rank of the mesh runs the same stream and takes part in
every frame, and each gets the whole SR frame. A rank outside the mesh
(``mesh.rank`` -1: the world has more ranks than the mesh uses) runs the
single-device forward, as ``train/evaluate.py::make_forward_fn`` does.

:meth:`StreamingSR.stream` keeps ``depth`` frames in flight. On a CUDA
model each in-flight slot owns a pinned host input buffer and a pinned host
output buffer (allocated per frame shape, reused): the frame goes up
with a non-blocking copy, its forward is enqueued, the copy back into the
slot's pinned buffer is enqueued non-blocking right after it and a CUDA event
is recorded. Taking a result waits on that frame's own event only, so the
host runs up to ``depth`` frames ahead and the copy back of frame t does
not hold the forward of frame t+1. A frame's latency is the time from its
enqueue to its result lying in the pinned buffer, read off its event's
device timestamp (against an event recorded at the start of the stream), so
it does not grow by what the consumer does before it asks for the frame. On
a CPU model nothing is pinned and no event is used (the latency ends when
the frame is handed out); frames and their order are the same.

On a CUDA model without a mesh the forward is a CUDA graph per frame shape
(:class:`~m2trans_tpu_torch.models.graphed.GraphedForward`), captured the
first time a shape is seen (:meth:`StreamingSR.warmup` captures, as the JAX
``warmup`` compiles) and replayed after: the slot's pinned input is copied
into the graph's static input without a wait, the graph is replayed, and its
static output is copied into the slot's pinned output without a wait. The
copies, the replay and the event are all enqueued on the one current
stream, in that order, so at ``depth`` > 1 the next frame's copy into the
static input runs after the previous replay, and the next replay after the
previous copy out: the static buffers shared by the in-flight frames are
safe without further synchronisation. With a mesh the path stays eager:
its collectives under gloo stage through host memory, which a CUDA graph
cannot capture. ``graphs=False`` runs the eager forward too (the tests and
``chip_smoke.py`` compare the two).

In a profiler trace each request shows as three host spans
(``utils/spans.py``), each with the request's sequence number in the stream
as its ``args``: ``m2t::stream.submit`` (all of the enqueue),
``m2t::stream.wait`` (the host waiting on the request's event) and
``m2t::stream.copy_out`` (the result handed out; on a CUDA model it holds
``m2t::stream.handoff`` where the frame goes out in its lent buffer, and
the copy where it is copied out of the slot's buffer).
"""

from __future__ import annotations

import collections
import math
import time
import weakref
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models import served as served_models
from m2trans_tpu_torch.models.graphed import GraphedForward, served, serving_forward
from m2trans_tpu_torch.models.numerics import ComputePolicy
from m2trans_tpu_torch.parallel.mesh import SpaceMesh
from m2trans_tpu_torch.parallel.spatial import spatial_sharded_forward
from m2trans_tpu_torch.utils.spans import (
    STREAM_COPY_OUT,
    STREAM_HANDOFF,
    STREAM_SUBMIT,
    STREAM_WAIT,
    span,
)

# The most bytes of result buffers a runner's pool holds, lent or free:
# 42 frames of 2048^2 f32, 151 requests of 8 x 384^2 f32.
HANDOFF_LIMIT_BYTES = 2 << 30


def _pinned_empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class ResultPool:
    """Host buffers that results are handed out in, each lent for one result.

    :meth:`lend` gives a tensor on a buffer made by ``alloc`` (pinned
    memory on a CUDA model) or kept from an earlier result of the same shape
    and dtype. The buffer comes back when that tensor and everything made
    from it (its ``.numpy()`` array, that array's views, tensors on them)
    are gone; a buffer lent out is never lent again before. The pool holds
    at most :data:`HANDOFF_LIMIT_BYTES` of buffers, lent or free; to make a
    new one it first lets go of free buffers of other shapes, and where that
    is not enough it lends nothing.
    """

    def __init__(self, alloc=_pinned_empty):
        self._alloc = alloc
        self._free = {}  # (shape, dtype) -> buffers not lent
        # buffers given back; filed by the pool's own calls, since the
        # consumer may drop the last view on any thread
        self._back = collections.deque()
        self._held = 0  # bytes of the buffers kept, lent or free
        self._lent = 0  # bytes of the buffers lent out
        self.made = 0  # buffers allocated

    @staticmethod
    def is_lent(t: torch.Tensor) -> bool:
        """Whether :meth:`lend` gave out ``t``."""
        return getattr(t, "_m2t_lent", False)

    @property
    def lent_bytes(self) -> int:
        self._file_returns()
        return self._lent

    def _file_returns(self) -> None:
        while self._back:
            key, buf = self._back.popleft()
            self._free.setdefault(key, []).append(buf)
            self._lent -= buf.nbytes

    def lend(self, shape, dtype: torch.dtype) -> Optional[torch.Tensor]:
        """A buffer of ``shape`` and ``dtype`` for one result, or None when
        the bytes lent out would pass :data:`HANDOFF_LIMIT_BYTES`."""
        self._file_returns()
        key = (tuple(shape), dtype)
        nbytes = math.prod(shape) * dtype.itemsize
        free = self._free.get(key)
        if free:
            buf = free.pop()
        else:
            for other in self._free.values():
                while other and self._held + nbytes > HANDOFF_LIMIT_BYTES:
                    self._held -= other.pop().nbytes
            if self._held + nbytes > HANDOFF_LIMIT_BYTES:
                return None
            buf = self._alloc(shape, dtype)
            self._held += nbytes
            self.made += 1
        self._lent += nbytes
        # The buffer comes back when `anchor` dies: its views have it as
        # their base, and every tensor on it (the one returned, its
        # ``.numpy()``, ``torch.from_numpy`` of a view) holds it from its
        # storage. The returned tensor cannot be the anchor: its ``.numpy()``
        # is based on a new alias of it.
        anchor = buf.numpy()
        weakref.finalize(anchor, self._back.append, (key, buf))
        lent = torch.from_numpy(anchor)
        lent._m2t_lent = True
        return lent


class StreamingSR:
    """Fixed-model streaming super-resolution runner.

    Args:
      model: a served model (``models/served.py``), already on its device.
      cfg: model Config.
      mesh: optional :class:`~m2trans_tpu_torch.parallel.mesh.SpaceMesh`
        whose ranks shard every frame by rows (a rank outside it runs the
        single-device forward).
      policy: numerics policy; defaults to bf16 with the kernels.
      depth: frames in flight.
      output_u8: quantize SR frames to uint8 (round(x*255)) on the device
        before the copy back, 4x fewer bytes than f32.
      graphs: on a CUDA model without a mesh, replay a CUDA graph per frame
        shape (``self.graphed``); False runs the forward eagerly.
    """

    @staticmethod
    def default_policy() -> ComputePolicy:
        return ComputePolicy(dtype=torch.bfloat16, use_kernels=True)

    def __init__(self, model: torch.nn.Module, cfg: Config, *, mesh=None,
                 policy: Optional[ComputePolicy] = None, depth: int = 2,
                 output_u8: bool = False, graphs: bool = True):
        if mesh is not None and not isinstance(mesh, SpaceMesh):
            raise TypeError(f"StreamingSR: mesh must be a SpaceMesh "
                            f"(parallel.mesh.space_mesh), got {type(mesh).__name__}")
        if mesh is not None and not served_models.of(model).row_sharded:
            raise ValueError(f"StreamingSR: {type(model).__name__} runs on one device; "
                             "sharding its frames over rows is not supported (serve it "
                             "without a mesh)")
        self.model = model
        self.mesh = mesh
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.policy = policy or self.default_policy()
        self.depth = max(1, depth)
        self.output_u8 = output_u8
        self.latencies_s = []
        self._slots = {}  # (slot, frame shape) -> pinned (input, output)
        self.results = ResultPool()
        self.handed_out = self.copied_out = 0  # CUDA results lent / copied
        self.graphed = (GraphedForward(model, cfg, self.policy, output_u8=output_u8)
                        if graphs and mesh is None and self.device.type == "cuda"
                        else None)

    @torch.inference_mode()
    def _fwd(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None and self.mesh.rank >= 0:
            return served(spatial_sharded_forward(
                self.model, x, self.cfg, mesh=self.mesh, policy=self.policy),
                self.output_u8)
        return serving_forward(self.model, x, self.cfg, self.policy, self.output_u8)

    def _pinned(self, slot: int, shape: Tuple[int, ...]):
        """The slot's pinned host buffers for frames of ``shape``."""
        key = (slot, tuple(shape))
        if key not in self._slots:
            s = self.cfg.scale
            out_shape = (shape[0], shape[1] * s, shape[2] * s, 3)
            self._slots[key] = (
                torch.empty(shape, dtype=torch.float32, pin_memory=True),
                torch.empty(out_shape, pin_memory=True,
                            dtype=torch.uint8 if self.output_u8 else torch.float32))
        return self._slots[key]

    def _submit(self, frames: np.ndarray, slot: int, seq=None):
        """Enqueue one batch of frames (request ``seq`` of a stream); returns
        what :meth:`_take` needs. CUDA: pinned upload, forward (a graph
        replay, or eager), copy back into a buffer lent by ``results`` (the
        slot's pinned buffer where the pool lends none), all asynchronous,
        then an event. CPU: the result itself."""
        with span(STREAM_SUBMIT, seq):
            frames = np.asarray(frames, np.float32)
            if self.device.type != "cuda":
                return self._fwd(torch.from_numpy(frames)), None
            pin_in, pin_out = self._pinned(slot, frames.shape)
            pin_in.copy_(torch.from_numpy(frames))
            if self.graphed is not None:
                y = self.graphed(pin_in)
            else:
                y = self._fwd(pin_in.to(self.device, non_blocking=True))
            out = self._landing(pin_out)
            out.copy_(y, non_blocking=True)
            done = torch.cuda.Event(enable_timing=True)
            done.record(torch.cuda.current_stream(self.device))
            return out, done

    def _landing(self, pin_out: torch.Tensor) -> torch.Tensor:
        """Where a result's copy back lands: a buffer that ``results`` lends
        for it, or the slot's ``pin_out`` past the pool's limit."""
        out = self.results.lend(pin_out.shape, pin_out.dtype)
        if out is None:
            self.copied_out += 1
            return pin_out
        self.handed_out += 1
        return out

    @staticmethod
    def _take(out: torch.Tensor, done) -> np.ndarray:
        """The frame's result on the host. CUDA: waits on the frame's own
        event, then hands out a lent buffer as it is and copies the slot's
        buffer, which the slot reuses."""
        if done is None:
            return out.numpy()
        done.synchronize()
        if ResultPool.is_lent(out):
            with span(STREAM_HANDOFF):
                return out.numpy()
        return out.numpy().copy()

    def warmup(self, frame_shape: Tuple[int, ...]) -> None:
        """Runs one batch of ``frame_shape``: on the graph path it captures
        that shape's graph."""
        self._take(*self._submit(np.zeros(frame_shape, np.float32), 0))

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        """One synchronous batch: (B, H, W, C) [0,1] -> (B, H*s, W*s, 3)."""
        return self._take(*self._submit(frames, 0))

    def stream(self, frames: Iterable[np.ndarray],
               collect_stats: bool = False) -> Iterator[np.ndarray]:
        """Yields SR frames in order while later frames are in flight. With
        ``collect_stats`` the per-frame wall-clock latencies (enqueue to
        result on the host) go to ``self.latencies_s``."""
        self.latencies_s = []
        inflight = collections.deque()
        base = host0 = None
        if collect_stats and self.device.type == "cuda":
            # the stream's clock: an event on the idle stream and the host
            # time at which it passed
            base = torch.cuda.Event(enable_timing=True)
            base.record(torch.cuda.current_stream(self.device))
            base.synchronize()
            host0 = time.perf_counter()

        def pop():
            out, done, t0, seq = inflight.popleft()
            # CUDA: waits on this frame's event; later frames stay in flight
            if done is not None:
                with span(STREAM_WAIT, seq):
                    done.synchronize()
            with span(STREAM_COPY_OUT, seq):  # the event has passed: the copy alone
                res = self._take(out, done)
            if collect_stats:
                landed = (time.perf_counter() if done is None
                          else host0 + base.elapsed_time(done) / 1e3)
                self.latencies_s.append(landed - t0)
            return res

        # at most `depth` frames are in flight and frame n - depth was
        # popped before frame n is submitted, so frame n takes slot n mod depth
        try:
            for n, frame in enumerate(frames):
                t0 = time.perf_counter()
                inflight.append((*self._submit(frame, n % self.depth, n), t0, n))
                if len(inflight) >= self.depth:
                    yield pop()
            while inflight:
                yield pop()
        finally:
            # a stream left early drops results never taken: their buffers
            # go back to the pool only once their copies have landed
            for _, done, _, _ in inflight:
                if done is not None:
                    done.synchronize()

    def latency_percentiles(self):
        lat = sorted(self.latencies_s or [])
        if not lat:
            return {}

        def pick(q):
            return lat[min(len(lat) - 1, int(q * len(lat)))]

        return {"p50_s": pick(0.5), "p90_s": pick(0.9), "p99_s": pick(0.99)}
