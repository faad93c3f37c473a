"""Streaming cine-loop super-resolution; port of
m2trans_tpu/parallel/streaming.py.

Frames go through :func:`m2trans_apply_microbatched` on the model's
device or, with a ``mesh``, through
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
"""

from __future__ import annotations

import collections
import time
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.graphed import GraphedForward, served, serving_forward
from m2trans_tpu_torch.models.m2trans import ComputePolicy, M2Trans
from m2trans_tpu_torch.parallel.mesh import SpaceMesh
from m2trans_tpu_torch.parallel.spatial import spatial_sharded_forward


class StreamingSR:
    """Fixed-model streaming super-resolution runner.

    Args:
      model: the port's M2Trans, already on its device.
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

    def __init__(self, model: M2Trans, cfg: Config, *, mesh=None,
                 policy: Optional[ComputePolicy] = None, depth: int = 2,
                 output_u8: bool = False, graphs: bool = True):
        if mesh is not None and not isinstance(mesh, SpaceMesh):
            raise TypeError(f"StreamingSR: mesh must be a SpaceMesh "
                            f"(parallel.mesh.space_mesh), got {type(mesh).__name__}")
        self.model = model
        self.mesh = mesh
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.policy = policy or self.default_policy()
        self.depth = max(1, depth)
        self.output_u8 = output_u8
        self.latencies_s = []
        self._slots = {}  # (slot, frame shape) -> pinned (input, output)
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

    def _submit(self, frames: np.ndarray, slot: int):
        """Enqueue one batch of frames; returns what :meth:`_take` needs.
        CUDA: pinned upload, forward (a graph replay, or eager), copy back
        into the slot's pinned buffer, all asynchronous, then an event. CPU:
        the result itself."""
        frames = np.asarray(frames, np.float32)
        if self.device.type != "cuda":
            return self._fwd(torch.from_numpy(frames)), None
        pin_in, pin_out = self._pinned(slot, frames.shape)
        pin_in.copy_(torch.from_numpy(frames))
        if self.graphed is not None:
            y = self.graphed(pin_in)
        else:
            y = self._fwd(pin_in.to(self.device, non_blocking=True))
        pin_out.copy_(y, non_blocking=True)
        done = torch.cuda.Event(enable_timing=True)
        done.record(torch.cuda.current_stream(self.device))
        return pin_out, done

    @staticmethod
    def _take(out: torch.Tensor, done) -> np.ndarray:
        """The frame's result on the host. CUDA: waits on the frame's own
        event and hands out a copy (the slot's buffer is reused)."""
        if done is None:
            return out.numpy()
        done.synchronize()
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
            out, done, t0 = inflight.popleft()
            # CUDA: waits on this frame's event; later frames stay in flight
            res = self._take(out, done)
            if collect_stats:
                landed = (time.perf_counter() if done is None
                          else host0 + base.elapsed_time(done) / 1e3)
                self.latencies_s.append(landed - t0)
            return res

        # at most `depth` frames are in flight and frame n - depth was
        # popped before frame n is submitted, so frame n takes slot n mod depth
        for n, frame in enumerate(frames):
            t0 = time.perf_counter()
            inflight.append((*self._submit(frame, n % self.depth), t0))
            if len(inflight) >= self.depth:
                yield pop()
        while inflight:
            yield pop()

    def latency_percentiles(self):
        lat = sorted(self.latencies_s or [])
        if not lat:
            return {}

        def pick(q):
            return lat[min(len(lat) - 1, int(q * len(lat)))]

        return {"p50_s": pick(0.5), "p90_s": pick(0.9), "p99_s": pick(0.99)}
