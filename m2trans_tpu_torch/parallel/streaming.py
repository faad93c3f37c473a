"""Streaming cine-loop super-resolution; port of
m2trans_tpu/parallel/streaming.py for one device.

Frames go through :func:`m2trans_apply_microbatched` on the model's
device. :meth:`StreamingSR.stream` keeps ``depth`` frames in flight: the
forward of frame t+1 is enqueued on the CUDA stream before the result of
frame t is copied back, so host I/O overlaps device compute. Spatial
sharding over a mesh is not ported yet.
"""

from __future__ import annotations

import collections
import time
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import (
    ComputePolicy,
    M2Trans,
    m2trans_apply_microbatched,
)


class StreamingSR:
    """Fixed-model streaming super-resolution runner.

    Args:
      model: the port's M2Trans, already on its device.
      cfg: model Config.
      mesh: must be None (spatial sharding is not ported yet).
      policy: numerics policy; defaults to bf16 with the kernels.
      depth: frames in flight.
      output_u8: quantize SR frames to uint8 (round(x*255)) on the device
        before the copy back, 4x fewer bytes than f32.
    """

    @staticmethod
    def default_policy() -> ComputePolicy:
        return ComputePolicy(dtype=torch.bfloat16, use_kernels=True)

    def __init__(self, model: M2Trans, cfg: Config, *, mesh=None,
                 policy: Optional[ComputePolicy] = None, depth: int = 2,
                 output_u8: bool = False):
        if mesh is not None:
            raise NotImplementedError(
                "StreamingSR: spatial sharding over a mesh is not ported yet")
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.policy = policy or self.default_policy()
        self.depth = max(1, depth)
        self.output_u8 = output_u8
        self.latencies_s = []

    @torch.inference_mode()
    def _fwd(self, frames: np.ndarray) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(frames, np.float32)).to(self.device)
        y = m2trans_apply_microbatched(self.model, x, self.cfg, self.policy)
        if self.output_u8:
            return torch.round(y.float() * 255.0).to(torch.uint8)
        return y.float()

    def warmup(self, frame_shape: Tuple[int, ...]) -> None:
        self._fwd(np.zeros(frame_shape, np.float32)).cpu()

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        """One synchronous batch: (B, H, W, C) [0,1] -> (B, H*s, W*s, 3)."""
        return self._fwd(frames).cpu().numpy()

    def stream(self, frames: Iterable[np.ndarray],
               collect_stats: bool = False) -> Iterator[np.ndarray]:
        """Yields SR frames in order while later frames are in flight. With
        ``collect_stats`` the per-frame wall-clock latencies (enqueue to
        result on the host) go to ``self.latencies_s``."""
        self.latencies_s = []
        inflight = collections.deque()

        def pop():
            out, t0 = inflight.popleft()
            res = out.cpu().numpy()  # waits for this frame only
            if collect_stats:
                self.latencies_s.append(time.perf_counter() - t0)
            return res

        for frame in frames:
            t0 = time.perf_counter()
            inflight.append((self._fwd(frame), t0))
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
