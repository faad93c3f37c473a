"""Host arrays to the card without a host wait.

A copy from pageable host memory makes the host wait until the copy is
done, and so until the device has run all the work queued before it: a
train step that copies its batch that way waits for the previous step.
:class:`HostStager` copies numpy arrays through page-locked buffers with
``non_blocking=True``: the host returns at once and runs ahead of the
device. The arrays of one call are packed into one buffer per dtype, so a
call is one copy per dtype, and come back as views of one device tensor.

A buffer must not be rewritten while its copy may still be reading it, so
there is a ring of ``SLOTS`` buffer sets: each set is reused only after the
CUDA event recorded after its last copy has completed (with two, the host
runs at most one call ahead of the copies). That wait is the span
``m2t::wait`` in a profiler trace (``utils/spans.py``): it is the host
waiting for the device, not work. On the CPU the arrays are returned as tensors that share their
memory, as ``torch.from_numpy`` does.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from m2trans_tpu_torch.utils.spans import WAIT, span

SLOTS = 2  # buffer sets in the ring


class HostStager:
    """numpy arrays -> tensors on ``device`` through a ring of page-locked
    buffers (see the module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._bufs: List[Dict[np.dtype, torch.Tensor]] = [{} for _ in range(SLOTS)]
        self._events: List = [None] * SLOTS
        self._next = 0

    def stage(self, arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """The arrays as tensors on the device, in order (the copies queued
        on the current stream, not waited for)."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        if not arrays or self.device.type != "cuda":
            return [torch.from_numpy(a) for a in arrays]
        slot = self._next
        self._next = (slot + 1) % len(self._bufs)
        if self._events[slot] is not None:
            with span(WAIT):
                self._events[slot].synchronize()
        out: List = [None] * len(arrays)
        groups: Dict[np.dtype, List[int]] = {}
        for i, a in enumerate(arrays):
            groups.setdefault(a.dtype, []).append(i)
        for dt, idx in groups.items():
            n = sum(arrays[i].size for i in idx)
            buf = self._bufs[slot].get(dt)
            if buf is None or buf.numel() < n:
                buf = self._bufs[slot][dt] = torch.from_numpy(
                    np.empty(max(n, 1), dt)).pin_memory()
            host, off = buf.numpy(), 0
            for i in idx:
                host[off:off + arrays[i].size] = arrays[i].reshape(-1)
                off += arrays[i].size
            dev, off = buf[:n].to(self.device, non_blocking=True), 0
            for i in idx:
                out[i] = dev[off:off + arrays[i].size].view(arrays[i].shape)
                off += arrays[i].size
        event = torch.cuda.Event()
        event.record()
        self._events[slot] = event
        return out
