"""Host spans of the port in a ``torch.profiler`` trace.

A span is a ``record_function`` range, on the profiler's clock, which the
device's kernels share (CUPTI), so a trace can say what the host was doing
while the card ran or waited. :func:`span` opens one only while a profiler
is active; otherwise it returns one shared no-op context, since a
``record_function`` is a dispatcher op that costs microseconds even when
nothing records it.

Every span of the port is named here:

- ``m2t::augment``: a train step's draws and their staging
  (``train/loop.py``); ``m2t::device_step``: the step's graph replay, or
  its eager device part; ``m2t::wait``: :class:`~m2trans_tpu_torch.utils.
  staging.HostStager` waiting for a ring slot's copy (the host waiting for
  the device).
- ``m2t::stream.submit``: :class:`~m2trans_tpu_torch.parallel.streaming.
  StreamingSR`'s enqueue of a request (the copy into the pinned slot, the
  replay's launch, the copy back's enqueue, the event);
  ``m2t::stream.wait``: the host waiting on a request's event;
  ``m2t::stream.copy_out``: the result handed out (copied out of the slot's
  pinned buffer where the runner's pool lent none). Each carries the
  request's sequence number as its ``args``. ``m2t::stream.handoff``,
  inside a ``copy_out``: the result handed out in the pinned buffer lent
  for it, with no host copy (CUDA only).
- ``m2t::loader.epoch``: a train loader's start of an epoch;
  ``m2t::loader.next``: one batch, the wait for it included.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

AUGMENT = "m2t::augment"
DEVICE_STEP = "m2t::device_step"
WAIT = "m2t::wait"
STREAM_SUBMIT = "m2t::stream.submit"
STREAM_WAIT = "m2t::stream.wait"
STREAM_COPY_OUT = "m2t::stream.copy_out"
STREAM_HANDOFF = "m2t::stream.handoff"
LOADER_EPOCH = "m2t::loader.epoch"
LOADER_NEXT = "m2t::loader.next"

_OFF = contextlib.nullcontext()


def span(name: str, args=None):
    """``record_function(name, str(args))`` while a profiler is active, the
    shared no-op context otherwise."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return record_function(name, None if args is None else str(args))
