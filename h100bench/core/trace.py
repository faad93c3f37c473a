"""The traced run: ``torch.profiler`` (CUPTI) over the window, reduced to
what the per-layer readers and the result line need.

:class:`Traced` profiles host and device activity around the window and
marks the window itself with the host span ``h100bench::window``. After
the window, :func:`reduce` keeps, as plain tuples in microseconds of the
profiler's clock:

- ``device``: every kernel, copy and memset (name, start, end); the
  device-side shadows of ``record_function`` ranges are left out, since
  they would count the kernels inside them twice;
- ``host``: every ``record_function`` span of the harness
  (``h100bench::*``) and of the program (``m2t::*``);
- ``window``: the window's (start, end).

The readers in ``h100bench/metrics/`` take this dict with the driver's
counts added (``units`` completed in the window, ``kind``, the frozen
counts). :func:`device_summary` gives the result line's ``busy_s`` and
``window_s`` and its ``breakdown``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from h100bench.core.stats import gaps, union_seconds

WINDOW = "h100bench::window"
HOST_PREFIXES = ("h100bench::", "m2t::")


class Traced:
    """A context manager: the profiler when ``on``, nothing otherwise."""

    def __init__(self, on: bool, cuda: bool = True):
        self.on, self.cuda, self.prof = on, cuda, None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            if self.cuda:
                import torch

                torch.cuda.synchronize()
            self.prof.__exit__(*exc)
        return False


def _is_device(ev) -> bool:
    import torch

    return (ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False))


def reduce(prof) -> Dict[str, Any]:
    """The profiler's events as the readers take them (see the module
    docstring); the window spans from the first ``h100bench::window``
    span's start to its end."""
    device: List[Tuple[str, float, float]] = []
    host: List[Tuple[str, float, float]] = []
    for ev in prof.events():
        start, end = float(ev.time_range.start), float(ev.time_range.end)
        if _is_device(ev):
            device.append((ev.name, start, end))
        elif ev.name.startswith(HOST_PREFIXES):
            host.append((ev.name, start, end))
    spans = [(a, b) for n, a, b in host if n == WINDOW]
    if not spans:
        raise RuntimeError("the trace holds no h100bench::window span")
    return {"device": device, "host": host, "window": spans[0]}


def in_window(events, window) -> list:
    """The events (name, start, end) that start inside the window."""
    a, b = window
    return [e for e in events if a <= e[1] < b]


def device_summary(trace: Dict[str, Any], top: int = 10) -> Dict[str, Any]:
    """``busy_s`` (the union of the device's intervals inside the window),
    ``window_s``, and the ``breakdown``: the ``top`` device operations by
    their summed seconds in the window, and the ``top`` longest idle gaps
    named by the innermost host span that covers each gap's middle."""
    a, b = trace["window"]
    dev = [(s, e) for _, s, e in trace["device"]]
    busy_us = union_seconds(dev, a, b)
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in in_window(trace["device"], trace["window"]):
        by_name[name[:160]] += (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = []
    for s, e in sorted(gaps(dev, a, b), key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        covering = [h for h in trace["host"] if h[1] <= mid <= h[2] and h[0] != WINDOW]
        label = max(covering, key=lambda h: h[1])[0] if covering else "no span"
        idle.append([label, (e - s) / 1e6])
    return {"busy_s": busy_us / 1e6, "window_s": (b - a) / 1e6,
            "breakdown": {"device_ops": [[n, v] for n, v in ops], "idle_gaps": idle}}


def kind_ms(trace: Dict[str, Any], pick) -> Optional[float]:
    """Device ms a unit (request or step) of the events inside the window
    whose name ``pick`` accepts; None where the window completed no unit."""
    units = trace.get("units") or 0
    if not units:
        return None
    total = sum(e - s for n, s, e in in_window(trace["device"], trace["window"]) if pick(n))
    return total / 1e3 / units


def host_ms(trace: Dict[str, Any], name: str) -> float:
    """Host ms summed over the spans called ``name`` that start inside the
    window."""
    return sum(e - s for n, s, e in in_window(trace["host"], trace["window"])
               if n == name) / 1e3
