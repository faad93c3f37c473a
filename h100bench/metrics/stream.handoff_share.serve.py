"""Share of the window's requests, %, whose result the program handed out
without a host copy: the program's ``m2t::stream.copy_out`` spans that
start in the window and hold an ``m2t::stream.handoff`` span (the result
handed out in the pinned buffer lent for it), over all of those copy-outs;
``parallel.streaming``. A program without the handoff span reads 0. None
where the window holds no copy-out span."""

import bisect

from h100bench.core.trace import in_window

COPY_OUT = "m2t::stream.copy_out"
HANDOFF = "m2t::stream.handoff"


def host_spans(trace, names, window):
    """(start, end) of the host spans called one of ``names`` that start in
    ``window``. The profiler gives a span that launched device work a
    device-side copy of the same name over that work, which starts where its
    first kernel or copy starts: such a copy is left out."""
    on_device = {s for _, s, _ in trace["device"]}
    return [(s, e) for n, s, e in in_window(trace["host"], window)
            if n in names and s not in on_device]


def read(trace):
    copies = host_spans(trace, (COPY_OUT,), trace["window"])
    if not copies:
        return None
    starts = sorted(s for s, _ in host_spans(trace, (HANDOFF,), (float("-inf"), float("inf"))))
    held = sum(1 for s, e in copies
               if bisect.bisect_left(starts, s) < bisect.bisect_right(starts, e))
    return 100.0 * held / len(copies)
