"""Host ms a request in the program's ``m2t::stream.submit`` spans
(``StreamingSR._submit``: the copy into the pinned slot, the graph replay's
launch, the copy back's enqueue, the event); ``parallel.streaming``. None
where the trace holds no such span or the window completed no request."""

from h100bench.core.trace import in_window

SPAN = "m2t::stream.submit"


def host_spans(trace, names):
    """(start, end) of the host spans called one of ``names`` that start in
    the window. The profiler gives a span that launched device work a
    device-side copy of the same name over that work, which starts where its
    first kernel or copy starts: such a copy is left out."""
    on_device = {s for _, s, _ in trace["device"]}
    return [(s, e) for n, s, e in in_window(trace["host"], trace["window"])
            if n in names and s not in on_device]


def read(trace):
    spans = host_spans(trace, (SPAN,))
    if not spans or not trace.get("units"):
        return None
    return sum(e - s for s, e in spans) / 1e3 / trace["units"]
