"""Host ms a train step in the program's loader spans, ``m2t::loader.epoch``
(an epoch's start) and ``m2t::loader.next`` (a batch, the wait for the
loader's workers included); ``data.pipeline + runtime``. None where the
trace holds neither span or the window took no step."""

from h100bench.core.trace import in_window

SPANS = ("m2t::loader.epoch", "m2t::loader.next")


def host_spans(trace, names):
    """(start, end) of the host spans called one of ``names`` that start in
    the window. The profiler gives a span that launched device work a
    device-side copy of the same name over that work, which starts where its
    first kernel or copy starts: such a copy is left out."""
    on_device = {s for _, s, _ in trace["device"]}
    return [(s, e) for n, s, e in in_window(trace["host"], trace["window"])
            if n in names and s not in on_device]


def read(trace):
    spans = host_spans(trace, SPANS)
    if not spans or not trace.get("units"):
        return None
    return sum(e - s for s, e in spans) / 1e3 / trace["units"]
