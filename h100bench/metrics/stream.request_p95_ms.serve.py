"""The 95th percentile (nearest rank), over the requests of the traced
window, of a request's host time in the program: from the start of its
``m2t::stream.submit`` span to the end of its ``m2t::stream.copy_out`` span.
The i-th submit of the window pairs with its i-th copy-out (the stream hands
results out in order, and the window holds the whole stream);
``parallel.streaming``. None where the trace holds no such pair."""

import math

from h100bench.core.trace import in_window

SUBMIT, COPY_OUT = "m2t::stream.submit", "m2t::stream.copy_out"


def host_spans(trace, names):
    """(start, end) of the host spans called one of ``names`` that start in
    the window. The profiler gives a span that launched device work a
    device-side copy of the same name over that work, which starts where its
    first kernel or copy starts: such a copy is left out."""
    on_device = {s for _, s, _ in trace["device"]}
    return [(s, e) for n, s, e in in_window(trace["host"], trace["window"])
            if n in names and s not in on_device]


def read(trace):
    starts = sorted(s for s, _ in host_spans(trace, (SUBMIT,)))
    ends = [e for _, e in sorted(host_spans(trace, (COPY_OUT,)))]
    lat = sorted(e - s for s, e in zip(starts, ends))
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] / 1e3
