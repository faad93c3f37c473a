"""Share of the traced window, %, in which the device runs no kernel, copy or
memset while the host is inside the program's ``m2t::stream.copy_out``
spans (the result copied out of the slot's pinned buffer): the device's idle
stretches intersected with those spans; ``parallel.streaming``. None where
the trace holds no such span inside the window."""

from h100bench.core.stats import gaps, merged
from h100bench.core.trace import in_window

SPAN = "m2t::stream.copy_out"


def host_spans(trace, names):
    """(start, end) of the host spans called one of ``names`` that start in
    the window. The profiler gives a span that launched device work a
    device-side copy of the same name over that work, which starts where its
    first kernel or copy starts: such a copy is left out."""
    on_device = {s for _, s, _ in trace["device"]}
    return [(s, e) for n, s, e in in_window(trace["host"], trace["window"])
            if n in names and s not in on_device]


def read(trace):
    a, b = trace["window"]
    held = merged(host_spans(trace, (SPAN,)), a, b)
    if b <= a or not held:
        return None
    idle = gaps([(s, e) for _, s, e in trace["device"]], a, b)
    both, i, j = 0.0, 0, 0
    while i < len(idle) and j < len(held):  # two sorted lists of disjoint intervals
        both += max(0.0, min(idle[i][1], held[j][1]) - max(idle[i][0], held[j][0]))
        if idle[i][1] < held[j][1]:
            i += 1
        else:
            j += 1
    return 100.0 * both / (b - a)
