"""Device ms a train step in Adam: the kernels, copies and memsets that
start after a ``m2t_mark_optimizer_begin`` mark ends and before the next
``m2t_mark_optimizer_end`` starts (``optimizer.step()``); the marks are
empty kernels that the step's CUDA graph replays in order on one stream.
``train.loop``. None where the trace holds no pair of marks inside the
window or the window took no step."""

PAIRS = (("m2t_mark_optimizer_begin", "m2t_mark_optimizer_end"),)


def between(trace, begin, end):
    """(device us, pairs): the device events that start after each ``begin``
    mark that starts in the window has ended and before the next ``end``
    mark starts, and the number of such pairs."""
    a, b = trace["window"]
    us, pairs, opened, pending = 0.0, 0, None, 0.0
    for name, s, e in sorted(trace["device"], key=lambda ev: ev[1]):
        kernel = name.split("(")[0]
        if kernel == begin:
            opened, pending = (e if a <= s < b else None), 0.0
        elif kernel == end:
            if opened is not None:
                us, pairs = us + pending, pairs + 1
            opened = None
        elif opened is not None and s >= opened:
            pending += e - s
    return us, pairs


def read(trace):
    got = [between(trace, begin, end) for begin, end in PAIRS]
    if not trace.get("units") or not any(pairs for _, pairs in got):
        return None
    return sum(us for us, _ in got) / 1e3 / trace["units"]
