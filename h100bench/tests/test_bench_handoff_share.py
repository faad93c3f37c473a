"""``stream.handoff_share.serve`` on small synthetic traces: the share of
the window's copy-outs that hold a handoff, the profiler's device-side
copies left out, and None without a copy-out in the window."""

import pytest

from h100bench.core import spec

COPY_OUT, HANDOFF = "m2t::stream.copy_out", "m2t::stream.handoff"
WINDOW = ("h100bench::window", 0.0, 1000.0)


def _trace(host, device=()):
    return {"window": (0.0, 1000.0), "units": 4, "kind": "serve",
            "host": [WINDOW, *host], "device": list(device)}


def read(trace):
    return spec.reader("stream.handoff_share.serve").read(trace)


COPIES = [(COPY_OUT, 100.0 * i + 50.0, 100.0 * i + 80.0) for i in range(4)]


def _handoffs(which):
    return [(HANDOFF, 100.0 * i + 60.0, 100.0 * i + 70.0) for i in which]


@pytest.mark.parametrize("which, share", [((), 0.0), ((0, 1, 2, 3), 100.0), ((1, 3), 50.0)])
def test_share_of_copy_outs_that_hold_a_handoff(which, share):
    assert read(_trace(COPIES + _handoffs(which))) == pytest.approx(share)


def test_device_side_copies_are_left_out():
    # each span's device-side copy starts where a kernel starts: none counts
    device = [("k", 10.0, 20.0), ("k", 30.0, 40.0)]
    copies = [(COPY_OUT, 10.0, 45.0), (HANDOFF, 30.0, 44.0)]
    assert read(_trace(COPIES + _handoffs((0, 1)) + copies, device)) == pytest.approx(50.0)


def test_copy_outs_outside_the_window_do_not_count():
    late = [(COPY_OUT, 1200.0, 1300.0), (HANDOFF, 1210.0, 1220.0)]
    early = [(COPY_OUT, -90.0, 5.0), (HANDOFF, 1.0, 2.0)]  # its handoff starts inside
    assert read(_trace(COPIES + _handoffs((0,)) + late + early)) == pytest.approx(25.0)


def test_none_without_a_copy_out_in_the_window():
    assert read(_trace([("h100bench::stream_next", 0.0, 900.0)])) is None
    assert read(_trace([(COPY_OUT, 1200.0, 1300.0), (HANDOFF, 1210.0, 1220.0)])) is None
