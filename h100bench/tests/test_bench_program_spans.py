"""The readers of the program's spans and device marks on small synthetic
traces: each value, and None where its spans or marks are absent."""

import pytest

from h100bench.core import spec

SUBMIT, WAIT, COPY_OUT = "m2t::stream.submit", "m2t::stream.wait", "m2t::stream.copy_out"


def _serve(**kw):
    """Three requests at depth 1 in a window of 1000 us; the device runs
    each request's work between its submit and its wait. Each submit also
    has the profiler's device-side copy over its work (same name, from its
    first kernel's start to its copy's end), which no reader counts."""
    t = {"window": (0.0, 1000.0), "units": 3, "kind": "serve",
         "host": [("h100bench::window", 0.0, 1000.0),
                  (SUBMIT, 20.0, 118.0), (SUBMIT, 210.0, 300.0), (SUBMIT, 420.0, 500.0),
                  (SUBMIT, 10.0, 30.0), (WAIT, 30.0, 100.0), (COPY_OUT, 100.0, 160.0),
                  (SUBMIT, 200.0, 220.0), (WAIT, 220.0, 300.0), (COPY_OUT, 300.0, 380.0),
                  (SUBMIT, 400.0, 430.0), (WAIT, 430.0, 500.0), (COPY_OUT, 500.0, 700.0),
                  (SUBMIT, 1200.0, 1210.0)],  # after the window: not counted
         "device": [("k", 20.0, 100.0), ("Memcpy DtoH", 98.0, 118.0),
                    ("k", 210.0, 300.0), ("k", 420.0, 500.0)]}
    t.update(kw)
    return t


def read(name, trace):
    return spec.reader(name).read(trace)


def test_host_ms_a_request_in_each_span():
    t = _serve()
    assert read("stream.submit_host_ms.serve", t) == pytest.approx((20 + 20 + 30) / 1e3 / 3)
    assert read("stream.wait_host_ms.serve", t) == pytest.approx((70 + 80 + 70) / 1e3 / 3)
    assert read("stream.copy_out_host_ms.serve", t) == pytest.approx((60 + 80 + 200) / 1e3 / 3)


def test_idle_while_copying_out():
    # copy-outs 100-160, 300-380, 500-700; the device idles 118-210, 300-420, 500-1000
    got = read("stream.idle_in_copy_out.serve", _serve())
    assert got == pytest.approx(100.0 * (42 + 80 + 200) / 1000.0)
    assert got <= read("device_idle.serve", _serve())


def test_request_p95_pairs_the_ith_submit_with_the_ith_copy_out():
    # latencies 150, 180, 300 us; at depth 2 the copy-outs interleave with later submits
    assert read("stream.request_p95_ms.serve", _serve()) == pytest.approx(0.300)
    host = [("h100bench::window", 0.0, 1000.0), (SUBMIT, 0.0, 10.0), (SUBMIT, 10.0, 20.0),
            (COPY_OUT, 50.0, 60.0), (SUBMIT, 60.0, 70.0), (COPY_OUT, 100.0, 130.0),
            (COPY_OUT, 200.0, 220.0)]
    lat = sorted([60.0 - 0.0, 130.0 - 10.0, 220.0 - 60.0])
    got = read("stream.request_p95_ms.serve", _serve(host=host))
    assert got == pytest.approx(lat[-1] / 1e3)
    twenty = [("h100bench::window", 0.0, 10000.0)]
    for i in range(20):  # latencies 10, 20, ..., 200 us: the 19th is the p95
        twenty += [(SUBMIT, 300.0 * i, 300.0 * i + 1), (COPY_OUT, 300.0 * i + 5,
                                                         300.0 * i + 10.0 * (i + 1))]
    got = read("stream.request_p95_ms.serve", _serve(host=twenty, window=(0.0, 10000.0)))
    assert got == pytest.approx(0.190)


def _train(**kw):
    """Two steps; marks as the step's graph replays them (a kernel between
    each pair), the first step's loader spans at an epoch's start."""
    dev = []
    for k, base in enumerate((0.0, 500.0)):
        dev += [("m2t_mark_semantic_fwd_begin", base + 0, base + 1), ("gemm", base + 2, base + 12),
                ("m2t_mark_semantic_fwd_end", base + 13, base + 14), ("K1", base + 20, base + 120),
                ("m2t_mark_semantic_fwd_begin", base + 121, base + 122),
                ("gemm", base + 123, base + 143), ("Memset (Device)", base + 143, base + 145),
                ("m2t_mark_semantic_fwd_end", base + 146, base + 147),
                ("m2t_mark_semantic_bwd_begin", base + 150, base + 151),
                ("gemm_bwd", base + 152, base + 192), ("m2t_mark_semantic_bwd_end", base + 193, base + 194),
                ("K1b", base + 200, base + 400),
                ("m2t_mark_optimizer_begin", base + 401, base + 402),
                ("multi_tensor_apply_kernel(adam)", base + 403, base + 409),
                ("m2t_mark_optimizer_end", base + 410, base + 411)]
    t = {"window": (0.0, 1000.0), "units": 2, "kind": "train", "device": dev,
         "host": [("h100bench::window", 0.0, 1000.0), ("m2t::loader.epoch", 5.0, 55.0),
                  ("m2t::loader.next", 60.0, 90.0), ("m2t::loader.next", 510.0, 515.0)]}
    t.update(kw)
    return t


def test_loader_host_ms_a_step():
    assert read("loader_host_ms.train", _train()) == pytest.approx((50 + 30 + 5) / 1e3 / 2)


def test_device_ms_between_marks():
    # a step: 10 + (20 + 2) forward, 40 backward; 6 in Adam
    assert read("semantic_ms.train", _train()) == pytest.approx((10 + 22 + 40) / 1e3)
    assert read("optimizer_ms.train", _train()) == pytest.approx(6 / 1e3)
    # a pair whose begin starts before the window is left out, and its kernels
    late = _train(window=(300.0, 1000.0), units=1)
    assert read("semantic_ms.train", late) == pytest.approx(72 / 1e3)
    # an end mark the window never saw leaves its kernels out
    cut = _train()
    cut["device"] = [e for e in cut["device"] if not (e[0] == "m2t_mark_optimizer_end"
                                                       and e[1] > 500)]
    assert read("optimizer_ms.train", cut) == pytest.approx(6 / 1e3 / 2)


@pytest.mark.parametrize("name", ["stream.submit_host_ms.serve", "stream.wait_host_ms.serve",
                                  "stream.copy_out_host_ms.serve",
                                  "stream.idle_in_copy_out.serve",
                                  "stream.request_p95_ms.serve"])
def test_serve_readers_return_none_without_the_spans(name):
    """A program without the spans (the device's events and the harness's
    spans alone) reads None; so does a window with no request back."""
    bare = _serve(host=[("h100bench::window", 0.0, 1000.0),
                        ("h100bench::stream_next", 0.0, 900.0)])
    assert read(name, bare) is None
    if name.endswith("host_ms.serve"):
        assert read(name, _serve(units=0)) is None


@pytest.mark.parametrize("name", ["loader_host_ms.train", "semantic_ms.train",
                                  "optimizer_ms.train"])
def test_train_readers_return_none_without_spans_or_marks(name):
    bare = _train(host=[("h100bench::window", 0.0, 1000.0)],
                  device=[e for e in _train()["device"] if not e[0].startswith("m2t_mark_")])
    assert read(name, bare) is None
    assert read(name, _train(units=0)) is None


def test_an_l1_step_has_no_semantic_ms():
    l1 = _train()
    l1["device"] = [e for e in l1["device"] if "semantic" not in e[0]]
    assert read("semantic_ms.train", l1) is None
    assert read("optimizer_ms.train", l1) == pytest.approx(6 / 1e3)
