"""The metric arithmetic on synthetic traces and windows."""

import math

import pytest

from h100bench.core import counts, spec, stats, trace as tr
from h100bench.core.card import kernel_kind


def _trace(**kw):
    t = {"window": (0.0, 1000.0), "units": 4, "host": [], "device": [
        ("cftm_branch_c256_kernel", 0.0, 100.0),
        ("cftm_branch_w16_kernel", 50.0, 150.0),      # overlaps the first
        ("Memcpy HtoD (Pinned -> Device)", 300.0, 340.0),
        ("void at::native::reduce_kernel<...>", 400.0, 500.0),
        ("ff_conv_kernel<4>", 990.0, 1100.0),         # runs past the window
        ("tail_band_kernel<64>", 1200.0, 1300.0),     # after the window
    ]}
    t.update(kw)
    return t


def test_union_of_intervals_and_idle_share():
    assert stats.union_seconds([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert stats.merged([(5, 6), (0, 2), (1, 3)], 0, 10) == [(0, 3), (5, 6)]
    assert stats.gaps([(0, 2), (1, 3), (5, 6)], 0, 10) == [(3, 5), (6, 10)]
    idle = spec.reader("device_idle.serve").read(_trace(kind="serve"))
    busy = 150 + 40 + 100 + 10  # the overlap once, the window's part of ff_conv
    assert idle == pytest.approx(100.0 * (1 - busy / 1000.0))
    assert spec.reader("device_idle.serve").read(_trace(window=(5.0, 5.0))) is None


def test_rate_takes_every_request_of_the_window():
    done = [(0.5, 1.0), (1.0, 2.0), (2.5, 4.0)]  # (time back, MP)
    assert stats.rate(done, 0.0, 2.0) == pytest.approx(1.5)
    assert stats.rate(done + [(2.0, 8.0)], 0.0, 2.0) == pytest.approx(5.5)  # at the close
    assert stats.rate(done + [(-0.1, 8.0)], 0.0, 2.0) == pytest.approx(1.5)  # before it


def test_per_request_device_ms_by_kind():
    t = _trace(kind="serve")
    copy = spec.reader("stream.copy_ms.serve").read(t)
    assert copy == pytest.approx(40.0 / 1e3 / 4)
    glue = spec.reader("glue_ms.serve").read(t)
    assert glue == pytest.approx(100.0 / 1e3 / 4)  # the reduce kernel; copies are not glue
    assert kernel_kind("m2t_cftm_bwd::cftm_bwd_attn_win_kernel<16>(args)") == "K1b win16"
    assert tr.kind_ms(_trace(units=0), lambda n: True) is None


def test_roofline_share_and_mfu():
    t = _trace(kind="serve", k1_bound_ms_per_unit=0.01, flops_per_unit=1e9)
    k1_ms = (100.0 + 100.0) / 1e3 / 4
    got = spec.reader("cftm_branch_roofline.serve").read(t)
    assert got == pytest.approx(100.0 * 0.01 / k1_ms)
    mfu = spec.reader("mfu.serve").read(t)
    assert mfu == pytest.approx(100.0 * 1e9 * 4 / (1e-3 * counts.BF16_FLOP_PER_S))
    assert spec.reader("cftm_branch_roofline.serve").read(_trace(
        kind="serve", device=[], k1_bound_ms_per_unit=0.01)) is None  # nothing to read


def test_host_ms_of_a_step_leaves_out_its_waits():
    host = [("m2t::augment", 0.0, 400.0), ("m2t::wait", 100.0, 300.0),
            ("m2t::wait", 500.0, 600.0),  # outside augment: the batch's own staging
            ("m2t::augment", 700.0, 800.0)]
    t = _trace(kind="train", host=host, units=2)
    assert spec.reader("step_host_ms.train").read(t) == pytest.approx((400 - 200 + 100) / 1e3 / 2)


def test_breakdown_names_the_host_span_over_each_gap():
    host = [("h100bench::window", 0.0, 1000.0), ("h100bench::stream_next", 500.0, 990.0)]
    got = tr.device_summary(_trace(host=host))
    assert got["window_s"] == pytest.approx(1e-3)
    assert got["busy_s"] == pytest.approx(300e-6)
    gaps = got["breakdown"]["idle_gaps"]
    assert gaps[0] == ["h100bench::stream_next", pytest.approx(490e-6)]
    assert len(got["breakdown"]["device_ops"]) <= 10


def test_frozen_counts():
    model = {"scale": 4, "rgb_range": 1.0, "colors": 3, "n_feats": 64, "n_blocks": 8}
    # the port's FlopCounterMode count of this forward is 108.52 G (PERF.md)
    assert counts.forward_flops(model, 8, 96, 96) == pytest.approx(108.518178816e9)
    assert counts.k1b_bound_ms(model, 2, 96, 96) > counts.k1_bound_ms(model, 2, 96, 96)
    assert counts.padded(100) == 128 and math.isclose(counts.bound_ms(3.35e9, 0.0), 1.0)
