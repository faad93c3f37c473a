"""The reductions the per-layer metrics of ``h100bench/metrics/`` make of a
traced window (see :mod:`h100bench.core.trace` for the trace's layout). A
metric's file picks one; each returns None where the trace holds nothing
for it to read, never 0 for a share of a roofline or a peak."""

from __future__ import annotations

from typing import Optional

from h100bench.core.card import K1, K1B, is_copy, is_memset, kernel_kind
from h100bench.core.counts import BF16_FLOP_PER_S
from h100bench.core.stats import union_seconds
from h100bench.core.trace import in_window, kind_ms


def copy_ms(trace) -> Optional[float]:
    """Device ms a unit spends in copies (host to device and back)."""
    return kind_ms(trace, is_copy)


def glue_ms(trace) -> Optional[float]:
    """Device ms a unit spends in kernels of kind "other" by the frozen
    name table, copies and memsets left out."""
    return kind_ms(trace, lambda n: kernel_kind(n) == "other"
                   and not is_copy(n) and not is_memset(n))


def other_ms(trace) -> Optional[float]:
    """Device ms a unit spends outside the port's kernels (K1, K1b, K2, K2b,
    K3, the reductions), copies included."""
    return kind_ms(trace, lambda n: kernel_kind(n) == "other")


def k1_roofline(trace) -> Optional[float]:
    """%: the frozen bound of a unit's K1 launches over its device ms in
    K1's kernels."""
    bound = trace.get("k1_bound_ms_per_unit")
    ms = kind_ms(trace, lambda n: kernel_kind(n) in K1)
    return None if not bound or not ms else 100.0 * bound / ms


def k1b_roofline(trace) -> Optional[float]:
    """%: the frozen bound of a step's K1b launch groups over its device ms
    in K1b's kernels and the tree reductions (the reduction kernel is
    shared with K2b's, which it counts too)."""
    bound = trace.get("k1b_bound_ms_per_unit")
    ms = kind_ms(trace, lambda n: kernel_kind(n) in K1B + ("reduce",))
    return None if not bound or not ms else 100.0 * bound / ms


def device_idle(trace) -> Optional[float]:
    """%: the share of the window in which no kernel, copy or memset runs
    (the union of the device's intervals)."""
    a, b = trace["window"]
    if b <= a:
        return None
    busy = union_seconds([(s, e) for _, s, e in trace["device"]], a, b)
    return 100.0 * (1.0 - busy / (b - a))


def mfu(trace) -> Optional[float]:
    """%: the frozen operations a unit times the units of the window, over
    the window's seconds times the bf16 peak."""
    if not trace.get("units") or not trace.get("flops_per_unit"):
        return None
    a, b = trace["window"]
    return 100.0 * trace["flops_per_unit"] * trace["units"] / ((b - a) / 1e6 * BF16_FLOP_PER_S)


def step_host_ms(trace) -> Optional[float]:
    """Host ms a unit in the program's ``m2t::augment`` spans, less the
    ``m2t::wait`` spans inside them."""
    if not trace.get("units"):
        return None
    spans = in_window(trace["host"], trace["window"])
    augment = [(s, e) for n, s, e in spans if n == "m2t::augment"]
    if not augment:
        return None
    waits = [(s, e) for n, s, e in spans if n == "m2t::wait"]
    busy = sum(e - s for s, e in augment)
    busy -= sum(we - ws for ws, we in waits if any(s <= ws and we <= e for s, e in augment))
    return busy / 1e3 / trace["units"]
