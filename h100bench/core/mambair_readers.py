"""The reductions the ``mambair.*`` per-layer metrics make of a traced
window (see :mod:`h100bench.core.trace`). MambaIR's scan kernel is picked by
its symbol, ``m2t_ss2d_scan``; each reader returns None where the window ran
no launch of it, so a program without it reports nothing."""

from __future__ import annotations

from typing import Optional

from h100bench.core.trace import in_window, kind_ms

SCAN = "m2t_ss2d_scan"


def _ran(trace) -> bool:
    return any(SCAN in n for n, _, _ in in_window(trace["device"], trace["window"]))


def scan_roofline(trace) -> Optional[float]:
    """%: the frozen bound of a unit's scan launches over its device ms in
    them."""
    bound = trace.get("mambair_scan_bound_ms_per_unit")
    if not bound or not _ran(trace):
        return None
    ms = kind_ms(trace, lambda n: SCAN in n)
    return None if not ms else 100.0 * bound / ms


def scan_ms(trace) -> Optional[float]:
    """Device ms a unit spends in the scan kernel."""
    if not _ran(trace):
        return None
    return kind_ms(trace, lambda n: SCAN in n)


def rest_ms(trace) -> Optional[float]:
    """Device ms a unit spends outside it: cuBLAS, cuDNN, LayerNorm, GELU,
    SiLU, the elementwise passes, copies and memsets."""
    if not _ran(trace):
        return None
    return kind_ms(trace, lambda n: SCAN not in n)
