"""The reductions the ``hat.*`` per-layer metrics make of a traced window
(see :mod:`h100bench.core.trace`). HAT's two attention kernels are picked by
their symbols, ``m2t_hat_wattn`` (SW-MSA) and ``m2t_hat_oca`` (OCA); each
reader returns None where the window ran neither, so a program without them
reports nothing."""

from __future__ import annotations

from typing import Optional

from h100bench.core.trace import in_window, kind_ms

WATTN, OCA = "m2t_hat_wattn", "m2t_hat_oca"


def _ran(trace, *symbols) -> bool:
    return any(any(s in n for s in symbols)
               for n, _, _ in in_window(trace["device"], trace["window"]))


def roofline(trace, symbol: str, bound_key: str) -> Optional[float]:
    """%: the frozen bound of a unit's launches of the kernel over its
    device ms in them."""
    bound = trace.get(bound_key)
    if not bound or not _ran(trace, symbol):
        return None
    ms = kind_ms(trace, lambda n: symbol in n)
    return None if not ms else 100.0 * bound / ms


def attn_ms(trace) -> Optional[float]:
    """Device ms a unit spends in the two attention kernels."""
    if not _ran(trace, WATTN, OCA):
        return None
    return kind_ms(trace, lambda n: WATTN in n or OCA in n)


def rest_ms(trace) -> Optional[float]:
    """Device ms a unit spends outside them: cuBLAS, cuDNN, LayerNorm, GELU,
    the elementwise passes, copies and memsets."""
    if not _ran(trace, WATTN, OCA):
        return None
    return kind_ms(trace, lambda n: WATTN not in n and OCA not in n)
