"""The window's statistics, taken over every request or step of it."""

from __future__ import annotations

from typing import List, Sequence, Tuple


def rate(amounts_done: Sequence[Tuple[float, float]], start: float, end: float) -> float:
    """Work a second over the window [start, end]: the sum of the amounts
    of every (done time, amount) completed inside it, over its length."""
    return sum(a for t, a in amounts_done if start <= t <= end) / (end - start)


def union_seconds(intervals: Sequence[Tuple[float, float]], start: float,
                  end: float) -> float:
    """Length of the union of ``intervals`` (start, end) clipped to
    [start, end], in their unit."""
    return sum(b - a for a, b in merged(intervals, start, end))


def merged(intervals: Sequence[Tuple[float, float]], start: float,
           end: float) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to [start, end], as sorted
    disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, start), min(b, end)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(intervals: Sequence[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The stretches of [start, end] that no interval covers."""
    out, at = [], start
    for a, b in merged(intervals, start, end):
        if a > at:
            out.append((at, a))
        at = b
    if end > at:
        out.append((at, end))
    return out
