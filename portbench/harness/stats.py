"""The window's arithmetic."""
from __future__ import annotations

import statistics
from typing import Sequence, Tuple


def rate(units: int, work_per_unit: float, start: float, last_end: float
         ) -> float:
    """All the work the window completed over the time until the last unit
    ended: a stall anywhere in the window lowers it."""
    if units <= 0 or last_end <= start:
        raise ValueError("the window completed no unit")
    return units * work_per_unit / (last_end - start)


def spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, by
    statistics.quantiles(values, n=4)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_seconds(intervals: Sequence[Tuple[float, float]], lo: float,
                  hi: float) -> float:
    """The length of the union of intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> list:
    """The idle gaps [(start, end)] inside [lo, hi] between the union of
    the intervals."""
    out, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
