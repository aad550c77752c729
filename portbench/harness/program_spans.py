"""The program's own spans and counters, from its recorder
(project3_cuda_path_tracer_tpu_torch/utils/profiling.py), for the
per-layer readers.

The program records a span only while a profiler session is active, so
the spans on hand are those of the traced sub-window's attempts; a reader
keeps the ones that lie inside `rec["window"]`, the last attempt's, whose
kernels and copies are in `rec`. Both lie on one clock (Unix-epoch
seconds). Where the program has no recorder, or recorded nothing of the
kind (the CPU, the megakernel route), a reader returns None."""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from .stats import gaps


def _recorder():
    try:
        from project3_cuda_path_tracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("spans", "counters")):
        return None
    return profiling


def counter(name: str) -> Optional[float]:
    """The program's counter `name`, or None."""
    p = _recorder()
    v = None if p is None else p.counters().get(name)
    return None if v is None else float(v)


def spans(rec: dict, name: str) -> List[Tuple[float, float]]:
    """(start_s, end_s) of the program's spans `name` inside the
    sub-window."""
    p = _recorder()
    lo, hi = rec["window"]
    return [(s, e) for n, s, e in ([] if p is None else p.spans())
            if n == name and lo <= s and e <= hi]


def mean_ms(xs: List[Tuple[float, float]]) -> Optional[float]:
    """The mean length of the spans in ms, or None for none."""
    return 1e3 * sum(e - s for s, e in xs) / len(xs) if xs else None


def idle_inside(rec: dict, xs: List[Tuple[float, float]]) -> float:
    """Seconds of the sub-window's device idle (the gaps between its
    kernels, copies and fills) that lie inside the spans `xs`."""
    lo, hi = rec["window"]
    ops = [(s, e) for _, s, e in rec["kernels"] + rec["copies"]]
    idle = gaps(ops, lo, hi)   # sorted and disjoint
    starts = [g[0] for g in idle]
    total = 0.0
    for s, e in xs:
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(idle) and idle[i][0] < e:
            total += max(0.0, min(e, idle[i][1]) - max(s, idle[i][0]))
            i += 1
    return total


def idle_ms_per(rec: dict, name: str, per: str) -> Optional[float]:
    """Device-idle ms inside the spans `name`, per `rec[per]` (the
    sub-window's iterations or steps); None without such spans."""
    xs, n = spans(rec, name), rec.get(per)
    if not xs or not n:
        return None
    return 1e3 * idle_inside(rec, xs) / n
