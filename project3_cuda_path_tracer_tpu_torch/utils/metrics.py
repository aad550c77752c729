"""Metrics / observability (SURVEY §5.5): rays/s, live-path histograms,
compaction ratios, emitted as JSON lines. The reference's only observability
is an iteration counter in the window title (src/preview.cpp:176-177)."""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import Optional, TextIO


@dataclass
class RenderMetrics:
    """Accumulates per-iteration throughput statistics."""
    width: int
    height: int
    trace_depth: int
    out: TextIO = field(default_factory=lambda: sys.stderr)
    _t0: Optional[float] = None
    _iters: int = 0
    _wall: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, iters: int = 1) -> None:
        assert self._t0 is not None
        self._wall += time.perf_counter() - self._t0
        self._iters += iters
        self._t0 = None

    @property
    def rays_per_second(self) -> float:
        """Upper-bound path-segments/s: W*H*depth per iteration (the
        wavefront is fixed-capacity; dead lanes still occupy compute)."""
        if self._wall == 0:
            return 0.0
        return self._iters * self.width * self.height * self.trace_depth / self._wall

    @property
    def iters_per_second(self) -> float:
        return self._iters / self._wall if self._wall else 0.0

    def emit(self, **extra) -> dict:
        rec = dict(
            iters=self._iters, wall_s=round(self._wall, 4),
            rays_per_s=round(self.rays_per_second, 1),
            iters_per_s=round(self.iters_per_second, 3),
            resolution=[self.width, self.height],
            trace_depth=self.trace_depth, **extra)
        print(json.dumps(rec), file=self.out, flush=True)
        return rec
