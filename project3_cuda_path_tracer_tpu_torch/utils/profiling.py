"""Tracing and profiling: trace capture, the program's spans and counters,
and an A/B timing harness.

Counterpart of project3_cuda_path_tracer_tpu/utils/profiling.py on
torch: `trace` records a torch.profiler trace (host ops and, on a card,
the device's kernels) and writes it as a Chrome trace with the program's
spans on its timeline, and `time_fn`/`ab_compare` time callables in wall
seconds after `sync`. For a kernel's device time alone, with the stream
held while the host enqueues, use utils/device.time_ms.

The recorder. `span(name)` times a block of the program's host work:
while recording is on it appends (name, start, end) to a bounded buffer
(`spans()`) and adds to a count and total per name (`span_totals()`);
while it is off it returns a shared no-op context after one flag check.
Recording is on while a torch profiler session is active, so spans exist
exactly when there is a device trace to lay them on, and inside
`recording()` (the CLI's `--metrics`). The times come from
`time.time_ns()`, the Unix-epoch clock on which the profiler stamps its
events, so a span lines up with the kernels and copies of its trace.

A span is never a profiler range (`record_function`, NVTX): a range is
projected onto the device's line of a trace, where a reader of the trace
takes it for a kernel. `set_counter` keeps values that a capture
measures once (a graph's node count), read by `counters()`.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Tuple

import torch

SPAN_CAPACITY = 1 << 16   # spans the buffer keeps, the newest
_SPANS: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_TOTALS: Dict[str, List[int]] = {}   # name -> [count, total ns]
_COUNTERS: Dict[str, float] = {}
_FORCED = 0                          # open `recording()` blocks
# guards _TOTALS and _FORCED: the preview steps on a thread of its own
_LOCK = threading.Lock()
_profiler_on = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _SPANS.append((self.name, self.t0, t1))
        with _LOCK:
            tot = _TOTALS.setdefault(self.name, [0, 0])
            tot[0] += 1
            tot[1] += t1 - self.t0
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the block as the span `name` while recording
    is on (module docstring); else a shared no-op context."""
    if _FORCED or _profiler_on():
        return _Span(name)
    return _OFF


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    global _FORCED
    with _LOCK:
        _FORCED += 1
    try:
        yield
    finally:
        with _LOCK:
            _FORCED -= 1


def spans() -> List[Tuple[str, float, float]]:
    """The recorded spans, oldest first: (name, start_s, end_s) in
    Unix-epoch seconds, the profiler's clock."""
    return [(n, a * 1e-9, b * 1e-9) for n, a, b in list(_SPANS)]


def span_totals() -> Dict[str, Tuple[int, float]]:
    """name -> (count, total seconds) of every span recorded."""
    with _LOCK:
        return {n: (c, t * 1e-9) for n, (c, t) in _TOTALS.items()}


def set_counter(name: str, value: float) -> None:
    """Keep `value` under `name`, whether or not spans are recording."""
    _COUNTERS[name] = value


def counters() -> Dict[str, float]:
    """The counters set so far, by name."""
    return dict(_COUNTERS)


def clear() -> None:
    """Empty the recorder: spans, totals and counters."""
    _SPANS.clear()
    with _LOCK:
        _TOTALS.clear()
    _COUNTERS.clear()


def _tensors(out):
    """The tensors in a nest of tuples, lists and dicts."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)


def sync(out) -> None:
    """Wait until the work that produced `out` is done: a synchronise of
    each card that holds one of its tensors. On the CPU an op returns once
    its result exists, so there is nothing to wait for."""
    devices = {t.device for t in _tensors(out) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


TRACE_FILE = "trace.json"
SPAN_TRACK = "program spans"   # the spans' thread in the Chrome trace


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block under torch.profiler (host ops, and the card's
    kernels when one is present) and write `<log_dir>/trace.json`, a Chrome
    trace (chrome://tracing, Perfetto) that also holds the program's spans
    of the block, as complete events of the thread SPAN_TRACK on the
    trace's timeline. Yields the profiler, whose `key_averages()` sums the
    time by op and kernel."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    t0 = time.time_ns()
    with profile(activities=acts) as prof:
        yield prof
    t1 = time.time_ns()
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # a trace's "ts" are microseconds after its baseTimeNanoseconds
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    doc.setdefault("traceEvents", []).extend(
        dict(ph="X", cat="program_span", name=n, pid=pid, tid=SPAN_TRACK,
             ts=(a - base) / 1e3, dur=(b - a) / 1e3)
        for n, a, b in list(_SPANS) if a >= t0 and b <= t1)
    with open(path, "w") as f:
        json.dump(doc, f)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1,
            **kwargs) -> float:
    """Wall seconds a call of `fn(*args, **kwargs)`, each call waited for
    (`sync` on its result), after `warmup` untimed calls."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
        sync(out)
    return (time.perf_counter() - t0) / iters


def ab_compare(variants: Dict[str, Callable],
               iters: int = 10) -> Dict[str, float]:
    """Seconds a call of each named thunk (`time_fn`)."""
    return {name: time_fn(fn, iters=iters) for name, fn in variants.items()}
