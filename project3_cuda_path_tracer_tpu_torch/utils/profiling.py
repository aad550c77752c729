"""Tracing and profiling: trace capture, named spans and an A/B timing
harness.

Counterpart of project3_cuda_path_tracer_tpu/utils/profiling.py on
torch: `trace` records a torch.profiler trace (host ops and, on a card,
the device's kernels) and writes it as a Chrome trace, `named` marks a span
in it, and `time_fn`/`ab_compare` time callables in wall seconds after
`sync`. For a kernel's device time alone, with the stream held while the
host enqueues, use utils/device.time_ms.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch


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


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block under torch.profiler (host ops, and the card's
    kernels when one is present) and write `<log_dir>/trace.json`, a Chrome
    trace (chrome://tracing, Perfetto). Yields the profiler, whose
    `key_averages()` sums the time by op and kernel."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def named(name: str):
    """A named span of the trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


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
