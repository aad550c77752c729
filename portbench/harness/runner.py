"""One run of one cell: set-up, the measured window, the traced sub-window
(with --trace 1), the check against the reference, and the result line.

The window runs whole units (frames or train calls) until `--seconds` have
passed since its start. A rate is all the work of all the units over the
time until the last one ended. Set-up is the time from process start to
the window's start: the native build where it is absent, the scene load
and one warm unit, whose first eager step builds the kernel libraries the
cell uses where they are absent (a checkout's first run compiles them)."""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from . import checks as C
from . import guard, profiling, stats
from .spec import ROOT, Cell, load_cell

GIB = float(1 << 30)


class Ctx:
    """What a mix is given: the cell, the run's seed, the device, and the
    benchmark's host spans (named seconds in set-up; per-unit lists in the
    window)."""

    def __init__(self, cell: Cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.spans: Dict[str, float] = {}
        self.unit_spans: Dict[str, List[float]] = {}
        self.phase = "setup"     # then "window", then "after"

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span: named in the profiler's trace (record_function) and
        timed on the host clock; inside the window, kept per unit."""
        from torch.profiler import record_function
        t = time.perf_counter()
        with record_function(profiling.SPAN_PREFIX + name):
            yield
        dt = time.perf_counter() - t
        if self.phase == "window":
            self.unit_spans.setdefault(name, []).append(dt)
        elif self.phase == "setup":
            self.spans[name] = self.spans.get(name, 0.0) + dt


def ensure_native(ctx: Ctx) -> None:
    """The program's native host library (OBJ parser, SAH builder), built
    with its own Makefile inside the checkout where it is absent; without a
    compiler the program's Python builder serves, and the run says so."""
    lib = os.path.join(ROOT, "native", "build", "libpt_native.so")
    if os.path.exists(lib) or not os.path.exists(os.path.join(
            ROOT, "native", "Makefile")):
        return
    with ctx.span("native_build"):
        proc = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        print("native build failed; the Python builder serves:\n"
              + proc.stdout[-2000:] + proc.stderr[-2000:], file=sys.stderr)


def _args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def end_to_end(mix, units, w0: float, setup_s: float, peak: int) -> dict:
    return {mix.rate_metric: stats.rate(len(units), mix.work_per_unit, w0,
                                        units[-1][1]),
            "peak_mem_gib": peak / GIB, "setup_s": setup_s}


def per_layer(cell: Cell, records: dict) -> dict:
    out = {}
    for name, read in cell.readers().items():
        v = read(records)
        if v is not None:
            out[name] = v
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """The run's result (the dict printed as the last line), without the
    card checks: the tests drive it on the CPU with a small cell."""
    import torch
    ctx = Ctx(cell, seed, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        ensure_native(ctx)
    mix = cell.mix_module().Mix(ctx)
    mix.setup()
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    units = []
    ctx.phase = "window"
    while True:
        s = time.perf_counter()
        mix.unit()
        e = time.perf_counter()
        units.append((s, e))
        if e - w0 >= seconds:
            break
    ctx.phase = "after"
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else 0
    records: Optional[dict] = None
    if trace:
        records = profiling.profile(mix.unit, int(cell.settings[
            "trace_units"]), mix.repeats_per_unit,
            cuda=device.type == "cuda")
    mix.finish()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = C.judged(mix.check(), cell.settings["limits"])
    ok = C.correct(checks)
    e2e = end_to_end(mix, units, w0, setup_s, peak)
    want = [m["name"] for m in cell.end_to_end]
    missing = set(want) - set(e2e)
    if missing:
        raise KeyError(f"the mix reports no {sorted(missing)}")
    units_e2e = {m["name"]: m["unit"] for m in cell.end_to_end}
    result = dict(correct=ok, attempted=len(units),
                  failed=0 if ok else len(units))
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=cell.chips, memory_peak_bytes=int(peak))
    if trace:
        rec = dict(records, **mix.layer_records(records))
        rec["unit_spans"] = ctx.unit_spans
        rec["setup_spans"] = ctx.spans
        units_l = {m["name"]: m["unit"] for m in cell.per_layer}
        metrics = {}
        for k, v in per_layer(cell, rec).items():
            metrics[k] = (dict(value=v[0], unit=units_l[k], bound_by=v[1])
                          if isinstance(v, tuple)
                          else dict(value=v, unit=units_l[k]))
        dev["busy_s"], dev["window_s"] = profiling.busy(records)
        result.update(metrics=metrics, device=dev, breakdown=dict(
            device_ops=[[n, s] for n, s in profiling.top_ops(records)],
            idle_gaps=[[n, s] for n, s in profiling.idle_gaps(records)]),
            profile=dict(complete=records["complete"],
                         attempts=records["attempts"]))
    else:
        result.update(metrics={k: dict(value=e2e[k], unit=units_e2e[k])
                               for k in want}, device=dev)
    result["setup_parts_s"] = dict(ctx.spans)
    result["checks"] = checks
    return result


def main(argv, t_start: float) -> int:
    a = _args(argv)
    try:
        cell = load_cell(a.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell {a.workload} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    try:
        result = run(cell, a.seed, a.seconds, bool(a.trace),
                     torch.device("cuda", 0), t_start)
    except ImportError as e:
        print(f"portbench: the program cannot be imported: {e}",
              file=sys.stderr)
        return 1
    bad = guard.loaded()
    if bad:
        print("portbench: the process holds forbidden modules: "
              + ", ".join(bad), file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
