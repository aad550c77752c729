"""The traced sub-window: a few units of the window's own work under
torch.profiler, read into plain records.

Records: `kernels` [(name, start_s, end_s)] of every device kernel, `copies`
the same for device copies and fills, `spans` [(name, start_s, end_s)] of the
benchmark's host spans ("pb:<name>", recorded with record_function), and
`window` (start_s, end_s), the host span around the whole sub-window, all on
the profiler's one clock. The profiler has been seen to drop records, so
the sub-window is profiled again (up to three times) until every kernel
name shows a whole multiple of the repeats run (a frame's iterations, a
call's steps): each repeat runs the same kernels, so a dropped record
breaks that count."""
from __future__ import annotations

import collections
import re
from typing import Callable, Dict, List, Tuple

import torch

# the program's hand-written kernels, by their names in the trace
HAND_KERNELS = {
    "k1": r"(?<!\w)megakernel(?!\w)",
    "k2": r"(?<!\w)traverse8_kernel(?!\w)",
    "k3_k4": r"(?<!\w)binary_kernel(?!\w)",
    "p1": r"(?<!\w)gather_kernel(?!\w)",
    "p2": r"(?<!\w)(extract_cost|chase|fold_chain|shfl_chain)_kernel(?!\w)",
}
SPAN_PREFIX = "pb:"


def hand_kernel(name: str) -> str:
    """The hand-written kernel `name` is, or ""."""
    for tag, rx in HAND_KERNELS.items():
        if re.search(rx, name):
            return tag
    return ""


def _ns(ev, what: str) -> float:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, what + "_us")()) * 1e3


def _read(prof) -> dict:
    kernels, copies, spans = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, "start") * 1e-9
        end = start + _ns(ev, "duration") * 1e-9
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith(SPAN_PREFIX):
                continue   # a host span's projection on the device's line
            if name.startswith(("Memcpy", "Memset")):
                copies.append((name, start, end))
            else:
                kernels.append((name, start, end))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], start, end))
    window = [s for s in spans if s[0] == "subwindow"]
    if not window:
        raise RuntimeError("the profiler recorded no sub-window span")
    return dict(kernels=kernels, copies=copies, spans=spans,
                window=(window[0][1], window[0][2]))


def whole(records: dict, repeats: int) -> bool:
    """Whether every kernel name counts a whole multiple of `repeats`."""
    counts = collections.Counter(k[0] for k in records["kernels"])
    return bool(counts) and all(c % repeats == 0 for c in counts.values())


def profile(unit: Callable[[], None], units: int, repeats_per_unit: int,
            cuda: bool = True, tries: int = 3) -> dict:
    """`units` calls of `unit`, each `repeats_per_unit` repeats of the same
    kernels, under the profiler, read (see the module's docstring);
    `complete` says whether the kernel counts came out whole. `cuda` False
    records the host alone (the CPU tests)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for attempt in range(tries):
        sync()
        with tprofile(activities=acts) as prof:
            with record_function(SPAN_PREFIX + "subwindow"):
                for _ in range(units):
                    unit()
                sync()
        rec = _read(prof)
        rec["units"], rec["attempts"] = units, attempt + 1
        rec["complete"] = whole(rec, units * repeats_per_unit)
        if rec["complete"]:
            break
    return rec


def device_seconds(records: dict, keep: Callable[[str], bool]) -> float:
    """Summed device time of the kernels whose name `keep` accepts."""
    return sum(e - s for n, s, e in records["kernels"] if keep(n))


def torch_kernel_ms(records: dict, per: str):
    """Device milliseconds of every kernel that is not a hand-written one,
    per `records[per]` (the sub-window's iterations or steps); None where
    there is nothing to read."""
    n = records.get(per)
    if not n:
        return None
    s = device_seconds(records, lambda name: not hand_kernel(name))
    return 1e3 * s / n if s > 0 else None


def busy_pct(records: dict):
    """The share of the sub-window in which some operation ran on the
    device, in percent; None where the trace holds none."""
    b, window = busy(records)
    return 100.0 * b / window if window > 0 and b > 0 else None


NAME_CHARS = 160   # a kernel's name in the breakdown, cut to this


def top_ops(records: dict, k: int = 10) -> List[Tuple[str, float]]:
    """The device operations that took the most time, by name (cut to
    NAME_CHARS)."""
    tot: Dict[str, float] = collections.defaultdict(float)
    for n, s, e in records["kernels"] + records["copies"]:
        tot[n[:NAME_CHARS]] += e - s
    return sorted(tot.items(), key=lambda kv: -kv[1])[:k]


def idle_gaps(records: dict, k: int = 10) -> List[Tuple[str, float]]:
    """The longest idle gaps of the device in the sub-window, each named by
    the innermost benchmark span the host was in when it began."""
    from .stats import gaps
    lo, hi = records["window"]
    ops = [(s, e) for _, s, e in records["kernels"] + records["copies"]]
    named = []
    inner = [sp for sp in records["spans"] if sp[0] != "subwindow"]
    for s, e in gaps(ops, lo, hi):
        host = [sp for sp in inner if sp[1] <= s < sp[2]]
        label = min(host, key=lambda sp: sp[2] - sp[1])[0] if host \
            else "between spans"
        named.append((label, e - s))
    return sorted(named, key=lambda kv: -kv[1])[:k]


def busy(records: dict) -> Tuple[float, float]:
    """(busy_s, window_s): the union of the device's operations inside the
    sub-window, and the sub-window's length."""
    from .stats import union_seconds
    lo, hi = records["window"]
    ops = [(s, e) for _, s, e in records["kernels"] + records["copies"]]
    return union_seconds(ops, lo, hi), hi - lo
