"""The launch counts of the hand-written kernels, kept in one place: K1
(`ops/megakernel.py`), K2 (`ops/bvh8.py`), K3 and K4
(`ops/pallas_bvh.py`), P1 (`ops/texfetch.py`), G1, the material gather's
backward (`ops/matgrad.py`), and I1, the analytic primitives' nearest hit
(`ops/primhit.py`).

Two kinds. Each wrapper calls `count(key)` where it enqueues a launch
(`launch_counts`). Under a CUDA graph's capture that happens once, without
the kernel running, and a replay runs the captured launches with no
wrapper call: a captured graph keeps the counters' increase over its
capture as its launches a replay (`utils.device.CapturedGraph.launches`).
And the kernels of the wavefront route (K2, K3/K4, P1, I1) add one to a tally
in device memory from their first thread, each time they run, eagerly or
in a replay (`device_launches`), and so does G1 once a call (its pair of
passes) in the train step's backward."""
from __future__ import annotations

from typing import Dict

import torch

_COUNTS: Dict[str, int] = dict.fromkeys(
    ("k1", "k1_grid", "k2", "k2_any_hit", "k2_other", "k3_k4", "k4", "p1",
     "p1_ab", "mat_grad", "prim"), 0)


def count(key: str) -> None:
    """One launch more under `key`, one of `launch_counts`' keys (another
    raises KeyError)."""
    _COUNTS[key] += 1


def launch_counts() -> Dict[str, int]:
    """A copy of the counters: `k1` (both schedules), `k1_grid` (those of
    `k1` in the grid schedule), `k2` (the persistent instance, the
    renderer's), `k2_any_hit` (those of `k2` in occlusion mode), `k2_other`
    (K2's grid and tiny-stack instances), `k3_k4` (K3 and K4), `k4` (those
    of `k3_k4` that are K4), `p1` (the texel gather), `p1_ab` (its entry
    for the bitwise checks, `_gather_instance`), `mat_grad` (G1, a call of
    its two passes), `prim` (I1)."""
    return dict(_COUNTS)


# the device tallies' slots, each the launches of what `launch_counts`
# counts under the same key
TALLY_SLOTS = ("k2", "k2_any_hit", "k3_k4", "p1", "mat_grad", "prim")
_TALLIES: Dict[int, torch.Tensor] = {}  # device index -> int64 [slots]


def device_tally(device: torch.device) -> torch.Tensor:
    """The card's tally, an int64 tensor with one slot of TALLY_SLOTS each,
    made at the first launch on the card (`capture_graph` makes it before
    a capture, so it lives outside the graph's pool)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _TALLIES:
        _TALLIES[idx] = torch.zeros(len(TALLY_SLOTS), dtype=torch.int64,
                                    device=torch.device("cuda", idx))
    return _TALLIES[idx]


def tally_address(device: torch.device, slot: str) -> int:
    """The device address of the tally's `slot` (K2's any-hit slot follows
    its `k2` slot: the kernel is given `k2`'s)."""
    tally = device_tally(device)
    return tally.data_ptr() + tally.element_size() * TALLY_SLOTS.index(slot)


def device_launches() -> Dict[str, int]:
    """The launches that ran on the cards since the tallies were zeroed, by
    slot (reads device memory: waits for the queued work)."""
    out = dict.fromkeys(TALLY_SLOTS, 0)
    for tally in _TALLIES.values():
        for slot, v in zip(TALLY_SLOTS, tally.tolist()):
            out[slot] += v
    return out


def zero_launch_counts() -> None:
    """Every counter and tally to 0."""
    for key in _COUNTS:
        _COUNTS[key] = 0
    for tally in _TALLIES.values():
        tally.zero_()
