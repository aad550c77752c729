"""The hand kernels' least times at the published peaks, from the work the
inputs need (not from how the kernels do it).

Peaks: one NVIDIA H100 SXM (data sheet, at its 700 W limit): 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM.

K2 traverses one bounce's rays through a mesh. What it must read and write
does not depend on the tree: each lane's bound, each live ray's origin and
direction, each lane's hit record (t, normal, u, v, triangle) and every
triangle once (corners, corner normals, corner uvs). Its operations depend
on the walk, so only the bytes bound it."""
from __future__ import annotations

from typing import Dict, Sequence

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

BYTES_F32 = 4
# K2: a lane's bound in, its hit record (t, normal 3, u, v, triangle) out;
# a live ray's origin and direction in; a triangle's corners, corner
# normals and corner uvs
K2_LANE_BYTES = (1 + 7) * BYTES_F32
K2_LIVE_BYTES = 6 * BYTES_F32
K2_TRIANGLE_BYTES = (9 + 9 + 6) * BYTES_F32


def k2_work(lanes: int, live: int, triangles: int) -> Dict[str, float]:
    """One K2 launch's bytes (its operations are not counted: 0)."""
    return dict(flops=0.0, bytes=float(lanes * K2_LANE_BYTES
                                       + live * K2_LIVE_BYTES
                                       + triangles * K2_TRIANGLE_BYTES))


def least_seconds(work: Dict[str, float]) -> tuple:
    """(seconds, "fp32" or "bytes"): the larger of the two bounds."""
    t_ops = work["flops"] / PEAK_FLOPS
    t_bytes = work["bytes"] / PEAK_BYTES
    return (t_ops, "fp32") if t_ops >= t_bytes else (t_bytes, "bytes")


def share(works: Sequence[Dict[str, float]], device_s: float) -> tuple:
    """(percent of the roofline, what bounds it): the summed least time of
    `works` over the kernels' measured device time."""
    if device_s <= 0:
        raise ValueError("no device time")
    parts = [least_seconds(w) for w in works]
    by = {b for _, b in parts}
    return (100.0 * sum(t for t, _ in parts) / device_s,
            by.pop() if len(by) == 1 else "mixed")
