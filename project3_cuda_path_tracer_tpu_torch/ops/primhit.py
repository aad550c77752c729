"""The nearest hit of a wavefront against a run of analytic primitives (I1).

`nearest(o, d, times, geoms, run, t_init, best, tangents)` merges the
CUBE/SPHERE geoms of `run` ((geom, type) pairs, in geom order) into the hit
record `best`, or into the miss record at `t_init` (BIG where None), as
`ops/wavefront.intersect_planar` does for each run of primitives between
SDF geoms. It owns the route, read from the inputs themselves (`takes`): the
kernel csrc/prim_hit.cu, one launch a run, each lane's best record in
registers and every output plane written once, has no backward, so it
takes CUDA tensors none of which takes a gradient while autograd records
(a render, a shadow query under no_grad). Everything else (the CPU, the
train step's camera rays) goes through the plain version,
`wavefront.primitive_run_plain`: the torch chain (`_primitive_hit_planar`
and the strict `<` merge) that the kernel repeats bit for bit on the
card.

The kernel library is built at the first call on a card. Each launch counts
under `prim` and, from the device, adds one to the `prim` slot of
utils/launches.py's tally.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ..scene import types as T
from ..utils import cuda_build
from ..utils.launches import count, tally_address
from .vec import V3

# csrc/prim_hit.cu's output rows; the last three only with tangents
ROWS = ("t", "nx", "ny", "nz", "px", "py", "pz", "sx", "sy", "sz", "u", "v",
        "tx", "ty", "tz")
TANGENT_ROWS = 3
BIG = 1e30
# the kernel's device: `takes` leaves tensors elsewhere to the plain chain
DEVICE = "cuda"


def takes(o: V3, d: V3, times: torch.Tensor, t_init: Optional[torch.Tensor],
          best, geoms: T.Geoms) -> bool:
    """Whether the kernel runs the primitive test of these inputs: CUDA
    tensors, none of which (the rays, the bound `t_init`, the incoming
    record `best` and the geoms' transforms and velocity) takes a gradient
    while autograd records."""
    if o.x.device.type != DEVICE:
        return False
    if not torch.is_grad_enabled():
        return True
    ins = [*o, *d, times, t_init, geoms.transform, geoms.inverse_transform,
           geoms.inverse_transpose, geoms.velocity]
    if best is not None:
        ins += [x for f in best if f is not None
                for x in (f if isinstance(f, tuple) else (f,))]
    return not any(t is not None and t.requires_grad for t in ins)


def nearest(o: V3, d: V3, times: torch.Tensor, geoms: T.Geoms,
            run: Sequence[Tuple[int, int]],
            t_init: Optional[torch.Tensor] = None, best=None,
            tangents: bool = False):
    """`best` (None: the miss record at `t_init`, BIG where that is None)
    merged with the (geom, type) pairs of `run` in order: the kernel where
    it `takes` the inputs, else the plain chain."""
    from . import wavefront as W
    if not run:
        raise ValueError("an empty run of primitives")
    if any(gtype not in (T.CUBE, T.SPHERE) for _, gtype in run):
        raise ValueError(f"a run holds CUBE and SPHERE geoms only: {run}")
    if takes(o, d, times, t_init, best, geoms):
        return _nearest_kernel(o, d, times, geoms, tuple(run), t_init, best,
                               tangents)
    if best is None:
        best = W.init_hit(o.x.shape[0], o.x.device, t_init, tangents)
    return W.primitive_run_plain(o, d, times, geoms, run, best, tangents)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load("prim_hit")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.prim_hit_launch.restype = i32
    lib.prim_hit_launch.argtypes = [
        i64, ctypes.POINTER(ptr), ctypes.POINTER(i64), ptr,
        ctypes.POINTER(ptr), ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr,
        i32, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.prim_hit_rows.restype = i32
    lib.prim_hit_rows.argtypes = []
    lib.prim_hit_error_string.restype = ctypes.c_char_p
    lib.prim_hit_error_string.argtypes = [i32]
    if lib.prim_hit_rows() != len(ROWS):
        raise RuntimeError("csrc/prim_hit.cu's ROWS is not "
                           f"ops/primhit.ROWS ({len(ROWS)})")
    return lib


def _plane(t: torch.Tensor, n: int, dev: torch.device, what: str,
           dtype=torch.float32) -> torch.Tensor:
    if t.dtype != dtype or t.device != dev or t.shape != (n,):
        raise ValueError(f"{what} must be a {dtype} [{n}] plane on {dev}, "
                         f"not {t.dtype} {tuple(t.shape)} on {t.device}")
    return t


def _nearest_kernel(o: V3, d: V3, times: torch.Tensor, geoms: T.Geoms,
                    run: tuple, t_init: Optional[torch.Tensor], best,
                    tangents: bool):
    """csrc/prim_hit.cu on the current stream: checks, outputs by
    torch.empty, no sync. The ray planes go by their strides (an origin
    broadcast from the camera has stride 0); the geom tables and an
    incoming record are made contiguous (a no-op for the renderer's)."""
    from .wavefront import HitP, _index_tensor
    dev = o.x.device
    n = o.x.shape[0]
    rays = [_plane(r, n, dev, name).detach() for r, name in zip(
        (*o, *d, times), ("ox", "oy", "oz", "dx", "dy", "dz", "times"))]
    tables = [t.detach().contiguous() for t in (
        geoms.inverse_transform, geoms.transform, geoms.inverse_transpose)]
    for t in tables:
        if t.dtype != torch.float32 or t.device != dev or t.shape[1:] != (
                4, 4):
            raise ValueError("the geom transforms must be float32 "
                             f"[G,4,4] on {dev}")
    vel = geoms.velocity.detach().contiguous()
    if vel.dtype != torch.float32 or vel.device != dev:
        raise ValueError(f"the geom velocities must be float32 on {dev}")
    mat = geoms.material_id.to(device=dev, dtype=torch.int32).contiguous()
    g_count = tables[0].shape[0]
    if any(not 0 <= g < g_count for g, _ in run):
        raise ValueError(f"run {run} indexes past the {g_count} geoms")
    if t_init is not None:
        t_init = _plane(t_init, n, dev, "t_init").detach().contiguous()
    rows = len(ROWS) - (0 if tangents else TANGENT_ROWS)
    # t apart from the other rows: intersect_planar replaces it by the
    # miss-marked t, which then frees it while the rest stays held
    out_t = torch.empty((n,), dtype=torch.float32, device=dev)
    out = torch.empty((rows - 1, n), dtype=torch.float32, device=dev)
    out_mat = torch.empty((n,), dtype=torch.int64, device=dev)
    out_outside = torch.empty((n,), dtype=torch.bool, device=dev)
    keep = []   # the incoming record's planes, alive through the call
    in_rows = in_mat = in_outside = None
    if best is not None:
        fields = [best.t, *best.normal, *best.point, *best.surf, best.u,
                  best.v]
        if tangents:
            if best.tan is None:
                raise ValueError("tangents needs an incoming record with "
                                 "its tangent")
            fields += list(best.tan)
        keep = [_plane(f.detach(), n, dev, "best").contiguous()
                for f in fields]
        keep.append(_plane(best.mat_id, n, dev, "best.mat_id",
                           torch.int64).contiguous())
        keep.append(_plane(best.outside, n, dev, "best.outside",
                           torch.bool).contiguous())
        in_rows = (ctypes.c_void_p * len(ROWS))(
            *[f.data_ptr() for f in keep[:rows]])
        in_mat, in_outside = keep[-2].data_ptr(), keep[-1].data_ptr()
    if n > 0:
        ray_ptrs = (ctypes.c_void_p * len(rays))(
            *[r.data_ptr() for r in rays])
        strides = (ctypes.c_longlong * len(rays))(
            *[r.stride(0) for r in rays])
        # the (geom, type) pairs, copied to the card once a run
        table = _index_tensor(tuple(v for pair in run for v in pair), dev)
        lib = _kernel_lib()
        with torch.cuda.device(dev):
            rc = lib.prim_hit_launch(
                n, ray_ptrs, strides,
                None if t_init is None else t_init.data_ptr(), in_rows,
                in_mat, in_outside, table.data_ptr(), len(run),
                tables[0].data_ptr(), tables[1].data_ptr(),
                tables[2].data_ptr(), vel.data_ptr(), mat.data_ptr(),
                int(tangents), out_t.data_ptr(), out.data_ptr(),
                out_mat.data_ptr(),
                out_outside.data_ptr(), tally_address(dev, "prim"),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError("prim_hit launch failed: "
                               + lib.prim_hit_error_string(rc).decode())
        count("prim")
    return HitP(t=out_t, normal=V3(out[0], out[1], out[2]), mat_id=out_mat,
                point=V3(out[3], out[4], out[5]),
                surf=V3(out[6], out[7], out[8]), u=out[9], v=out[10],
                outside=out_outside,
                tan=V3(out[11], out[12], out[13]) if tangents else None)


def differing_lanes(got, want) -> dict:
    """The lanes whose bits differ between two records of [N] planes (hit
    records, or ops/shade's ShadeOutP), by field (`normal.x` and so on; a
    float compared by its bit pattern, so -0.0 against 0.0 and NaN payloads
    count), for the fields that differ at all."""
    def planes(hit):
        out = {}
        for k in hit._fields:
            v = getattr(hit, k)
            if isinstance(v, tuple):
                out.update({f"{k}.{c}": x for c, x in zip("xyz", v)})
            elif v is not None:
                out[k] = v
        return out
    g, w = planes(got), planes(want)
    if g.keys() != w.keys():
        raise ValueError(f"records of other fields: {sorted(g)} against "
                         f"{sorted(w)}")
    out = {}
    for k, b in w.items():
        a = g[k].expand_as(b)
        if b.dtype == torch.float32:
            a, b = a.contiguous().view(torch.int32), b.view(torch.int32)
        bad = int((a != b).sum())
        if bad:
            out[k] = bad
    return out
