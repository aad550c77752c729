"""Binary skip-pointer BVH traversal: kernels K3 and K4, now CUDA.

Counterpart of project3_cuda_path_tracer_tpu/ops/pallas_bvh.py. The module
keeps its name so that a reader finds the counterpart, but its Pallas
kernels are now one CUDA source, csrc/bvh_binary.cu:

  K3 (`_traverse_kernel` of the JAX package): each lane walks one ray over
     the skip-pointer tree with its own cursor: slab-test the node, run the
     leaf if it is one and the ray entered it, then go to `cur+1` (an
     interior node the ray entered) or to the node's escape index `skip`.
     One thread per ray (`grid`): every ray starts at once, and a launch
     lasts about as long as its longest walks.
  K4 (`_traverse_kernel_sub`): the packet form, one cursor per 32-lane warp
     (the counterpart of one cursor per 128-lane row). Persistent warps (a
     grid that fills the card, `_persistent_blocks`) form packets of 32
     live rays in ray order; the cursor is the smallest node any lane is
     due at, and a lane steps only at its own next node, so it visits and
     tests exactly what its K3 walk does.
A ray's visits depend only on the ray, so every instance gives the same
outputs and step counts, bit for bit. A dead ray (t_bound <= 0 or NaN) is
answered without reading the tree, and the rays are read from the planes
as they are (a plane is copied only if it is not contiguous).

`traverse()` is the wrapper the integrator calls: CPU tensors take
`traverse_binary_plain` (a per-ray skip-cursor walk in torch ops, shared by
K3 and K4); CUDA tensors launch K3 or, with `sub_packets`, K4, each
counted under `k3_k4` and K4 under `k4` too (utils/launches.py), and the
kernel itself adds one to the card's `k3_k4` tally. chip_smoke.py and
tests/test_torch_cuda.py call `_launch` directly for its `stats` tally
(CUDA tensors only).

`pack_mesh` turns one mesh of a `MeshBundle` into the kernel's tables, bit
for bit as the JAX package does:
  nodes_f [B,8] f32 = lo.xyz, hi.xyz, pad2;
  nodes_i [B,8] i32 = skip, meta, pad6 with meta = start*16 + count for
                      leaves (count <= LEAF_K) and -1 for interior nodes;
  tris [T+1, TRI_ROW] f32 = v0, e1, e2, n0, n1, n2, uv0, uv1, uv2 (+1
                      degenerate pad row);
and, for the kernels, which read only `nodes` and `tris`, the fused rows
(`fuse_nodes`):
  nodes [B,8] f32 = lo.xyz, hi.xyz, then skip and meta bit-cast to f32,
                      one 32-byte row a node step.
The helpers `box_hits` and `leaf_phase` are the plain arithmetic of the
slab test and the Moller-Trumbore leaf that both traversal kernels (K2 in
ops/bvh8.py too) run; csrc/bvh_common.cuh is their CUDA form, with the same
operation order and no contracted multiply-adds.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..scene import types as T
from ..scene.bvh import LEAF_K
from ..utils import cuda_build
from ..utils.device import stream_counter
from ..utils.launches import count, tally_address

# The kernel's instances, as csrc/bvh_binary.cu numbers them.
INSTANCES = {"grid": 1, "packet": 2}

BIG = 1e30
TRI_ROW = 24      # v0(3) e1(3) e2(3) n0(3) n1(3) n2(3) uv0(2) uv1(2) uv2(2)
F32 = torch.float32
I32 = torch.int32


class PackedMesh(NamedTuple):
    """One mesh in the binary skip-pointer layout (local indices, root 0)."""
    nodes_f: torch.Tensor  # [B,8] f32
    nodes_i: torch.Tensor  # [B,8] i32
    tris: torch.Tensor     # [T+1, TRI_ROW] f32
    nodes: torch.Tensor    # [B,8] f32, fused rows (fuse_nodes)


def fuse_nodes(nodes_f: torch.Tensor, nodes_i: torch.Tensor) -> torch.Tensor:
    """The kernels' node rows: nodes_f's lo.xyz, hi.xyz, then nodes_i's skip
    and meta with their bits kept as f32 (never computed with)."""
    return torch.cat([nodes_f[:, :6],
                      nodes_i[:, :2].contiguous().view(F32)], dim=1)


def mesh_range(meshes: T.MeshBundle, mesh_index: int):
    """(n0, n1, t0, t1): mesh `mesh_index`'s node and triangle ranges in the
    concatenated bundle."""
    roots = np.asarray(meshes.mesh_root, np.int64)
    tri_offs = np.asarray(meshes.mesh_tri_offset, np.int64)
    n0 = int(roots[mesh_index])
    n1 = (int(roots[mesh_index + 1]) if mesh_index + 1 < len(roots)
          else meshes.node_lo.shape[0])
    t0 = int(tri_offs[mesh_index])
    t1 = (int(tri_offs[mesh_index + 1]) if mesh_index + 1 < len(tri_offs)
          else meshes.tri_v0.shape[0])
    return n0, n1, t0, t1


def pack_tris(meshes: T.MeshBundle, t0: int, t1: int, pad: int) -> np.ndarray:
    """Triangles t0..t1 as [t1-t0+pad, TRI_ROW] rows; the `pad` trailing
    rows are zero (det = 0, never hit)."""
    t = t1 - t0
    sl = slice(t0, t1)
    tris = np.zeros((t + pad, TRI_ROW), np.float32)
    for col, name in ((0, "tri_v0"), (3, "tri_e1"), (6, "tri_e2"),
                      (9, "tri_n0"), (12, "tri_n1"), (15, "tri_n2"),
                      (18, "tri_uv0"), (20, "tri_uv1"), (22, "tri_uv2")):
        a = np.asarray(getattr(meshes, name), np.float32)[sl]
        tris[:t, col:col + a.shape[1]] = a
    return tris


def pack_mesh(meshes: T.MeshBundle, mesh_index: int = 0) -> PackedMesh:
    """Extract + rebase one mesh from the concatenated bundle so its local
    root is node 0."""
    n0, n1, t0, t1 = mesh_range(meshes, mesh_index)
    nlo = np.asarray(meshes.node_lo, np.float32)[n0:n1]
    nhi = np.asarray(meshes.node_hi, np.float32)[n0:n1]
    start = np.asarray(meshes.node_start, np.int64)[n0:n1]
    count = np.asarray(meshes.node_count, np.int64)[n0:n1]
    skip = np.asarray(meshes.node_skip, np.int32)[n0:n1]
    skip = np.where(skip >= 0, skip - n0, -1).astype(np.int32)
    start_local = np.where(count > 0, start - t0, -1)
    b = nlo.shape[0]

    assert count.max() <= 15, "meta encoding holds counts <= 15"
    meta = np.where(count > 0, start_local * 16 + count, -1).astype(np.int32)
    nodes_f = np.zeros((b, 8), np.float32)
    nodes_f[:, 0:3] = nlo
    nodes_f[:, 3:6] = nhi
    nodes_i = np.zeros((b, 8), np.int32)
    nodes_i[:, 0] = skip
    nodes_i[:, 1] = meta
    nodes_f, nodes_i = torch.from_numpy(nodes_f), torch.from_numpy(nodes_i)
    return PackedMesh(nodes_f=nodes_f, nodes_i=nodes_i,
                      tris=torch.from_numpy(pack_tris(meshes, t0, t1, 1)),
                      nodes=fuse_nodes(nodes_f, nodes_i))


def pack_all(meshes: T.MeshBundle):
    """One PackedMesh per mesh in the bundle (empty tuple for no meshes)."""
    if meshes.tri_v0.shape[0] <= 1:
        return ()
    return tuple(pack_mesh(meshes, i)
                 for i in range(meshes.mesh_root.shape[0]))


# ---------------------------------------------------------------------------
# Plain arithmetic shared by the plain traversals (csrc/bvh_common.cuh)
# ---------------------------------------------------------------------------

class HitState(NamedTuple):
    """Per-ray traversal outputs, updated in place: t_best [N], nrm [N,3]
    (interpolated, unnormalised object-space normal), uv [N,2], tri [N]
    int32 (-1 = no hit yet)."""
    t_best: torch.Tensor
    nrm: torch.Tensor
    uv: torch.Tensor
    tri: torch.Tensor


def new_state(n: int, t_bound: Optional[torch.Tensor], device) -> HitState:
    t_best = (torch.full((n,), BIG, dtype=F32, device=device)
              if t_bound is None else t_bound.clone())
    return HitState(t_best, torch.zeros((n, 3), dtype=F32, device=device),
                    torch.zeros((n, 2), dtype=F32, device=device),
                    torch.full((n,), -1, dtype=I32, device=device))


def box_hits(lo: torch.Tensor, hi: torch.Tensor, o: torch.Tensor,
             inv: torch.Tensor, t_best: torch.Tensor) -> torch.Tensor:
    """Slab test, broadcast over leading dims ([..., 3] boxes and rays).

    torch.minimum/maximum pass NaN on, as jnp's do: a NaN box (an empty
    8-wide slot) or a 0*inf slab of an axis-parallel ray makes every compare
    false, so the ray does not enter. The predicate keeps its four explicit
    terms: the JAX 8-wide kernel folds `tmax > 0` into `tmax >= max(tmin,
    TINY)`, which is exact only under the TPU's flush-to-zero, and the H100
    keeps subnormals. `t_best > 0` deadens lanes whose bound is <= 0
    (terminated paths)."""
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    a, b = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tmin = torch.maximum(a[..., 0], torch.maximum(a[..., 1], a[..., 2]))
    tmax = torch.minimum(b[..., 0], torch.minimum(b[..., 1], b[..., 2]))
    return (tmax >= tmin) & (tmax > 0) & (tmin < t_best) & (t_best > 0)


def leaf_phase(rows: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
               o: torch.Tensor, d: torch.Tensor, tris: torch.Tensor,
               st: HitState, leaf_k: int = LEAF_K) -> None:
    """Moller-Trumbore of rays `rows` against the leaf rows start..start+
    count-1 (count <= leaf_k), in the JAX kernels' operation order; a
    strictly nearer hit wins, so ties keep the first found. Updates `st`."""
    ro, rd = o[rows], d[rows]
    ox, oy, oz = ro[:, 0], ro[:, 1], ro[:, 2]
    dx, dy, dz = rd[:, 0], rd[:, 1], rd[:, 2]
    tb, nrm, uv, tri = (st.t_best[rows], st.nrm[rows], st.uv[rows],
                        st.tri[rows])
    last = tris.shape[0] - 1
    for k in range(leaf_k):
        idx = start + k
        r = tris[torch.clamp(idx, max=last)]
        v0x, v0y, v0z = r[:, 0], r[:, 1], r[:, 2]
        e1x, e1y, e1z = r[:, 3], r[:, 4], r[:, 5]
        e2x, e2y, e2z = r[:, 6], r[:, 7], r[:, 8]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        ok_det = det.abs() > 1e-12
        inv_det = torch.where(ok_det, 1.0 / det, torch.zeros_like(det))
        tvx = ox - v0x
        tvy = oy - v0y
        tvz = oz - v0z
        bu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        bv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t_k = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        hit = (ok_det & (bu >= 0) & (bv >= 0) & (bu + bv <= 1)
               & (t_k > 1e-6) & (t_k < tb) & (k < count))
        bw = 1.0 - bu - bv
        n_k = torch.stack([bw * r[:, 9 + a] + bu * r[:, 12 + a]
                           + bv * r[:, 15 + a] for a in range(3)], dim=1)
        uv_k = torch.stack([bw * r[:, 18 + a] + bu * r[:, 20 + a]
                            + bv * r[:, 22 + a] for a in range(2)], dim=1)
        tb = torch.where(hit, t_k, tb)
        nrm = torch.where(hit[:, None], n_k, nrm)
        uv = torch.where(hit[:, None], uv_k, uv)
        tri = torch.where(hit, idx.to(I32), tri)
    st.t_best[rows], st.nrm[rows], st.uv[rows], st.tri[rows] = tb, nrm, uv, tri


def finish(st: HitState):
    """(t, (nx, ny, nz), u, v, tri): the JAX traversals' return form."""
    return (st.t_best, (st.nrm[:, 0], st.nrm[:, 1], st.nrm[:, 2]),
            st.uv[:, 0], st.uv[:, 1], st.tri)


def rays(qo: Sequence[torch.Tensor], qd: Sequence[torch.Tensor]):
    """Planar (x, y, z) rays as [N,3] origin, direction, 1/direction."""
    o = torch.stack(list(qo), dim=1)
    d = torch.stack(list(qd), dim=1)
    return o, d, 1.0 / d


# ---------------------------------------------------------------------------
# Plain version and kernel wrapper
# ---------------------------------------------------------------------------

def traverse_binary_plain(qo, qd, packed: PackedMesh,
                          t_bound: Optional[torch.Tensor] = None):
    """Nearest hit over the binary tree, one skip cursor per ray, in torch
    ops (the plain version of K3 and K4), over the JAX-layout tables
    nodes_f and nodes_i. Each step advances every ray whose cursor is still
    >= 0 by one node. Returns the `traverse` outputs and the per-ray step
    count [N] int32 (node visits: 1 for a ray that enters no box)."""
    o, d, inv = rays(qo, qd)
    n = o.shape[0]
    st = new_state(n, t_bound, o.device)
    cur = torch.zeros((n,), dtype=torch.int64, device=o.device)
    steps = torch.zeros((n,), dtype=I32, device=o.device)
    rows = torch.arange(n, device=o.device)
    while rows.numel():
        c = cur[rows]
        steps[rows] += 1
        nf, ni = packed.nodes_f[c], packed.nodes_i[c]
        hit = box_hits(nf[:, 0:3], nf[:, 3:6], o[rows], inv[rows],
                       st.t_best[rows])
        meta = ni[:, 1].to(torch.int64)
        leaf = hit & (meta >= 0)
        if bool(leaf.any()):
            m = meta[leaf]
            leaf_phase(rows[leaf], m // 16, m % 16, o, d, packed.tris, st)
        nxt = torch.where(hit & (meta < 0), c + 1, ni[:, 0].to(torch.int64))
        cur[rows] = nxt
        rows = rows[nxt >= 0]
    return finish(st) + (steps,)


def check_rays(qo, qd, t_bound) -> torch.device:
    """The traversal wrappers' ray checks; returns the rays' device."""
    planes = list(qo) + list(qd) + ([] if t_bound is None else [t_bound])
    if len(qo) != 3 or len(qd) != 3:
        raise ValueError("qo and qd are (x, y, z) planes")
    n, dev = qo[0].shape, qo[0].device
    for p in planes:
        if not isinstance(p, torch.Tensor) or p.dtype != F32:
            raise TypeError("ray planes and t_bound must be float32 tensors")
        if p.ndim != 1 or p.shape != n or p.device != dev:
            raise ValueError("ray planes and t_bound must be [N] tensors "
                             "on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_table(name: str, t: torch.Tensor, cols: int, dtype, dev) -> None:
    if t.dtype != dtype or t.ndim != 2 or t.shape[1] != cols:
        raise ValueError(f"{name} must be [rows, {cols}] {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {dev}")


def check_tables(packed: PackedMesh, dev) -> None:
    check_table("nodes_f", packed.nodes_f, 8, F32, dev)
    check_table("nodes_i", packed.nodes_i, 8, I32, dev)
    check_table("tris", packed.tris, TRI_ROW, F32, dev)
    check_table("nodes", packed.nodes, 8, F32, dev)
    if packed.nodes.shape[0] != packed.nodes_f.shape[0]:
        raise ValueError("nodes and nodes_f must have one row per node")


def check_aligned(*tables: torch.Tensor) -> None:
    """The kernels read table rows as 16-byte vectors."""
    for t in tables:
        if t.data_ptr() % 16:
            raise ValueError("the kernels read rows as 16-byte vectors: "
                             "tables must be 16-byte aligned")


def unpack_out(out: torch.Tensor, tri: torch.Tensor):
    return out[0], (out[1], out[2], out[3]), out[4], out[5], tri


def raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.bvh_error_string(rc).decode())


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load("bvh_binary")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bvh_binary_traverse.argtypes = ([i32] + [ptr] * 7 + [i32]
                                        + [ptr] * 5 + [i32] + [ptr] * 4)
    lib.bvh_binary_attributes.argtypes = [i32, ctypes.POINTER(i32)]
    for fn in (lib.bvh_binary_traverse, lib.bvh_binary_attributes):
        fn.restype = ctypes.c_int
    lib.bvh_error_string.restype = ctypes.c_char_p
    lib.bvh_error_string.argtypes = [ctypes.c_int]
    return lib


def _attributes(instance: str) -> tuple:
    """(registers, local bytes, max threads per block, resident blocks per
    SM, static shared bytes) of one instance on the current device."""
    lib = _kernel_lib()
    out = (ctypes.c_int * 5)()
    raise_on(lib.bvh_binary_attributes(INSTANCES[instance], out), lib,
             "bvh_binary attributes")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _persistent_blocks(device_index: int) -> int:
    """K4's persistent grid that fills the card: SMs x its resident
    blocks, worked out once per device."""
    with torch.cuda.device(device_index):
        per_sm = _attributes("packet")[3]
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * per_sm


def kernel_attributes(device) -> list:
    """Registers, local memory bytes, max threads per block, resident
    blocks per SM and static shared bytes of every kernel instance, as the
    CUDA runtime reports them for `device`."""
    recs = []
    with torch.cuda.device(device):
        for instance in INSTANCES:
            out = _attributes(instance)
            recs.append(dict(instance=instance, registers=out[0],
                             local_bytes=out[1], max_threads_per_block=out[2],
                             blocks_per_sm=out[3], static_smem_bytes=out[4]))
    return recs


def _launch(instance: str, qo, qd, packed: PackedMesh,
            t_bound: Optional[torch.Tensor] = None,
            return_steps: bool = False,
            stats: Optional[torch.Tensor] = None):
    """Check the inputs and launch one instance of K3/K4 on the current
    stream (CUDA tensors only); count it under `k3_k4`, and K4 under `k4`
    too.
    `stats`, an int64 [2] tensor on the card, gets the busy and total lane
    slots of the steps added."""
    if instance not in INSTANCES:
        raise ValueError(f"instance must be one of {tuple(INSTANCES)}")
    dev = check_rays(qo, qd, t_bound)
    check_tables(packed, dev)
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    check_aligned(packed.nodes, packed.tris)
    if stats is not None and (stats.dtype != torch.int64
                              or tuple(stats.shape) != (2,)
                              or stats.device != dev
                              or not stats.is_contiguous()):
        raise ValueError("stats must be a contiguous int64 [2] tensor on "
                         "the rays' device")
    n = qo[0].shape[0]
    if n >= 1 << 30:
        raise ValueError(f"{n} rays: the kernel's ray counter takes < 2^30")
    planes = [c.contiguous() for c in (*qo, *qd)]
    tb = None if t_bound is None else t_bound.contiguous()
    out = torch.empty((6, n), dtype=F32, device=dev)
    tri = torch.empty((n,), dtype=I32, device=dev)
    steps = (torch.empty((n,), dtype=I32, device=dev) if return_steps
             else None)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        blocks, counter = 0, None
        if instance == "packet":
            blocks = _persistent_blocks(dev.index)
            counter = stream_counter(dev, stream).data_ptr()
        rc = lib.bvh_binary_traverse(
            INSTANCES[instance], *[c.data_ptr() for c in planes],
            tb.data_ptr() if tb is not None else None, n,
            packed.nodes.data_ptr(), packed.tris.data_ptr(), out.data_ptr(),
            tri.data_ptr(), steps.data_ptr() if steps is not None else None,
            blocks, counter, stats.data_ptr() if stats is not None else None,
            tally_address(dev, "k3_k4"), stream)
    raise_on(rc, lib, "bvh_binary")
    count("k3_k4")
    if instance == "packet":
        count("k4")
    res = unpack_out(out, tri)
    return res + (steps,) if return_steps else res


def traverse(qo, qd, packed: PackedMesh,
             t_bound: Optional[torch.Tensor] = None,
             sub_packets: bool = False, return_steps: bool = False):
    """Nearest hit over the packed binary tree for planar object-space rays
    (the JAX `traverse_packets`).

    qo, qd: (x, y, z) [N] float32 planes. `t_bound` [N] (object space) is
    the occlusion bound: subtrees beyond it are pruned, and a lane with
    t_bound <= 0 (or NaN) is dead; None means unbounded. Returns (t_obj
    [N], normal (nx, ny, nz) [N] each, u [N], v [N], tri [N] int32 with -1
    = miss). A miss keeps t = t_bound with zero normal and uv.
    `return_steps` appends the per-ray node visits [N] int32.
    `sub_packets` picks K4 over K3 on the card; the results are the same,
    bit for bit.

    CPU tensors take `traverse_binary_plain`; CUDA tensors launch K3, one
    thread per ray, or K4 on the current stream (no synchronisation),
    counted under `k3_k4`."""
    dev = check_rays(qo, qd, t_bound)
    if dev.type == "cpu":
        check_tables(packed, dev)
        res = traverse_binary_plain(qo, qd, packed, t_bound)
        return res if return_steps else res[:5]
    return _launch("packet" if sub_packets else "grid", qo, qd, packed,
                   t_bound, return_steps)
