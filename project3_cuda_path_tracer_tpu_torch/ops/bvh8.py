"""8-wide BVH traversal: kernel K2, now CUDA (csrc/bvh8.cu).

Counterpart of project3_cuda_path_tracer_tpu/ops/bvh8.py. The Pallas kernel
there (`_traverse8_kernel`) walks one shared stack per packet of 2,048 rays
and slab-tests a node's 8 children across the packet. On the H100 each lane
walks its own ray with its own stack: pop an entry; a leaf runs
Moller-Trumbore on its <= WIDE_LEAF_K rows with the normal and uv
interpolated in the kernel; an interior node slab-tests its 8 children and
pushes every child the ray enters, far child first. The order follows the
ray's own origin coordinate on the node's sort axis against the node's
threshold: the per-ray counterpart of the packet's centroid vote. A ray's
pops depend only on the ray, so every schedule gives the same outputs and
pop counts, bit for bit.

What bounds it: bytes, the rays (28 B in, 28 B out) and the tree rows they
read; what keeps it from that is the dependent pop chain and rays of one
warp that need from 1 to dozens of pops. So the kernel the renderer
launches is persistent: a grid that fills the card (`_persistent_blocks`),
warps that take 32-ray chunks from a counter and refill their finished
lanes, a dead lane (t_bound <= 0 or NaN) answered without reading the
tree, the first S stack entries in shared memory and the rest in a local
array, node and triangle rows read as 16-byte vectors.

`traverse8()` is the wrapper the integrator calls: CPU tensors take
`traverse8_plain` (the same per-ray stack walk in torch ops), CUDA tensors
launch the persistent kernel on the planes as they are (a plane is copied
only if it is not contiguous), counted under `k2` (and, in the occlusion
mode that NEE's shadow rays take, also under `k2_any_hit`); the kernel
itself adds the launch to the card's `k2` (and `k2_any_hit`) tally
(utils/launches.py), which CUDA graph replays reach too. Two more instances
serve chip_smoke.py and tests/test_torch_cuda.py only (CUDA tensors only):
`_traverse8_grid`, the first port's schedule, one thread per ray (the A/B
and the bitwise check), and `_traverse8_tiny`, the persistent one with a
2-entry shared stack, which exercises the local overflow; both count under
`k2_other`.

Layout, built on the host from the binned-SAH binary tree of scene/bvh.py
(`pack_mesh8`, bit for bit as the JAX package packs it; the JAX `nodes`
table):
  nodes [B8, 128] f32, one row per 8-wide node:
      cols 0-47   child c's box at 6c: lo.xyz, hi.xyz; empty slots are NaN
      cols 48-55  child c's stack encoding as f32 (exact below 2^24): the
                  node row if interior, -(start*32+count)-2 if a leaf, 0
                  for an empty slot (0 is the root, never a child)
      col 56      the children's sort axis 0/1/2 (ascending box centre)
      col 57      the push-order threshold: the midpoint of the first and
                  last child centres along that axis
  tris  [T+8, 24] f32, the row format of ops/pallas_bvh.py (+8 zero rows).
"""
from __future__ import annotations

import ctypes
import functools
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..scene import types as T
from ..utils import cuda_build
from ..utils.device import stream_counter
from ..utils.launches import count, tally_address
from . import pallas_bvh as PB

# The kernel's instances, as csrc/bvh8.cu numbers them.
INSTANCES = {"persistent": 0, "grid": 1, "tiny": 2}

WIDTH = 8          # children per node
STACK = 128        # per-ray stack entries; pack_mesh8 asserts the bound
# Fat leaves: a binary subtree of <= WIDE_LEAF_K triangles (contiguous in
# the DFS order) becomes one leaf child; meta = start*32 + count.
WIDE_LEAF_K = 4
ROW = 128
F32 = torch.float32


class PackedMesh8(NamedTuple):
    """One mesh in the 8-wide layout (root node = row 0)."""
    nodes: torch.Tensor  # [B8, 128] f32
    tris: torch.Tensor   # [T+8, 24] f32


def _local_binary(meshes: T.MeshBundle, mesh_index: int):
    """Rebase one mesh's binary BVH out of the concatenated bundle:
    node indices local (root 0), tri starts local."""
    n0, n1, t0, t1 = PB.mesh_range(meshes, mesh_index)
    lo = np.asarray(meshes.node_lo, np.float32)[n0:n1]
    hi = np.asarray(meshes.node_hi, np.float32)[n0:n1]
    start = np.asarray(meshes.node_start, np.int64)[n0:n1]
    count = np.asarray(meshes.node_count, np.int64)[n0:n1]
    right = np.asarray(meshes.node_right, np.int64)[n0:n1]
    start = np.where(count > 0, start - t0, -1)
    right = np.where(right >= 0, right - n0, -1)
    return lo, hi, start, count, right, t0, t1


def pack_mesh8(meshes: T.MeshBundle, mesh_index: int = 0) -> PackedMesh8:
    """Collapse one mesh's binary BVH into the 8-wide layout.

    Collapse rule: start from a binary interior node's two children and
    repeatedly replace the interior child with the LARGEST surface area by
    its two children until 8 slots are used (grow-widest)."""
    lo, hi, start, count, right, t0, t1 = _local_binary(meshes, mesh_index)
    b_n = lo.shape[0]

    # Subtree tri ranges (contiguous because the flattening is DFS with a
    # leaf-contiguous perm): reverse-index post-order pass.
    r0 = np.full(b_n, -1, np.int64)
    r1 = np.full(b_n, -1, np.int64)
    for b in range(b_n - 1, -1, -1):
        if count[b] > 0:
            r0[b], r1[b] = start[b], start[b] + count[b]
        else:
            l, r = b + 1, int(right[b])
            r0[b] = min(r0[l], r0[r])
            r1[b] = max(r1[l], r1[r])

    def is_fat_leaf(k: int) -> bool:
        return count[k] > 0 or (r1[k] - r0[k]) <= WIDE_LEAF_K

    def leaf_meta(k: int) -> int:
        s, c = (int(start[k]), int(count[k])) if count[k] > 0 else (
            int(r0[k]), int(r1[k] - r0[k]))
        assert 0 < c <= WIDE_LEAF_K
        return s * 32 + c

    rows: list = []

    def kids_of(b: int):
        kids = [b + 1, int(right[b])]
        while len(kids) < WIDTH:
            best_i, best_sa = -1, -1.0
            for i, k in enumerate(kids):
                if not is_fat_leaf(k):
                    d = np.maximum(hi[k] - lo[k], 0.0)
                    sa = float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
                    if sa > best_sa:
                        best_sa, best_i = sa, i
            if best_i < 0:
                break
            k = kids.pop(best_i)
            kids.append(k + 1)
            kids.append(int(right[k]))
        return kids

    def empty_row() -> np.ndarray:
        f = np.zeros(ROW, np.float32)
        f[0:6 * WIDTH] = np.nan   # NaN boxes: every slab compare fails
        return f

    max_depth = 0

    def build(b: int, depth: int) -> int:
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        my = len(rows)
        f = empty_row()
        rows.append(f)
        kids = kids_of(b)
        # children ascending by box centre along the parent's largest axis
        axis = int(np.argmax(hi[b] - lo[b]))
        kids.sort(key=lambda k: float(lo[k][axis] + hi[k][axis]))
        f[56] = axis
        centers = [0.5 * float(lo[k][axis] + hi[k][axis]) for k in kids]
        f[57] = 0.5 * (centers[0] + centers[-1])
        for c, k in enumerate(kids):
            f[6 * c: 6 * c + 3] = lo[k]
            f[6 * c + 3: 6 * c + 6] = hi[k]
            if is_fat_leaf(k):
                f[48 + c] = -leaf_meta(k) - 2
        for c, k in enumerate(kids):
            if not is_fat_leaf(k):
                f[48 + c] = build(k, depth + 1)
        return my

    if count[0] > 0:
        # the whole mesh is one binary leaf: one 8-wide node, one leaf slot
        f = empty_row()
        f[0:3], f[3:6] = lo[0], hi[0]
        f[48] = -(int(start[0]) * 32 + int(count[0])) - 2
        rows.append(f)
        max_depth = 1
    else:
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10000))
        try:
            build(0, 1)
        finally:
            sys.setrecursionlimit(old)

    # Worst-case stack: each level on the DFS path parks <= WIDTH-1 residual
    # siblings, plus the current node's <= WIDTH pushes, plus the JAX
    # kernel's <= WIDTH-1 trailing stores (kept so that both packages
    # accept the same trees).
    bound = (WIDTH - 1) * max_depth + WIDTH + (WIDTH - 1)
    if bound > STACK:
        raise ValueError(f"BVH8 worst-case stack {bound} exceeds the "
                         f"kernel's STACK={STACK} (tree depth {max_depth})")
    nodes = np.stack(rows)
    if np.abs(nodes[:, 48:56]).max(initial=0) >= (1 << 24):
        raise ValueError("child stack encoding exceeds the f32 "
                         "exact-integer range")
    return PackedMesh8(nodes=torch.from_numpy(nodes),
                       tris=torch.from_numpy(PB.pack_tris(meshes, t0, t1, 8)))


def pack_all8(meshes: T.MeshBundle):
    """One PackedMesh8 per mesh in the bundle (empty tuple for no meshes)."""
    if meshes.tri_v0.shape[0] <= 1:
        return ()
    return tuple(pack_mesh8(meshes, i)
                 for i in range(meshes.mesh_root.shape[0]))


# ---------------------------------------------------------------------------
# Plain version and kernel wrapper
# ---------------------------------------------------------------------------

def traverse8_plain(qo, qd, packed: PackedMesh8,
                    t_bound: Optional[torch.Tensor] = None,
                    any_hit: bool = False):
    """K2 in torch ops: a per-ray stack walk over the 8-wide layout. Each
    step pops one entry of every ray whose stack is not empty. Returns the
    `traverse8` outputs and the per-ray pop count [N] int32."""
    o, d, inv = PB.rays(qo, qd)
    n, dev = o.shape[0], o.device
    st = PB.new_state(n, t_bound, dev)
    stack = torch.zeros((n, STACK), dtype=torch.int32, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)  # root pushed
    pops = torch.zeros((n,), dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    while rows.numel():
        top = sp[rows] - 1
        e = stack[rows, top]
        sp[rows] = top
        pops[rows] += 1
        inner = e >= 0
        ri = rows[inner]
        if ri.numel():
            row = packed.nodes[e[inner].to(torch.int64)]
            box = row[:, :6 * WIDTH].reshape(-1, WIDTH, 6)
            enc = row[:, 48:56].to(torch.int32)
            o_r = o[ri]
            hit = PB.box_hits(box[..., 0:3], box[..., 3:6], o_r[:, None],
                              inv[ri][:, None], st.t_best[ri][:, None])
            hit &= enc != 0
            axis = row[:, 56].to(torch.int64)
            rev = o_r.gather(1, axis[:, None])[:, 0] < row[:, 57]
            # push order: far child first, so the near one pops first
            hit = torch.where(rev[:, None], hit.flip(1), hit)
            enc = torch.where(rev[:, None], enc.flip(1), enc)
            pos = sp[ri][:, None] + torch.cumsum(hit, dim=1) - 1
            r_i, c_i = hit.nonzero(as_tuple=True)
            stack[ri[r_i], pos[r_i, c_i]] = enc[r_i, c_i]
            sp[ri] += hit.sum(dim=1)
        rl = rows[~inner]
        if rl.numel():
            meta = -e[~inner].to(torch.int64) - 2
            PB.leaf_phase(rl, meta // 32, meta % 32, o, d, packed.tris, st,
                          WIDE_LEAF_K)
            if any_hit:
                sp[rl[st.tri[rl] >= 0]] = 0
        rows = rows[sp[rows] > 0]
    return PB.finish(st) + (pops,)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load("bvh8")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    persistent = ([ptr] * 7 + [i32] + [ptr] * 2 + [i32] + [ptr] * 3 + [i32]
                  + [ptr] * 4)
    lib.bvh8_traverse.argtypes = persistent
    lib.bvh8_traverse_tiny.argtypes = persistent
    lib.bvh8_traverse_grid.argtypes = ([ptr] * 7 + [i32] + [ptr] * 2 + [i32]
                                       + [ptr] * 6)
    lib.bvh8_attributes.argtypes = [i32] * 2 + [ctypes.POINTER(i32)]
    for fn in (lib.bvh8_traverse, lib.bvh8_traverse_tiny,
               lib.bvh8_traverse_grid, lib.bvh8_attributes):
        fn.restype = ctypes.c_int
    lib.bvh_error_string.restype = ctypes.c_char_p
    lib.bvh_error_string.argtypes = [ctypes.c_int]
    return lib


def _attributes(instance: str, any_hit: bool) -> tuple:
    """(registers, local bytes, max threads per block, resident blocks per
    SM, static shared bytes) of one instance on the current device."""
    lib = _kernel_lib()
    out = (ctypes.c_int * 5)()
    PB.raise_on(lib.bvh8_attributes(INSTANCES[instance], int(any_hit), out),
                lib, "bvh8 attributes")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _persistent_blocks(device_index: int, instance: str,
                       any_hit: bool) -> int:
    """The persistent grid that fills the card: SMs x the instance's
    resident blocks, worked out once per device and instance."""
    with torch.cuda.device(device_index):
        per_sm = _attributes(instance, any_hit)[3]
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * per_sm


def kernel_attributes(device) -> list:
    """Registers, local memory bytes (the stack's overflow array and any
    spills), max threads per block, resident blocks per SM and static
    shared bytes of every kernel instance, as the CUDA runtime reports them
    for `device`."""
    recs = []
    with torch.cuda.device(device):
        for instance in INSTANCES:
            for any_hit in (False, True):
                out = _attributes(instance, any_hit)
                recs.append(dict(instance=instance, any_hit=any_hit,
                                 registers=out[0], local_bytes=out[1],
                                 max_threads_per_block=out[2],
                                 blocks_per_sm=out[3],
                                 static_smem_bytes=out[4]))
    return recs


def _launch(instance: str, qo, qd, packed: PackedMesh8,
            t_bound: Optional[torch.Tensor] = None, any_hit: bool = False,
            return_pops: bool = False,
            stats: Optional[torch.Tensor] = None):
    """Check the inputs and launch one instance of K2 on the current stream
    (CUDA tensors only); count it. `stats`, an int64 [3] tensor on the
    card, gets the busy and total lane slots of the pop steps added and the
    deepest stack maxed in."""
    if instance not in INSTANCES:
        raise ValueError(f"instance must be one of {tuple(INSTANCES)}")
    dev = PB.check_rays(qo, qd, t_bound)
    PB.check_table("nodes", packed.nodes, ROW, F32, dev)
    PB.check_table("tris", packed.tris, PB.TRI_ROW, F32, dev)
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    PB.check_aligned(packed.nodes, packed.tris)
    if stats is not None and (stats.dtype != torch.int64
                              or tuple(stats.shape) != (3,)
                              or stats.device != dev
                              or not stats.is_contiguous()):
        raise ValueError("stats must be a contiguous int64 [3] tensor on "
                         "the rays' device")
    n = qo[0].shape[0]
    if n >= 1 << 30:
        raise ValueError(f"{n} rays: the kernel's ray counter takes < 2^30")
    planes = [c.contiguous() for c in (*qo, *qd)]
    tb = None if t_bound is None else t_bound.contiguous()
    out = torch.empty((6, n), dtype=F32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    pops = (torch.empty((n,), dtype=torch.int32, device=dev) if return_pops
            else None)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        args = ([c.data_ptr() for c in planes]
                + [tb.data_ptr() if tb is not None else None, n,
                   packed.nodes.data_ptr(), packed.tris.data_ptr(),
                   int(any_hit), out.data_ptr(), tri.data_ptr(),
                   pops.data_ptr() if pops is not None else None])
        st = stats.data_ptr() if stats is not None else None
        # the route's instance adds its launches to the device tally
        tally = (tally_address(dev, "k2") if instance == "persistent"
                 else None)
        if instance == "grid":
            rc = lib.bvh8_traverse_grid(*args, st, tally, stream)
        else:
            fn = (lib.bvh8_traverse if instance == "persistent"
                  else lib.bvh8_traverse_tiny)
            blocks = _persistent_blocks(dev.index, instance, any_hit)
            counter = stream_counter(dev, stream)
            rc = fn(*args, blocks, counter.data_ptr(), st, tally, stream)
    PB.raise_on(rc, lib, "bvh8")
    if instance == "persistent":
        count("k2")
        if any_hit:
            count("k2_any_hit")
    else:
        count("k2_other")
    res = PB.unpack_out(out, tri)
    return res + (pops,) if return_pops else res


def _traverse8_grid(qo, qd, packed: PackedMesh8,
                    t_bound: Optional[torch.Tensor] = None,
                    any_hit: bool = False, return_pops: bool = False,
                    stats: Optional[torch.Tensor] = None):
    """`traverse8` in the first port's schedule, one thread per ray (CUDA
    tensors only): the A/B and the bitwise check of the two schedules."""
    return _launch("grid", qo, qd, packed, t_bound, any_hit, return_pops,
                   stats)


def _traverse8_tiny(qo, qd, packed: PackedMesh8,
                    t_bound: Optional[torch.Tensor] = None,
                    any_hit: bool = False, return_pops: bool = False,
                    stats: Optional[torch.Tensor] = None):
    """`traverse8` in the persistent schedule with a 2-entry shared stack,
    so that deeper entries take the local overflow (CUDA tensors only): the
    bitwise check of the overflow path."""
    return _launch("tiny", qo, qd, packed, t_bound, any_hit, return_pops,
                   stats)


def traverse8(qo, qd, packed: PackedMesh8,
              t_bound: Optional[torch.Tensor] = None, any_hit: bool = False,
              return_pops: bool = False):
    """Nearest hit over the 8-wide packed mesh (the JAX `traverse_packets8`
    with its defaults): (t_obj, (nx, ny, nz), u, v, tri) with tri -1 for a
    miss; a miss keeps t = t_bound with zero normal and uv, and a lane with
    t_bound <= 0 (or NaN) is dead. `return_pops` appends the per-ray pop
    count [N] int32 (the JAX kernel counts pops per packet).

    `any_hit` is the occlusion mode: a ray stops after the first leaf in
    which it accepts a triangle, and reports that leaf's nearest hit. It
    reports a hit exactly where the nearest-hit mode does.

    CPU tensors take `traverse8_plain`; CUDA tensors launch the kernel's
    persistent schedule on the current stream (no synchronisation) and
    count it under `k2`."""
    dev = PB.check_rays(qo, qd, t_bound)
    if dev.type == "cpu":
        PB.check_table("nodes", packed.nodes, ROW, F32, dev)
        PB.check_table("tris", packed.tris, PB.TRI_ROW, F32, dev)
        res = traverse8_plain(qo, qd, packed, t_bound, any_hit)
        return res if return_pops else res[:-1]
    return _launch("persistent", qo, qd, packed, t_bound, any_hit,
                   return_pops)
