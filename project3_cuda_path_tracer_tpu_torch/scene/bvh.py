"""OBJ loading + BVH construction (host-side, NumPy).

Counterpart of project3_cuda_path_tracer_tpu/scene/bvh.py, function for
function and with the same arithmetic, so both packages build the same tree
from the same file (tests/test_torch_bvh.py holds them bit for bit). The
tree is built on the host with binned SAH and flattened into the
skip-pointer layout of `scene.types.MeshBundle`: depth-first, left child at
parent+1, `node_skip` the escape index. Triangles are reordered so every
leaf references a contiguous range of at most LEAF_K of them. Everything is
NumPy until `build_mesh_bundle` wraps the finished arrays as tensors.
"""
from __future__ import annotations

import sys
from typing import List, Tuple

import numpy as np
import torch

from . import types as T

SAH_BINS = 16
# Binary leaf size (the JAX package's ops/intersect.LEAF_K).
LEAF_K = 4


# ---------------------------------------------------------------------------
# OBJ parsing
# ---------------------------------------------------------------------------

def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a Wavefront OBJ into (verts [T,3,3], normals [T,3,3], uvs [T,3,2]).

    Uses the native C++ parser (native/src/pt_native.cpp) when it is built;
    `_load_obj_py` is the fallback and the test oracle. Supports v / vn / vt
    and f with any of the four index forms (v, v/vt, v//vn, v/vt/vn);
    polygons are fan-triangulated; negative indices are relative per the OBJ
    spec. Faces without normals get the (counter-clockwise) face normal at
    all three corners.
    """
    from ..utils import native
    if native.is_available():
        res = native.parse_obj(path)
        if res is not None:
            return res
    return _load_obj_py(path)


def _load_obj_py(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    vs: List[List[float]] = []
    vns: List[List[float]] = []
    vts: List[List[float]] = []
    faces: List[List[Tuple[int, int, int]]] = []

    with open(path, "r") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                vs.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif tok[0] == "vn":
                vns.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif tok[0] == "vt":
                vts.append([float(tok[1]), float(tok[2])])
            elif tok[0] == "f":
                corners = []
                for c in tok[1:]:
                    parts = c.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    corners.append((vi, ti, ni))
                faces.append(corners)

    def _resolve(idx: int, n: int) -> int:
        return idx - 1 if idx > 0 else n + idx

    tris_v, tris_n, tris_t = [], [], []
    for corners in faces:
        for k in range(1, len(corners) - 1):
            tri = [corners[0], corners[k], corners[k + 1]]
            pv = [vs[_resolve(c[0], len(vs))] for c in tri]
            if all(c[2] != 0 for c in tri) and vns:
                pn = [vns[_resolve(c[2], len(vns))] for c in tri]
            else:
                e1 = np.subtract(pv[1], pv[0])
                e2 = np.subtract(pv[2], pv[0])
                fn = np.cross(e1, e2)
                nrm = np.linalg.norm(fn)
                fn = fn / nrm if nrm > 0 else np.array([0.0, 1.0, 0.0])
                pn = [fn, fn, fn]
            if all(c[1] != 0 for c in tri) and vts:
                pt = [vts[_resolve(c[1], len(vts))] for c in tri]
            else:
                pt = [[0.0, 0.0]] * 3
            tris_v.append(pv)
            tris_n.append(pn)
            tris_t.append(pt)

    return (np.asarray(tris_v, np.float32).reshape(-1, 3, 3),
            np.asarray(tris_n, np.float32).reshape(-1, 3, 3),
            np.asarray(tris_t, np.float32).reshape(-1, 3, 2))


# ---------------------------------------------------------------------------
# BVH build (binned SAH) + skip-pointer flattening
# ---------------------------------------------------------------------------

def _surface(lo: np.ndarray, hi: np.ndarray) -> float:
    d = np.maximum(hi - lo, 0.0)
    return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))


def _partition(tri_lo, tri_hi, centroids, order: np.ndarray):
    """Binned-SAH split of `order` along the widest centroid axis; falls back
    to a median split when the spread is degenerate."""
    n = len(order)
    c = centroids[order]
    c_lo, c_hi = c.min(axis=0), c.max(axis=0)
    axis = int(np.argmax(c_hi - c_lo))
    extent = c_hi[axis] - c_lo[axis]

    best_cost, best = np.inf, None
    if extent > 1e-12:
        rel = (c[:, axis] - c_lo[axis]) / extent
        bins = np.minimum((rel * SAH_BINS).astype(np.int32), SAH_BINS - 1)
        for b in range(1, SAH_BINS):
            left_m = bins < b
            nl = int(left_m.sum())
            if nl == 0 or nl == n:
                continue
            l_ord, r_ord = order[left_m], order[~left_m]
            sa_l = _surface(tri_lo[l_ord].min(0), tri_hi[l_ord].max(0))
            sa_r = _surface(tri_lo[r_ord].min(0), tri_hi[r_ord].max(0))
            cost = sa_l * nl + sa_r * (n - nl)
            if cost < best_cost:
                best_cost, best = cost, (l_ord, r_ord)
    if best is None:
        srt = order[np.argsort(c[:, axis], kind="stable")]
        best = (srt[: n // 2], srt[n // 2:])
    return best


def build_bvh(verts: np.ndarray, leaf_k: int = LEAF_K):
    """Build one mesh's BVH.

    Returns (perm, node_lo, node_hi, node_start, node_count, node_skip,
    node_right) with *local* indices; `perm` reorders the input triangles into
    leaf-contiguous order. Layout: depth-first, left child at parent+1, so a
    traversal descends with `node+1` and escapes with `node_skip`.

    Uses the native C++ builder (same SAH binning + flattening semantics)
    when it is built; `_build_bvh_py` is the fallback and the oracle.
    """
    from ..utils import native
    if native.is_available():
        res = native.build_bvh(verts, leaf_k)
        if res is not None:
            return res
    return _build_bvh_py(verts, leaf_k)


def _build_bvh_py(verts: np.ndarray, leaf_k: int = LEAF_K):
    tri_lo = verts.min(axis=1)
    tri_hi = verts.max(axis=1)
    centroids = (tri_lo + tri_hi) * 0.5

    perm: List[int] = []
    nodes_lo, nodes_hi = [], []
    nodes_start, nodes_count, nodes_skip, nodes_right = [], [], [], []
    EXIT = -2  # true traversal exit; placeholder escapes are -1 until patched

    def patch_skip(sub_root: int, skip: int) -> None:
        """Point every still-unresolved (-1) escape edge in the subtree at
        `skip`. Inner edges were resolved when their sibling was emitted, so
        only the edges exiting this subtree remain -1."""
        stack = [sub_root]
        while stack:
            i = stack.pop()
            if nodes_skip[i] == -1:
                nodes_skip[i] = skip
            if nodes_count[i] == 0 and nodes_right[i] >= 0:
                stack.append(i + 1)
                stack.append(nodes_right[i])

    def flatten(order: np.ndarray, skip: int) -> int:
        idx = len(nodes_lo)
        nodes_lo.append(tri_lo[order].min(axis=0))
        nodes_hi.append(tri_hi[order].max(axis=0))
        nodes_start.append(-1)
        nodes_count.append(0)
        nodes_skip.append(skip)
        nodes_right.append(-1)
        if len(order) <= leaf_k:
            nodes_start[idx] = len(perm)
            nodes_count[idx] = len(order)
            perm.extend(order.tolist())
            return idx
        l_ord, r_ord = _partition(tri_lo, tri_hi, centroids, order)
        left_idx = flatten(l_ord, -1)
        right_idx = flatten(r_ord, skip)
        nodes_right[idx] = right_idx
        patch_skip(left_idx, right_idx)
        return idx

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + verts.shape[0] // 2))
    try:
        flatten(np.arange(verts.shape[0]), EXIT)
    finally:
        sys.setrecursionlimit(old_limit)

    skips = np.asarray(nodes_skip, np.int32)
    skips[skips == EXIT] = -1

    return (np.asarray(perm, np.int64),
            np.asarray(nodes_lo, np.float32),
            np.asarray(nodes_hi, np.float32),
            np.asarray(nodes_start, np.int32),
            np.asarray(nodes_count, np.int32),
            skips,
            np.asarray(nodes_right, np.int32))


# ---------------------------------------------------------------------------
# Bundle assembly
# ---------------------------------------------------------------------------

def build_mesh_bundle(paths: List[str]) -> T.MeshBundle:
    """Load + BVH-build every OBJ in `paths`, concatenated into one bundle.

    Per-mesh node indices and tri starts are rebased to global offsets; each
    mesh's root escape stays -1 (terminates that mesh's traversal).
    """
    all_v, all_n, all_t = [], [], []
    lo_l, hi_l, start_l, count_l, skip_l, right_l = [], [], [], [], [], []
    roots, tri_offsets = [], []
    node_off = 0
    tri_off = 0

    for p in paths:
        verts, norms, uvs = load_obj(p)
        if verts.shape[0] == 0:
            raise ValueError(f"OBJ {p!r} has no triangles")
        perm, lo, hi, start, count, skip, right = build_bvh(verts)
        verts, norms, uvs = verts[perm], norms[perm], uvs[perm]

        roots.append(node_off)
        tri_offsets.append(tri_off)
        lo_l.append(lo)
        hi_l.append(hi)
        start_l.append(np.where(count > 0, start + tri_off, -1))
        count_l.append(count)
        skip_l.append(np.where(skip >= 0, skip + node_off, -1))
        right_l.append(np.where(right >= 0, right + node_off, -1))
        all_v.append(verts)
        all_n.append(norms)
        all_t.append(uvs)
        node_off += lo.shape[0]
        tri_off += verts.shape[0]

    v = np.concatenate(all_v)     # [T,3,3]
    nrm = np.concatenate(all_n)
    uv = np.concatenate(all_t)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32))

    return T.MeshBundle(
        tri_v0=f32(v[:, 0]), tri_e1=f32(e1), tri_e2=f32(e2),
        tri_n0=f32(nrm[:, 0]), tri_n1=f32(nrm[:, 1]), tri_n2=f32(nrm[:, 2]),
        tri_uv0=f32(uv[:, 0]), tri_uv1=f32(uv[:, 1]), tri_uv2=f32(uv[:, 2]),
        node_lo=f32(np.concatenate(lo_l)), node_hi=f32(np.concatenate(hi_l)),
        node_right=i32(np.concatenate(right_l)),
        node_start=i32(np.concatenate(start_l)),
        node_count=i32(np.concatenate(count_l)),
        node_skip=i32(np.concatenate(skip_l)),
        mesh_root=i32(roots), mesh_tri_offset=i32(tri_offsets))
