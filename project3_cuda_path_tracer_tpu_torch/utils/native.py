"""ctypes bindings for the native host-runtime library (native/).

Counterpart of project3_cuda_path_tracer_tpu/utils/native.py (ctypes and
NumPy, no tensors). Every entry point answers `is_available()`, and callers
take the pure-Python implementations (scene/bvh.py) when the library is not
built. The port only uses the OBJ parser and the BVH builder; both return
what the Python versions return.

Build once:  make -C native
"""
from __future__ import annotations

import ctypes as C
import os
from typing import Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "build", "libpt_native.so")

_lib = None


class _ObjResult(C.Structure):
    _fields_ = [("tri_count", C.c_int64),
                ("verts", C.POINTER(C.c_float)),
                ("normals", C.POINTER(C.c_float)),
                ("uvs", C.POINTER(C.c_float))]


class _BvhResult(C.Structure):
    _fields_ = [("node_count", C.c_int64),
                ("perm", C.POINTER(C.c_int64)),
                ("node_lo", C.POINTER(C.c_float)),
                ("node_hi", C.POINTER(C.c_float)),
                ("node_start", C.POINTER(C.c_int32)),
                ("node_count_arr", C.POINTER(C.c_int32)),
                ("node_skip", C.POINTER(C.c_int32)),
                ("node_right", C.POINTER(C.c_int32))]


def _load():
    global _lib
    if _lib is None:
        _lib = False
        if os.path.exists(_LIB_PATH):
            lib = C.CDLL(_LIB_PATH)
            lib.pt_parse_obj.restype = C.POINTER(_ObjResult)
            lib.pt_parse_obj.argtypes = [C.c_char_p]
            lib.pt_free_obj.argtypes = [C.POINTER(_ObjResult)]
            lib.pt_build_bvh.restype = C.POINTER(_BvhResult)
            lib.pt_build_bvh.argtypes = [C.POINTER(C.c_float), C.c_int64,
                                         C.c_int32]
            lib.pt_free_bvh.argtypes = [C.POINTER(_BvhResult)]
            _lib = lib
    return _lib


def is_available() -> bool:
    return bool(_load())


def parse_obj(path: str) -> Optional[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]]:
    """(verts [T,3,3], normals [T,3,3], uvs [T,3,2]) or None if unavailable."""
    lib = _load()
    if not lib:
        return None
    res = lib.pt_parse_obj(path.encode())
    if not res:
        raise FileNotFoundError(path)
    try:
        t = res.contents.tri_count
        v = np.ctypeslib.as_array(res.contents.verts, (t, 3, 3)).copy()
        n = np.ctypeslib.as_array(res.contents.normals, (t, 3, 3)).copy()
        uv = np.ctypeslib.as_array(res.contents.uvs, (t, 3, 2)).copy()
        return v, n, uv
    finally:
        lib.pt_free_obj(res)


def build_bvh(verts: np.ndarray, leaf_k: int):
    """Mirror of scene.bvh.build_bvh; returns the same 7-tuple or None."""
    lib = _load()
    if not lib:
        return None
    v = np.ascontiguousarray(verts, np.float32)
    t = v.shape[0]
    res = lib.pt_build_bvh(v.ctypes.data_as(C.POINTER(C.c_float)), t,
                           leaf_k)
    try:
        nb = res.contents.node_count
        return (
            np.ctypeslib.as_array(res.contents.perm, (t,)).copy(),
            np.ctypeslib.as_array(res.contents.node_lo, (nb, 3)).copy(),
            np.ctypeslib.as_array(res.contents.node_hi, (nb, 3)).copy(),
            np.ctypeslib.as_array(res.contents.node_start, (nb,)).copy(),
            np.ctypeslib.as_array(res.contents.node_count_arr, (nb,)).copy(),
            np.ctypeslib.as_array(res.contents.node_skip, (nb,)).copy(),
            np.ctypeslib.as_array(res.contents.node_right, (nb,)).copy(),
        )
    finally:
        lib.pt_free_bvh(res)
