"""Scene-file parser for the reference's text grammar.

Counterpart of project3_cuda_path_tracer_tpu/scene/parser.py (reference:
src/scene.cpp):
  MATERIAL n  -> RGB/SPECEX/SPECRGB/REFL/REFR/REFRIOR/EMITTANCE, DISPERSION
  CAMERA      -> RES/FOVY/ITERATIONS/DEPTH/FILE, EYE/LOOKAT/UP,
                 APERTURE/FOCAL (thin lens), SHUTTER (motion blur)
  OBJECT n    -> `cube` | `sphere` | `mesh <path.obj>`, `material k`,
                 TRANS/ROTAT/SCALE, VELOC
IDs must be sequential; blocks end at a blank line. The tables are built in
NumPy first (the same float32 arithmetic as the JAX parser), then wrapped as
tensors. Mesh paths resolve relative to the scene file; each OBJ is loaded
once (deduplicated by path), its BVH built (scene/bvh.py) and packed in the
8-wide layout of the traversal kernel (ops/bvh8.pack_all8). Keywords of
slices not ported yet raise NotImplementedError naming the slice
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..ops.bvh8 import pack_all8
from ..utils import math as m
from . import types as T
from .bvh import build_mesh_bundle

_TEXTURE_SLICE = "slice D (textures and environment)"
# keyword -> the ROADMAP slice that ports it
_UNPORTED = {
    "TEXTURE": _TEXTURE_SLICE, "CHECKER": _TEXTURE_SLICE,
    "NORMALMAP": _TEXTURE_SLICE, "BUMP": _TEXTURE_SLICE,
    "ENVMAP": _TEXTURE_SLICE, "ENVSKY": _TEXTURE_SLICE,
    "sdf": "slice E (SDF primitives)",
}


class SceneParseError(ValueError):
    pass


def _unported(keyword: str, path: str):
    return NotImplementedError(
        f"{path}: {keyword!r} is not ported to the torch package yet "
        f"(ROADMAP.md Queue 1, {_UNPORTED[keyword]}); render this scene with "
        f"project3_cuda_path_tracer_tpu")


def _is_blank(line: str) -> bool:
    return len(line.strip()) == 0


def _is_comment(line: str) -> bool:
    return line.lstrip().startswith("//")


class _Cursor:
    def __init__(self, lines: List[str]):
        self.lines = lines
        self.i = 0

    def eof(self) -> bool:
        return self.i >= len(self.lines)

    def next(self) -> str:
        line = self.lines[self.i]
        self.i += 1
        return line

    def block(self) -> List[List[str]]:
        """Token rows until a blank line or EOF (comments skipped)."""
        rows = []
        while not self.eof() and not _is_blank(self.lines[self.i]):
            line = self.next()
            if not _is_comment(line):
                rows.append(line.split())
        return rows


def _vec3(row) -> tuple:
    return tuple(float(v) for v in row[1:4])


def load_scene(path: str) -> T.Scene:
    with open(path, "r") as f:
        cur = _Cursor([ln.rstrip("\r\n") for ln in f])

    base = os.path.dirname(os.path.abspath(path))
    mats: List[dict] = []
    geoms: List[dict] = []
    cam: Optional[T.Camera] = None
    settings = T.RenderSettings()

    while not cur.eof():
        line = cur.next()
        if _is_blank(line) or _is_comment(line):
            continue
        tok = line.split()
        kw = tok[0]
        if kw in _UNPORTED:
            raise _unported(kw, path)
        if kw == "MATERIAL":
            mid = int(tok[1])
            if mid != len(mats):
                raise SceneParseError(
                    f"MATERIAL ID {mid} does not match expected {len(mats)}")
            mat = dict(color=(0, 0, 0), specex=0.0, speccol=(0, 0, 0),
                       refl=0.0, refr=0.0, ior=0.0, emittance=0.0, disp=0.0)
            for row in cur.block():
                k = row[0]
                if k in _UNPORTED:
                    raise _unported(k, path)
                if k == "RGB":
                    mat["color"] = _vec3(row)
                elif k == "SPECEX":
                    mat["specex"] = float(row[1])
                elif k == "SPECRGB":
                    mat["speccol"] = _vec3(row)
                elif k == "REFL":
                    mat["refl"] = float(row[1])
                elif k == "REFR":
                    mat["refr"] = float(row[1])
                elif k == "REFRIOR":
                    mat["ior"] = float(row[1])
                elif k == "EMITTANCE":
                    mat["emittance"] = float(row[1])
                elif k == "DISPERSION":
                    mat["disp"] = float(row[1])
            mats.append(mat)
        elif kw == "OBJECT":
            gid = int(tok[1])
            if gid != len(geoms):
                raise SceneParseError(
                    f"OBJECT ID {gid} does not match expected {len(geoms)}")
            g = dict(type=None, mesh_path=None, material=0, trans=(0, 0, 0),
                     rotat=(0, 0, 0), scale=(1, 1, 1), veloc=(0, 0, 0))
            tline = cur.next()
            while _is_comment(tline):
                tline = cur.next()
            trow = tline.split()
            tname = trow[0]
            if tname in _UNPORTED:
                raise _unported(tname, path)
            if tname == "sphere":
                g["type"] = T.SPHERE
            elif tname == "cube":
                g["type"] = T.CUBE
            elif tname == "mesh":
                g["type"] = T.MESH
                g["mesh_path"] = os.path.join(base, trow[1])
            else:
                raise SceneParseError(f"unknown OBJECT type {tname!r}")
            for row in cur.block():
                k = row[0]
                if k == "material":
                    g["material"] = int(row[1])
                elif k == "TRANS":
                    g["trans"] = _vec3(row)
                elif k == "ROTAT":
                    g["rotat"] = _vec3(row)
                elif k == "SCALE":
                    g["scale"] = _vec3(row)
                elif k == "VELOC":
                    g["veloc"] = _vec3(row)
            geoms.append(g)
        elif kw == "CAMERA":
            res, fovy = (800, 800), 45.0
            eye, look, up = (0.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0)
            aperture = focal = shutter = 0.0
            for row in cur.block():
                k = row[0]
                if k == "RES":
                    res = (int(row[1]), int(row[2]))
                elif k == "FOVY":
                    fovy = float(row[1])
                elif k == "ITERATIONS":
                    settings.iterations = int(row[1])
                elif k == "DEPTH":
                    settings.trace_depth = int(row[1])
                elif k == "FILE":
                    settings.image_name = row[1]
                elif k == "EYE":
                    eye = _vec3(row)
                elif k == "LOOKAT":
                    look = _vec3(row)
                elif k == "UP":
                    up = _vec3(row)
                elif k == "APERTURE":
                    aperture = float(row[1])
                elif k == "FOCAL":
                    focal = float(row[1])
                elif k == "SHUTTER":
                    shutter = float(row[1])
            cam = T.Camera(
                resolution=res,
                position=np.array(eye, np.float32),
                look_at=np.array(look, np.float32),
                up=np.array(up, np.float32),
                fovy=fovy, aperture=aperture, focal_distance=focal,
                shutter=shutter,
            ).derive()

    if cam is None:
        raise SceneParseError("scene has no CAMERA block")
    if not mats:
        raise SceneParseError("scene has no materials")

    def f32(key, rows):
        return np.array([r[key] for r in rows], np.float32)

    materials = dict(
        color=f32("color", mats), specular_exponent=f32("specex", mats),
        specular_color=f32("speccol", mats), has_reflective=f32("refl", mats),
        has_refractive=f32("refr", mats), ior=f32("ior", mats),
        emittance=f32("emittance", mats), dispersion=f32("disp", mats))

    if geoms:
        xf = np.stack([m.build_transformation_matrix(g["trans"], g["rotat"],
                                                      g["scale"])
                       for g in geoms])
        inv = np.stack([m.inverse(t) for t in xf])
        invt = np.stack([m.inverse_transpose(t) for t in xf])
    else:
        xf = inv = invt = np.zeros((0, 4, 4), np.float32)
    # meshes referenced by OBJECTs, deduplicated by path
    mesh_paths: List[str] = []
    mesh_ids = []
    for g in geoms:
        if g["type"] == T.MESH:
            if g["mesh_path"] not in mesh_paths:
                mesh_paths.append(g["mesh_path"])
            mesh_ids.append(mesh_paths.index(g["mesh_path"]))
        else:
            mesh_ids.append(-1)
    geom_tables = dict(
        type=np.array([g["type"] for g in geoms], np.int32),
        material_id=np.array([g["material"] for g in geoms], np.int32),
        transform=xf, inverse_transform=inv, inverse_transpose=invt,
        velocity=np.array([g["veloc"] for g in geoms],
                          np.float32).reshape(-1, 3),
        mesh_id=np.array(mesh_ids, np.int32))

    meshes, packed = T.MeshBundle.empty(), ()
    if mesh_paths:
        meshes = build_mesh_bundle(mesh_paths)
        packed = pack_all8(meshes)

    return T.Scene(
        camera=cam, settings=settings,
        materials=T.Materials(**{k: torch.from_numpy(v)
                                 for k, v in materials.items()}),
        geoms=T.Geoms(**{k: torch.from_numpy(v)
                         for k, v in geom_tables.items()}),
        meshes=meshes, packed_meshes=packed,
        source_path=os.path.abspath(path))
