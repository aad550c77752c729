"""The CIS565 scene grammar, parsed for the plain reference.

It reads the same text the program is given (the configuration's scene
lines with the seed's colours written in) and the same raw OBJ file, and
builds what the reference tracer needs: the material table, each object's
transform and its inverses, the derived camera and the mesh's triangles.
It shares no code with the program.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

CUBE, SPHERE, MESH = "cube", "sphere", "mesh"


@dataclass
class Mesh:
    """Triangles in object space: corners [T,3,3] and corner normals
    [T,3,3], as the OBJ gives them (v/vt/vn faces, fan-triangulated)."""
    corners: np.ndarray
    normals: np.ndarray


@dataclass
class Geom:
    kind: str
    material: int
    transform: np.ndarray          # [4,4] float32, world = M @ [x,y,z,1]
    inverse: np.ndarray            # [4,4] float32
    inverse_transpose: np.ndarray  # [4,4] float32
    mesh: Optional[Mesh] = None


@dataclass
class Scene:
    materials: dict                # name -> float32 array, leading dim M
    geoms: List[Geom]
    camera: dict                   # name -> float32 array or float
    width: int
    height: int
    depth: int


def _rot(axis: int, deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4, dtype=np.float32)
    a, b = [(1, 2), (0, 2), (0, 1)][axis]
    m[a, a], m[b, b] = c, c
    if axis == 1:   # about y: x' = c x + s z
        m[a, b], m[b, a] = s, -s
    else:
        m[a, b], m[b, a] = -s, s
    return m


def transform(trans, rot, scale) -> np.ndarray:
    """translate @ Rx @ Ry @ Rz @ scale (utilities.cpp's order), float32."""
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = np.asarray(trans, np.float32)
    s = np.eye(4, dtype=np.float32)
    s[0, 0], s[1, 1], s[2, 2] = np.asarray(scale, np.float32)
    r = _rot(0, rot[0]) @ _rot(1, rot[1]) @ _rot(2, rot[2])
    return (t @ r @ s).astype(np.float32)


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v)).astype(np.float32)


def load_obj(path: str) -> Mesh:
    """v / vn / f lines; a face without normals takes its face normal."""
    vs, vns, faces = [], [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                vs.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vn":
                vns.append([float(x) for x in tok[1:4]])
            elif tok[0] == "f":
                corners = []
                for c in tok[1:]:
                    parts = c.split("/")
                    n = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    corners.append((int(parts[0]), n))
                for k in range(1, len(corners) - 1):
                    faces.append((corners[0], corners[k], corners[k + 1]))
    v = np.asarray(vs, np.float32)
    vn = np.asarray(vns, np.float32) if vns else np.zeros((0, 3), np.float32)

    def at(table, i):
        return table[i - 1 if i > 0 else len(table) + i]

    corners = np.stack([[at(v, c[0]) for c in f] for f in faces])
    normals = np.empty_like(corners)
    for i, f in enumerate(faces):
        if all(c[1] != 0 for c in f) and len(vn):
            normals[i] = [at(vn, c[1]) for c in f]
        else:
            fn = np.cross(corners[i, 1] - corners[i, 0],
                          corners[i, 2] - corners[i, 0]).astype(np.float64)
            ln = np.linalg.norm(fn)
            normals[i] = fn / ln if ln > 0 else (0.0, 1.0, 0.0)
    return Mesh(corners=corners.astype(np.float32),
                normals=normals.astype(np.float32))


def _blocks(lines):
    """(header tokens, [token rows]) for every block: a header line, then
    rows up to a blank line; comments are skipped."""
    i, n = 0, len(lines)
    while i < n:
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("//"):
            continue
        head = line.split()
        rows = []
        while i < n and lines[i].strip():
            if not lines[i].strip().startswith("//"):
                rows.append(lines[i].split())
            i += 1
        yield head, rows


def parse(text: str, base_dir: str) -> Scene:
    mats, geoms = [], []
    cam = None
    for head, rows in _blocks(text.splitlines()):
        kw = head[0]
        if kw == "MATERIAL":
            m = dict(RGB=(0.0,) * 3, SPECEX=0.0, SPECRGB=(0.0,) * 3,
                     REFL=0.0, REFR=0.0, REFRIOR=0.0, EMITTANCE=0.0)
            for r in rows:
                vals = [float(x) for x in r[1:]]
                m[r[0]] = tuple(vals) if len(vals) == 3 else vals[0]
            mats.append(m)
        elif kw == "OBJECT":
            kind_row, rows = rows[0], rows[1:]
            g = dict(kind=kind_row[0], mesh=None, material=0,
                     TRANS=(0, 0, 0), ROTAT=(0, 0, 0), SCALE=(1, 1, 1))
            if g["kind"] == MESH:
                g["mesh"] = load_obj(os.path.join(base_dir, kind_row[1]))
            for r in rows:
                if r[0] == "material":
                    g["material"] = int(r[1])
                else:
                    g[r[0]] = tuple(float(x) for x in r[1:4])
            if g["kind"] not in (CUBE, SPHERE, MESH):
                raise ValueError(f"unsupported object {g['kind']!r}")
            m = transform(g["TRANS"], g["ROTAT"], g["SCALE"])
            inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
            geoms.append(Geom(kind=g["kind"], material=g["material"],
                              transform=m, inverse=inv,
                              inverse_transpose=np.ascontiguousarray(inv.T),
                              mesh=g["mesh"]))
        elif kw == "CAMERA":
            cam = {r[0]: r[1:] for r in rows}
    if cam is None:
        raise ValueError("scene has no CAMERA")
    w, h = (int(x) for x in cam["RES"])
    fovy = float(cam.get("FOVY", ["45"])[0])
    eye = np.asarray([float(x) for x in cam["EYE"]], np.float32)
    look = np.asarray([float(x) for x in cam["LOOKAT"]], np.float32)
    up = np.asarray([float(x) for x in cam["UP"]], np.float32)
    yscaled = math.tan(fovy * math.pi / 180.0)
    xscaled = yscaled * w / h
    view = _unit(look - eye)
    right = _unit(np.cross(view, up))
    up = _unit(np.cross(right, view))
    camera = dict(
        position=eye, view=view, up=up, right=right,
        pixel_length=np.asarray([2.0 * xscaled / w, 2.0 * yscaled / h],
                                np.float32),
        aperture=np.float32(float(cam.get("APERTURE", ["0"])[0])),
        focal_distance=np.float32(float(cam.get("FOCAL", ["0"])[0])),
        shutter=np.float32(float(cam.get("SHUTTER", ["0"])[0])))

    def col(key, three=False):
        return np.asarray([m[key] for m in mats], np.float32).reshape(
            (len(mats), 3) if three else (len(mats),))

    materials = dict(color=col("RGB", True), specular_exponent=col("SPECEX"),
                     specular_color=col("SPECRGB", True),
                     has_reflective=col("REFL"), has_refractive=col("REFR"),
                     ior=col("REFRIOR"), emittance=col("EMITTANCE"))
    return Scene(materials=materials, geoms=geoms, camera=camera, width=w,
                 height=h, depth=int(cam.get("DEPTH", ["8"])[0]))
