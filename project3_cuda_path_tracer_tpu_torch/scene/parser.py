"""Scene-file parser for the reference's text grammar.

Counterpart of project3_cuda_path_tracer_tpu/scene/parser.py (reference:
src/scene.cpp):
  MATERIAL n  -> RGB/SPECEX/SPECRGB/REFL/REFR/REFRIOR/EMITTANCE, DISPERSION
  CAMERA      -> RES/FOVY/ITERATIONS/DEPTH/FILE, EYE/LOOKAT/UP,
                 APERTURE/FOCAL (thin lens), SHUTTER (motion blur)
                 TEXTURE <path>, CHECKER s r2 g2 b2, NORMALMAP <path.png>,
                 BUMP scale freq
  OBJECT n    -> `cube` | `sphere` | `mesh <path.obj>` | `sdf <kind>`,
                 `material k`, TRANS/ROTAT/SCALE, VELOC; an SDF's PARAMS
                 (up to 20 numbers; a metaball's ball count follows from
                 them) and its CSG sub-shapes `A`/`B` (`sphere cx cy cz r`
                 or `box cx cy cz hx hy hz`)
  top level   -> ENVMAP <path.hdr|.png>, ENVSKY (13 numbers: zenith rgb,
                 horizon rgb, sun dir xyz, sun rgb, sun sharpness)
IDs must be sequential; blocks end at a blank line. The tables are built in
NumPy first (the same float32 arithmetic as the JAX parser), then wrapped as
tensors. Mesh, texture and env paths resolve relative to the scene file;
each OBJ is loaded once (deduplicated by path), its BVH built
(scene/bvh.py) and packed in the 8-wide layout of the traversal kernel
(ops/bvh8.pack_all8). The images go into one vertical-strip atlas with
their packed 32-bit planes (`_load_textures`, under the span
`scene.textures`, utils/profiling.py). SDF objects fill
Geoms.sdf_params and Scene.sdf_kinds (ops/sdf.py).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..ops import sdf as S
from ..ops.bvh8 import pack_all8
from ..utils import image as img_io
from ..utils import math as m
from ..utils.profiling import span
from . import types as T
from .bvh import build_mesh_bundle


class SceneParseError(ValueError):
    pass


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
    envmap_path: Optional[str] = None
    envsky: Optional[list] = None

    while not cur.eof():
        line = cur.next()
        if _is_blank(line) or _is_comment(line):
            continue
        tok = line.split()
        kw = tok[0]
        if kw == "MATERIAL":
            mid = int(tok[1])
            if mid != len(mats):
                raise SceneParseError(
                    f"MATERIAL ID {mid} does not match expected {len(mats)}")
            mat = dict(color=(0, 0, 0), specex=0.0, speccol=(0, 0, 0),
                       refl=0.0, refr=0.0, ior=0.0, emittance=0.0,
                       texture=None, checker=None, normalmap=None,
                       bump=None, disp=0.0)
            for row in cur.block():
                k = row[0]
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
                elif k == "TEXTURE":
                    mat["texture"] = os.path.join(base, row[1])
                elif k == "CHECKER":
                    mat["checker"] = [float(v) for v in row[1:5]]
                elif k == "NORMALMAP":
                    mat["normalmap"] = os.path.join(base, row[1])
                elif k == "BUMP":
                    mat["bump"] = (float(row[1]), float(row[2]))
            mats.append(mat)
        elif kw == "OBJECT":
            gid = int(tok[1])
            if gid != len(geoms):
                raise SceneParseError(
                    f"OBJECT ID {gid} does not match expected {len(geoms)}")
            g = dict(type=None, mesh_path=None, material=0, trans=(0, 0, 0),
                     rotat=(0, 0, 0), scale=(1, 1, 1), veloc=(0, 0, 0),
                     sdf_kind=(-1, -1, -1), sdf_params=None)
            tline = cur.next()
            while _is_comment(tline):
                tline = cur.next()
            trow = tline.split()
            tname = trow[0]
            if tname == "sphere":
                g["type"] = T.SPHERE
            elif tname == "cube":
                g["type"] = T.CUBE
            elif tname == "mesh":
                g["type"] = T.MESH
                g["mesh_path"] = os.path.join(base, trow[1])
            elif tname == "sdf":
                if len(trow) < 2 or trow[1] not in S.KINDS:
                    raise SceneParseError(
                        f"sdf needs a kind in {sorted(S.KINDS)}")
                g["type"] = T.SDF
                g["sdf_kind"] = (S.KINDS[trow[1]], -1, -1)
                g["sdf_params"] = [0.0] * S.PARAM_SLOTS
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
                elif k == "PARAMS" and g["type"] == T.SDF:
                    vals = [float(v) for v in row[1:S.PARAM_SLOTS + 1]]
                    g["sdf_params"][:len(vals)] = vals
                    if g["sdf_kind"][0] == S.METABALL:
                        # k, then (x y z r) a ball; the ball count is aux_a
                        nballs = max(1, min((len(vals) - 1) // 4,
                                            S.MAX_BALLS))
                        g["sdf_kind"] = (S.METABALL, nballs, -1)
                elif k in ("A", "B") and g["type"] == T.SDF:
                    if row[1] not in S.SUB_SHAPES:
                        raise SceneParseError("CSG sub-shape must be "
                                              f"sphere|box, got {row[1]!r}")
                    vals = [float(v) for v in row[2:10]]
                    off = 0 if k == "A" else 8
                    g["sdf_params"][off:off + len(vals)] = vals
                    kd, a, b = g["sdf_kind"]
                    sub = S.SUB_SHAPES[row[1]]
                    g["sdf_kind"] = (kd, sub, b) if k == "A" else (kd, a, sub)
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
        elif kw == "ENVMAP":
            envmap_path = os.path.join(base, tok[1])
        elif kw == "ENVSKY":
            envsky = [float(v) for v in tok[1:14]]

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
    has_sdf = any(g["type"] == T.SDF for g in geoms)
    if has_sdf:
        geom_tables["sdf_params"] = np.array(
            [g["sdf_params"] or [0.0] * S.PARAM_SLOTS for g in geoms],
            np.float32)

    meshes, packed = T.MeshBundle.empty(), ()
    if mesh_paths:
        meshes = build_mesh_bundle(mesh_paths)
        packed = pack_all8(meshes)
    with span("scene.textures"):
        textures = _load_textures(mats, envmap_path, envsky)

    return T.Scene(
        camera=cam, settings=settings,
        materials=T.Materials(**{k: torch.from_numpy(v)
                                 for k, v in materials.items()}),
        geoms=T.Geoms(**{k: torch.from_numpy(v)
                         for k, v in geom_tables.items()}),
        meshes=meshes, packed_meshes=packed,
        sdf_kinds=(tuple(g["sdf_kind"] for g in geoms) if has_sdf else ()),
        textures=textures,
        source_path=os.path.abspath(path))


def _unpack_rgb8(p: np.ndarray) -> np.ndarray:
    b = np.stack([(p & 0xFF), (p >> 8) & 0xFF, (p >> 16) & 0xFF], -1)
    return b.astype(np.float32) / 255.0


def _unpack_rgbe(p: np.ndarray) -> np.ndarray:
    """The shader's decode (ops/wavefront._unpack_rgbe), with its clamped
    power of two, so that the guard refuses any asset the shader could not
    reproduce exactly."""
    e = ((p >> 24) & 0xFF).astype(np.int32)
    s = np.where(e > 0, np.exp2(np.clip(e - 9, 1, 254) - 127.0),
                 0.0).astype(np.float32)
    mant = np.stack([(p & 0xFF), (p >> 8) & 0xFF, (p >> 16) & 0xFF], -1)
    return (mant.astype(np.float32) + 0.5) * s[..., None]


def _packed_or_none(img: np.ndarray, pack, unpack) -> Optional[torch.Tensor]:
    """The packed plane of `img` as int32 bits, only when it decodes back
    to the float32 plane bit for bit (PNG-sourced LDR, HDR-sourced RGBE);
    else None, and the shader takes the three-take float32 form."""
    p = pack(img)
    if np.array_equal(unpack(p).reshape(img.shape), img):
        return torch.from_numpy(p.astype(np.uint32).view(np.int32))
    return None


def _load_textures(mats: List[dict], envmap_path: Optional[str],
                   envsky: Optional[list]) -> T.Textures:
    """The scene's Textures (the JAX `_load_textures`): the checker, bump
    and sky tables; the images of TEXTURE and NORMALMAP, each read once,
    stacked top to bottom into one atlas as wide as the widest, with each
    material's rect (x, y, w, h) into it; the env map; and the packed
    planes that pass the round-trip guard (`_packed_or_none`)."""
    m_count = max(len(mats), 1)
    checker_scale = np.zeros((m_count,), np.float32)
    checker_c2 = np.zeros((m_count, 3), np.float32)
    bump = np.zeros((m_count, 2), np.float32)
    for i, mt in enumerate(mats):
        if mt["checker"]:
            checker_scale[i] = mt["checker"][0]
            checker_c2[i] = mt["checker"][1:4]
        if mt["bump"]:
            bump[i] = mt["bump"]
    sky = np.zeros((14,), np.float32)
    if envsky is not None:
        sky[0] = 1.0
        sky[1:1 + len(envsky)] = envsky
    base = dict(checker_scale=torch.from_numpy(checker_scale),
                checker_color2=torch.from_numpy(checker_c2),
                sky=torch.from_numpy(sky), bump=torch.from_numpy(bump))

    tex_paths = [mt["texture"] for mt in mats]
    nrm_paths = [mt["normalmap"] for mt in mats]
    imgs = {}
    for p in tex_paths + nrm_paths:
        if p is not None and p not in imgs:
            imgs[p] = img_io.read_image(p)
    if not imgs and envmap_path is None:
        tx = T.Textures.none(len(mats))
        for k, v in base.items():
            setattr(tx, k, v)
        return tx

    offsets = {}
    if imgs:
        wa = max(im.shape[1] for im in imgs.values())
        ha = sum(im.shape[0] for im in imgs.values())
        atlas = np.zeros((ha, wa, 3), np.float32)
        y = 0
        for p, im in imgs.items():
            atlas[y:y + im.shape[0], :im.shape[1]] = im
            offsets[p] = (0, y, im.shape[1], im.shape[0])
            y += im.shape[0]
    else:
        atlas = np.zeros((1, 1, 3), np.float32)

    def table(paths):
        rect = np.zeros((len(mats), 4), np.int32)
        ids = -np.ones((len(mats),), np.int32)
        for i, p in enumerate(paths):
            if p is not None:
                rect[i] = offsets[p]
                ids[i] = 0
        return torch.from_numpy(rect), torch.from_numpy(ids)
    rect, tex_id = table(tex_paths)
    nrm_rect, nrm_id = table(nrm_paths)
    if envmap_path is not None:
        env, env_enabled = img_io.read_image(envmap_path), 1.0
    else:
        env, env_enabled = np.zeros((1, 1, 3), np.float32), 0.0
    # atlas_pair and env_pair (--bilinear-fast) are built at first use
    # (render/integrator.build_trace_config), as in the JAX package
    return T.Textures(
        atlas=torch.from_numpy(atlas), rect=rect, tex_id=tex_id,
        env=torch.from_numpy(env),
        env_enabled=torch.tensor(env_enabled, dtype=T.F32),
        nrm_rect=nrm_rect, nrm_id=nrm_id,
        atlas_packed=_packed_or_none(atlas, img_io.pack_rgb8, _unpack_rgb8),
        env_packed=_packed_or_none(env, img_io.pack_rgbe, _unpack_rgbe),
        **base)


def build_atlas_pair(textures: T.Textures) -> Optional[torch.Tensor]:
    """The RGB565 horizontal-pair plane of --bilinear-fast (the JAX
    `build_atlas_pair`): entry (y, x) packs texel (y, x) in the low 16 bits
    and its right neighbour in the high 16, the neighbour clamped inside
    the texel's own strip image (every image's rect appears in rect or
    nrm_rect). A [Ha*Wa] int32 plane of the bits, or None for a scene
    without an atlas."""
    atlas = textures.atlas.cpu().numpy()
    if atlas.shape[0] == 1 and atlas.shape[1] == 1:
        return None
    rects = set()
    for rect_t, id_t in ((textures.rect, textures.tex_id),
                         (textures.nrm_rect, textures.nrm_id)):
        rect_n, id_n = rect_t.cpu().numpy(), id_t.cpu().numpy()
        for i in np.nonzero(id_n >= 0)[0]:
            rects.add(tuple(int(v) for v in rect_n[i]))
    pair = np.zeros(atlas.shape[:2], np.uint32)
    for (x0, y0, w, h) in rects:
        pair[y0:y0 + h, x0:x0 + w] = img_io.pack_565_pair(
            atlas[y0:y0 + h, x0:x0 + w])
    return torch.from_numpy(pair.reshape(-1).view(np.int32))
