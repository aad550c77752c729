"""The plain reference of textured_env's features: textured albedo, an
equirect HDR environment that misses collect, Fresnel glass and the thin
lens, on top of reference/scene.py and reference/tracer.py.

What those files already get right is imported: the scene grammar (`parse`
takes the text once TEXTURE and ENVMAP are lifted out), the lattice draws,
`camera_rays` (here with the thin lens), the cube's and the sphere's tests
and the transforms. This file adds the rest: the two image formats (the
PNG through PIL, the Radiance .hdr through its own plain RLE decoder), the
OBJ's `vt` rows, a hit's uv by the program's conventions (a cube face
parameterised by two object axes, a sphere by longitude and latitude, a
triangle by its barycentric mix of the corners' uvs), the nearest texel of
a material's image and of the equirect sky, and the refractive lobe with
Schlick's Fresnel term, which consumes each bounce's draws in the
program's order (u_lobe, u1, u2, u_fresnel).

Departures from the program, each noted:
- Each material reads its own image; the program stacks every image into
  one atlas and every fetch, atlas or sky, through one table (P1). The
  texel chosen is the same: the program's rect arithmetic reduces to this
  image's own row and column.
- Nearest filtering only; a scene with CHECKER, BUMP, NORMALMAP, ENVSKY,
  a glossy lobe (SPECEX > 0) or DISPERSION raises, as does direct lighting
  (there is no `nee`).
- The mesh is tested by brute force (as reference/tracer.py does), not by
  the BVH; a tie between two triangles at the same distance goes to the
  lower index, where the traversal keeps the first it reached.
- Longitudes (atan2) are computed in float64 and rounded, as the program
  does on the CPU; on the card the program's float32 atan2 can differ in
  the last bit and so, at a texel's edge, pick its neighbour.

It imports nothing of the program and nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import numpy as np
import torch

from . import scene as RS
from . import tracer as R
from .tracer import RAY_EPS, dot, fma, maximum, normalize

F32 = torch.float32
UNSUPPORTED = ("CHECKER", "BUMP", "NORMALMAP", "ENVSKY", "DISPERSION")
REF_BLOCK = 1 << 20      # lanes a call of `trace` takes in `retrace`


@dataclasses.dataclass
class TexScene:
    """A parsed scene with its images: `textures[m]` the [H,W,3] float32
    image of material m or None, `env` the equirect sky or None, and
    `uvs[g]` the [T,3,2] corner uvs of mesh geom g (None for the
    primitives)."""
    scene: RS.Scene
    textures: List[Optional[np.ndarray]]
    env: Optional[np.ndarray]
    uvs: List[Optional[np.ndarray]]


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB image as float32 byte / 255."""
    from PIL import Image
    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), np.uint8)
    return rgb.astype(np.float32) / 255.0


def read_hdr(path: str) -> np.ndarray:
    """A Radiance RGBE image (flat or run-length scanlines, rows from the
    top) as float32 (mantissa + 0.5) * 2^(exponent - 136), 0 where the
    exponent byte is 0."""
    with open(path, "rb") as f:
        data = f.read()
    pos = data.index(b"\n\n") + 2          # the header ends at a blank line
    eol = data.index(b"\n", pos)
    _, h, _, w = data[pos:eol].split()     # "-Y <h> +X <w>"
    h, w = int(h), int(w)
    pos = eol + 1
    rgbe = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if data[pos:pos + 2] == b"\x02\x02" and \
                (data[pos + 2] << 8 | data[pos + 3]) == w:
            pos += 4
            for ch in range(4):            # each channel run-length coded
                x = 0
                while x < w:
                    n = data[pos]
                    if n > 128:            # a run of one byte
                        n -= 128
                        rgbe[y, x:x + n, ch] = data[pos + 1]
                        pos += 2
                    else:                  # n literal bytes
                        rgbe[y, x:x + n, ch] = np.frombuffer(
                            data, np.uint8, n, pos + 1)
                        pos += 1 + n
                    x += n
        else:
            rgbe[y] = np.frombuffer(data, np.uint8, 4 * w, pos).reshape(w, 4)
            pos += 4 * w
    e = rgbe[..., 3].astype(np.int64)
    m = rgbe[..., :3].astype(np.float64) + 0.5
    return np.where(e[..., None] > 0, np.ldexp(m, (e - 136)[..., None]),
                    0.0).astype(np.float32)


def load_uvs(path: str) -> np.ndarray:
    """The OBJ's corner uvs [T,3,2], fan-triangulated in reference/scene.py's
    order; a triangle whose corners do not all name a `vt` gets (0, 0)."""
    vts, faces = [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "vt":
                vts.append([float(tok[1]), float(tok[2])])
            elif tok[0] == "f":
                ids = []
                for c in tok[1:]:
                    parts = c.split("/")
                    ids.append(int(parts[1]) if len(parts) > 1 and parts[1]
                               else 0)
                for k in range(1, len(ids) - 1):
                    faces.append((ids[0], ids[k], ids[k + 1]))
    uv = np.zeros((len(faces), 3, 2), np.float32)
    for i, tri in enumerate(faces):
        if vts and all(t != 0 for t in tri):
            uv[i] = [vts[t - 1 if t > 0 else len(vts) + t] for t in tri]
    return uv


def parse(text: str, base_dir: str) -> TexScene:
    """The scene with TEXTURE rows and the ENVMAP line read here (paths
    relative to `base_dir`) and the rest handed to reference/scene.parse."""
    kept, tex_paths, mesh_paths = [], [], []
    env_path, block = None, None
    for line in text.splitlines():
        tok = line.split()
        if not tok:
            block = None
        elif tok[0] in UNSUPPORTED:
            raise ValueError(f"the reference has no {tok[0]}")
        elif tok[0] == "ENVMAP":
            env_path = os.path.join(base_dir, tok[1])
            continue
        elif tok[0] in ("MATERIAL", "OBJECT", "CAMERA"):
            block = tok[0]
            if block == "MATERIAL":
                tex_paths.append(None)
        elif block == "MATERIAL" and tok[0] == "TEXTURE":
            tex_paths[-1] = os.path.join(base_dir, tok[1])
            continue
        elif block == "OBJECT" and tok[0] == "mesh":
            mesh_paths.append(os.path.join(base_dir, tok[1]))
        kept.append(line)
    sc = RS.parse("\n".join(kept), base_dir)
    images = {p: read_png(p) for p in set(tex_paths) if p is not None}
    meshes = iter(mesh_paths)
    return TexScene(
        scene=sc, textures=[images.get(p) for p in tex_paths],
        env=read_hdr(env_path) if env_path else None,
        uvs=[load_uvs(next(meshes)) if g.kind == RS.MESH else None
             for g in sc.geoms])


def load(path: str) -> TexScene:
    with open(path) as f:
        return parse(f.read(), os.path.dirname(path))


class Tables:
    """The scene as tensors of one dtype on one device (float32, or
    bfloat16 for the control); every float32 product exact (no TF32)."""

    def __init__(self, ts: TexScene, device, dtype=F32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sc = ts.scene
        self.scene, self.dev, self.dt = sc, torch.device(device), dtype
        if (np.asarray(sc.materials["specular_exponent"]) > 0).any():
            raise ValueError("the reference has no glossy lobe")

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.dev).to(dtype)
        self.materials = {k: t(v) for k, v in sc.materials.items()}
        self.camera = {k: t(v) for k, v in sc.camera.items()}
        self.textures = [None if im is None else t(im) for im in ts.textures]
        self.env = None if ts.env is None else t(ts.env)
        self.geoms = []
        for g, uv in zip(sc.geoms, ts.uvs):
            rec = dict(kind=g.kind, mat=g.material, M=t(g.transform),
                       inv=t(g.inverse), invt=t(g.inverse_transpose))
            if g.kind == RS.MESH:
                c, n = g.mesh.corners, g.mesh.normals
                rec.update(v0=t(c[:, 0]), e1=t(c[:, 1] - c[:, 0]),
                           e2=t(c[:, 2] - c[:, 0]), n0=t(n[:, 0]),
                           n1=t(n[:, 1]), n2=t(n[:, 2]), uv0=t(uv[:, 0]),
                           uv1=t(uv[:, 1]), uv2=t(uv[:, 2]),
                           lo=t(c.reshape(-1, 3).min(0) - 1e-4),
                           hi=t(c.reshape(-1, 3).max(0) + 1e-4))
            self.geoms.append(rec)

    def textured(self, mat: torch.Tensor) -> torch.Tensor:
        """Whether each lane's material has an image."""
        out = torch.zeros_like(mat, dtype=torch.bool)
        for m, im in enumerate(self.textures):
            if im is not None:
                out |= mat == m
        return out


# ---------------------------------------------------------------------------
# intersection with uv
# ---------------------------------------------------------------------------

def _atan2(y, x):
    return torch.atan2(y.double(), x.double()).to(y.dtype)


def _primitive(g, o, d):
    """A cube or sphere against every lane (reference/tracer.py's tests):
    (t, normal, backed-off point, exact surface point, outside, u, v)."""
    qo = R.xform_pt(g["inv"], o)
    qd = normalize(R.xform_dir(g["inv"], d))
    if g["kind"] == RS.CUBE:
        t_obj, hit, outside, n_local = R._box(qo, qd)
    else:
        t_obj, hit, outside = R._sphere(qo, qd)
    ip = fma((t_obj - RAY_EPS)[:, None], qd, qo)
    sf = fma(t_obj[:, None], qd, qo)
    if g["kind"] == RS.CUBE:
        # the x faces run u along object y, the others along object x; the
        # z faces run v along object y, the others along object z
        u = torch.where(n_local[:, 0] != 0, ip[:, 1], ip[:, 0]) + 0.5
        v = torch.where(n_local[:, 2] != 0, ip[:, 1], ip[:, 2]) + 0.5
    else:
        flip = torch.where(outside, 1.0, -1.0).to(qd.dtype)
        n_local = ip * flip[:, None]
        u = 0.5 + _atan2(ip[:, 2], ip[:, 0]) / (2 * math.pi)
        v = 0.5 + torch.asin(torch.clamp(ip[:, 1] / 0.5, -1.0 + 1e-7,
                                         1.0 - 1e-7)) / math.pi
    point = R.xform_pt(g["M"], ip)
    surf = R.xform_pt(g["M"], sf)
    normal = normalize(R.xform_dir(g["invt"], n_local))
    t = torch.where(hit, dot(o - point, o - point).sqrt(),
                    torch.full_like(t_obj, R.BIG))
    return t, normal, point, surf, outside, u, v


def _mesh(tab, g, o, d, bound, lanes_per_block=256):
    """Nearest triangle by brute force (Moller-Trumbore in object space,
    t > 1e-6) for the lanes whose ray meets the mesh's box, with the hit's
    interpolated normal and uv; returns _primitive's tuple, `outside` the
    side the ray came from (two-sided: the normal faces the ray)."""
    dt, dev = tab.dt, tab.dev
    qo = R.xform_pt(g["inv"], o)
    qd = normalize(R.xform_dir(g["inv"], d))
    n = qo.shape[0]
    t_obj = torch.full((n,), R.BIG, dtype=dt, device=dev)
    nl = torch.zeros((n, 3), dtype=dt, device=dev)
    uv = torch.zeros((n, 2), dtype=dt, device=dev)
    tiny = torch.where(qd < 0, -1e-12, 1e-12).to(dt)
    inv = 1.0 / torch.where(qd.abs() < 1e-12, tiny, qd)
    ta = (g["lo"] - qo) * inv
    tb = (g["hi"] - qo) * inv
    near = torch.minimum(ta, tb).max(-1).values
    far = torch.maximum(ta, tb).min(-1).values
    cand = ((far >= near) & (far > 0) & bound).nonzero()[:, 0]
    v0, e1, e2 = g["v0"], g["e1"], g["e2"]
    for s in range(0, cand.numel(), lanes_per_block):
        rows = cand[s:s + lanes_per_block]
        ro, rd = qo[rows][:, None, :], qd[rows][:, None, :]
        p = torch.cross(rd.expand(-1, e2.shape[0], -1),
                        e2.expand(rows.numel(), -1, -1), dim=-1)
        det = dot(e1, p)
        ok = det.abs() > 1e-12
        inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
        tv = ro - v0
        bu = dot(tv, p) * inv_det
        del p
        q = torch.cross(tv, e1.expand(rows.numel(), -1, -1), dim=-1)
        del tv
        bv = dot(rd, q) * inv_det
        tk = dot(e2, q) * inv_det
        del q
        hit = ok & (bu >= 0) & (bv >= 0) & (bu + bv <= 1) & (tk > 1e-6)
        tk = torch.where(hit, tk, torch.full_like(tk, R.BIG))
        best, tri = tk.min(-1)
        got = (best < R.BIG)[:, None]
        bu_w = bu.gather(1, tri[:, None])
        bv_w = bv.gather(1, tri[:, None])
        bw = 1.0 - bu_w - bv_w

        def mix(a, b, c):
            return bw * g[a][tri] + bu_w * g[b][tri] + bv_w * g[c][tri]
        t_obj[rows] = torch.where(got[:, 0], best, t_obj[rows])
        nl[rows] = torch.where(got, mix("n0", "n1", "n2"), nl[rows])
        uv[rows] = torch.where(got, mix("uv0", "uv1", "uv2"), uv[rows])
    hit = t_obj < R.BIG
    ip = fma((t_obj - RAY_EPS)[:, None], qd, qo)
    sf = fma(t_obj[:, None], qd, qo)
    point = R.xform_pt(g["M"], ip)
    surf = R.xform_pt(g["M"], sf)
    normal = normalize(R.xform_dir(g["invt"], nl))
    facing = dot(normal, d) < 0
    normal = torch.where(facing[:, None], normal, -normal)
    t = torch.where(hit, dot(o - point, o - point).sqrt(),
                    torch.full_like(t_obj, R.BIG))
    return t, normal, point, surf, facing, uv[:, 0], uv[:, 1]


def intersect(tab: Tables, o, d, alive):
    """Nearest hit over all objects, primitives first and then meshes, a
    candidate winning only when strictly nearer: (t, normal, point, surf,
    outside, u, v, material); a miss has t = -1 and material 0."""
    n = o.shape[0]
    best = [torch.full((n,), R.BIG, dtype=tab.dt, device=tab.dev),
            torch.zeros_like(o), torch.zeros_like(o), torch.zeros_like(o),
            torch.ones((n,), dtype=torch.bool, device=tab.dev),
            torch.zeros((n,), dtype=tab.dt, device=tab.dev),
            torch.zeros((n,), dtype=tab.dt, device=tab.dev)]
    mat = torch.zeros((n,), dtype=torch.int64, device=tab.dev)
    order = ([g for g in tab.geoms if g["kind"] != RS.MESH]
             + [g for g in tab.geoms if g["kind"] == RS.MESH])
    for g in order:
        cand = (_mesh(tab, g, o, d, alive) if g["kind"] == RS.MESH
                else _primitive(g, o, d))
        closer = cand[0] < best[0]
        best = [torch.where(closer if b.ndim == 1 else closer[:, None], c, b)
                for b, c in zip(best, cand)]
        mat = torch.where(closer, g["mat"], mat)
    miss = best[0] >= R.BIG
    best[0] = torch.where(miss, -1.0, best[0]).to(tab.dt)
    return (*best, torch.where(miss, 0, mat))


# ---------------------------------------------------------------------------
# texels
# ---------------------------------------------------------------------------

def texture_albedo(tab: Tables, mat, u, v, albedo):
    """The nearest texel of each lane's material image at (u, v), wrapped
    (u - floor u) and with v = 1 at the image's top row; `albedo` where the
    material has no image."""
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    for m, im in enumerate(tab.textures):
        if im is None:
            continue
        h, w = im.shape[0], im.shape[1]
        xi = torch.clamp(torch.floor(uu * w).long(), 0, w - 1)
        yi = torch.clamp(torch.floor((1.0 - vv) * h).long(), 0, h - 1)
        albedo = torch.where((mat == m)[:, None], im[yi, xi], albedo)
    return albedo


def env_radiance(tab: Tables, d):
    """The sky's nearest equirect texel in direction d (longitude from -z
    toward +x, row 0 straight up); black without an ENVMAP."""
    if tab.env is None:
        return torch.zeros_like(d)
    h, w = tab.env.shape[0], tab.env.shape[1]
    u = 0.5 + _atan2(d[:, 0], -d[:, 2]) / (2.0 * math.pi)
    v = torch.acos(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi
    xi = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    yi = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    return tab.env[yi, xi]


# ---------------------------------------------------------------------------
# the path
# ---------------------------------------------------------------------------

def _pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def trace(tab: Tables, pix: torch.Tensor, draws, depth: int,
          stats: Optional[dict] = None) -> torch.Tensor:
    """The radiance [L,3] of one path a lane. `stats`, when given, gets per
    bounce the lanes alive on entering it ("live"), those of them that
    need a texel (a textured hit or, with an ENVMAP, a miss: "fetches"),
    those that take the refractive lobe ("glass") and those that miss
    ("sky")."""
    mats, dt, dev = tab.materials, tab.dt, tab.dev
    o, d, _ = R.camera_rays(tab, pix, draws, antialias=True, dof=True)
    n = o.shape[0]
    thr = torch.ones((n, 3), dtype=dt, device=dev)
    rad = torch.zeros((n, 3), dtype=dt, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    zero = torch.zeros((n,), dtype=dt, device=dev)
    if stats is not None:
        for k in ("live", "fetches", "glass", "sky"):
            stats[k] = []
    for b in range(depth):
        last = b == depth - 1
        t, normal, point, surf, outside, u, v, mat = intersect(tab, o, d,
                                                               alive)
        us = [x.to(dt) for x in draws.bounce(b)]
        textured = tab.textured(mat)
        albedo = texture_albedo(tab, mat, u, v, R._take(mats["color"], mat))
        spec = R._take(mats["specular_color"], mat)
        emit = R._take(mats["emittance"], mat)
        ior = R._take(mats["ior"], mat)
        p_refr = R.clip(R._take(mats["has_refractive"], mat), 0.0, 1.0)
        p_spec = R.clip(R._take(mats["has_reflective"], mat), 0.0, 1.0) \
            * (1.0 - p_refr)
        p_diff = maximum(1.0 - p_refr - p_spec, 0.0)
        hit_ok = t > 0.0
        is_light = hit_ok & (emit > 0.0)
        lit = alive & is_light
        missed = alive & ~hit_ok
        rad = rad + torch.where(
            lit[:, None], thr * albedo * torch.where(lit, emit, zero)[:, None],
            torch.where(missed[:, None], thr * env_radiance(tab, d),
                        torch.zeros_like(rad)))

        u_lobe = us[0]
        take_refr = u_lobe < p_refr
        take_spec = ~take_refr & (u_lobe < p_refr + p_spec)
        d_diff = R.cosine_hemisphere(normal, us[1], us[2])
        d_spec = d - 2.0 * dot(d, normal)[:, None] * normal
        # Schlick's Fresnel term; the draw u_fresnel picks reflection over
        # transmission, as does total internal reflection
        safe_ior = maximum(ior, 1e-6)
        one = torch.ones_like(ior)
        eta = torch.where(outside, 1.0 / safe_ior, safe_ior)
        cos_i = R.clip(-dot(d, normal), 0.0, 1.0)
        eta_i = torch.where(outside, one, ior)
        eta_t = torch.where(outside, ior, one)
        q = (eta_i - eta_t) / (eta_i + eta_t)
        r0 = q * q
        fres = r0 + (1.0 - r0) * _pow5(1.0 - cos_i)
        sin2_t = eta * eta * maximum(1.0 - cos_i * cos_i, 0.0)
        cos_t = torch.sqrt(maximum(1.0 - sin2_t, 1e-20))
        k_r = eta * cos_i - cos_t
        d_refr = eta[:, None] * d + k_r[:, None] * normal
        refl_instead = (sin2_t > 1.0) | (us[3] < fres)
        d_refr = torch.where(refl_instead[:, None], d_spec, d_refr)
        new_dir = normalize(torch.where(
            take_refr[:, None], d_refr,
            torch.where(take_spec[:, None], d_spec, d_diff)))

        factor = torch.where(
            take_refr[:, None], spec * (1.0 / maximum(p_refr, 1e-6))[:, None],
            torch.where(take_spec[:, None],
                        spec * (1.0 / maximum(p_spec, 1e-6))[:, None],
                        albedo * (1.0 / maximum(p_diff, 1e-6))[:, None]))
        scattering = alive & hit_ok & ~is_light
        if stats is not None:
            fetch = (hit_ok & textured) | (~hit_ok & (tab.env is not None))
            for k, m in (("live", alive), ("fetches", alive & fetch),
                         ("glass", scattering & take_refr),
                         ("sky", missed)):
                stats[k].append(int(m.sum()))
        thr = torch.where(scattering[:, None], thr * factor, thr)
        # a transmitted ray starts just past the exact surface point, the
        # others from the backed-off one
        transmit = take_refr & ~refl_instead
        push = torch.where(transmit, 2.0 * RAY_EPS, 0.0).to(dt)
        o = torch.where(transmit[:, None], surf, point) \
            + push[:, None] * new_dir
        d = new_dir
        alive = scattering & (not last)
    return rad


def retrace(tab: Tables, pix: torch.Tensor, iterations: int,
            depth: int) -> np.ndarray:
    """The mean radiance [K,3] (float64) of pixels `pix` over the lattice's
    iterations 0..iterations-1, traced REF_BLOCK lanes a call."""
    acc = torch.zeros((pix.numel(), 3), dtype=torch.float64,
                      device=pix.device)
    lanes = pix.numel() * iterations
    for s in range(0, lanes, REF_BLOCK):
        idx = torch.arange(s, min(s + REF_BLOCK, lanes), device=pix.device)
        slot, it = idx // iterations, idx % iterations
        rad = trace(tab, pix[slot], R.LatticeDraws(it, pix[slot]), depth)
        acc.index_add_(0, slot, rad.double())
    return (acc / iterations).cpu().numpy()
