"""A plain PyTorch path tracer of the CIS565 semantics the program renders.

Every path is one lane: rays as [L,3] tensors, each object tested by brute
force (a cube's slab test, a sphere's quadratic, every triangle of a mesh by
Moller-Trumbore), nearest hit by a strict `<` in object order, then the
material's lobe: emissive, diffuse (cosine-weighted), mirror. Area-light
next-event estimation with one-sample MIS (the balance heuristic) on
request. Draws come from a `Draws` source: the stratified lattice keyed on
(iteration, depth, pixel), or a torch.Generator stream in the program's
order of calls. `dtype` sets the precision of the arithmetic (float32, or
bfloat16 for the control); the draws are made in float32 and converted.

It imports nothing of the program, and it is written to be read: no
kernels, caches or batching beyond blocks of lanes.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .scene import CUBE, MESH, SPHERE, Scene

RAY_EPS = 1e-4          # getPointOnRay's back-off (intersections.h)
BIG = 1e30
SQRT_OF_ONE_THIRD = 0.5773502691896257645091487805019574556476
TWO_PI = 6.2831853071795864769252867665590057683943
F32 = torch.float32
U32 = 0xFFFFFFFF

# the stratified lattice: R_d rank-1 lattices, Cranley-Patterson rotated by
# an integer hash of (depth slot, pixel) and a salt per draw
R_ALPHAS = {
    1: (0.6180339887498949,),
    2: (0.7548776662466927, 0.5698402909980532),
    3: (0.8191725133961645, 0.6710436067037893, 0.5497004779019703),
    4: (0.8566748838545029, 0.7338918566271259, 0.6287067210378086,
        0.5385972572236101)}
CAMERA_SLOT = 0x7FFFFFFF
SALT_AA = 0x68BC21EB
SALT_LENS = 0x51633E2D
SALT_TIME = 0x3504F333
SALT_BOUNCE = 0x2545F491
SALT_NEE_AREA = 0x7F4A7C15


def hash01(idx: torch.Tensor, salt: int) -> torch.Tensor:
    """A uniform in [0,1) from a 32-bit integer hash, in int64 arithmetic."""
    x = (idx & U32) ^ (salt & U32)
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & U32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & U32
    x = x ^ (x >> 16)
    return (x & 0x00FFFFFF).to(F32) * (1.0 / (1 << 24))


def lattice(iteration: torch.Tensor, slot: int, key: torch.Tensor,
            ndims: int, salt: int) -> list:
    """`ndims` float32 planes: frac(0.5 + iteration * alpha_k + hash)."""
    it_f = iteration.to(F32)
    mix = (key & U32) ^ ((int(slot) * 0x9E3779B9) & U32)
    return [torch.fmod(0.5 + it_f * torch.tensor(a, dtype=F32)
                       + hash01(mix, salt + 101 * k), 1.0)
            for k, a in enumerate(R_ALPHAS[ndims][:ndims])]


class LatticeDraws:
    """Draws of lanes that each carry their own (iteration, pixel)."""

    def __init__(self, iteration: torch.Tensor, pixel: torch.Tensor):
        self.it, self.pix = iteration, pixel

    def camera(self, n: int, salt: int) -> list:
        return lattice(self.it, CAMERA_SLOT, self.pix, n, salt)

    def bounce(self, depth: int) -> list:
        return lattice(self.it, depth, self.pix, 4, SALT_BOUNCE)

    def light(self, depth: int) -> list:
        return lattice(self.it, depth, self.pix, 3, SALT_NEE_AREA)


class StreamDraws:
    """Draws of a whole frame from one torch.Generator, one torch.rand of
    rows * N uniforms per request, in the order the tracer asks."""

    def __init__(self, generator: torch.Generator, n: int, device):
        self.g, self.n, self.dev = generator, n, device

    def _rows(self, rows: int) -> list:
        u = torch.rand((rows * self.n,), generator=self.g, dtype=F32,
                       device=self.dev).reshape(rows, self.n)
        return list(u)

    def camera(self, n: int, salt: int) -> list:
        return self._rows(n)

    def bounce(self, depth: int) -> list:
        return self._rows(4)

    def light(self, depth: int) -> list:
        return self._rows(3)


def dot(a, b):
    return (a * b).sum(-1)


def normalize(a):
    """a / |a|, with a zero-length lane left finite (and its gradient)."""
    d2 = dot(a, a)
    return a * torch.rsqrt(torch.where(d2 > 1e-12, d2,
                                       torch.ones_like(d2)))[..., None]


def maximum(x, c):
    """max(x, c) that halves the gradient at a tie (jnp.maximum's rule)."""
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype, device=x.device))


def clip(x, lo, hi):
    return torch.minimum(maximum(x, lo),
                         torch.tensor(hi, dtype=x.dtype, device=x.device))


def fma(a, b, c):
    """a*b + c rounded once (the hit points need it: float32 rounding of
    t*dir eats the 1e-4 back-off on thin slabs)."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def xform_dir(m, d):
    """The 3x3 part of `m` times each row of `d`, as sums of products (no
    matrix multiply, so no TF32)."""
    return (d[:, 0, None] * m[:3, 0] + d[:, 1, None] * m[:3, 1]
            + d[:, 2, None] * m[:3, 2])


def xform_pt(m, p):
    return xform_dir(m, p) + m[:3, 3]


class Tables:
    """The scene as tensors of one dtype on one device. `materials` and
    `camera` may be leaves that require grad (the train step)."""

    def __init__(self, scene: Scene, device, dtype=F32,
                 materials: Optional[dict] = None,
                 camera: Optional[dict] = None):
        self.scene, self.dev, self.dt = scene, torch.device(device), dtype

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.dev).to(dtype)
        self.materials = materials or {k: t(v) for k, v in
                                       scene.materials.items()}
        self.camera = camera or {k: t(v) for k, v in scene.camera.items()}
        if bool((np.asarray(scene.materials["has_refractive"]) > 0).any()):
            raise ValueError("the reference has no refractive lobe")
        if bool((np.asarray(scene.materials["specular_exponent"]) > 0)
                .any()):
            raise ValueError("the reference has no glossy lobe")
        self.geoms = []
        for g in scene.geoms:
            rec = dict(kind=g.kind, mat=g.material, M=t(g.transform),
                       inv=t(g.inverse), invt=t(g.inverse_transpose))
            if g.kind == MESH:
                c, n = g.mesh.corners, g.mesh.normals
                rec.update(v0=t(c[:, 0]), e1=t(c[:, 1] - c[:, 0]),
                           e2=t(c[:, 2] - c[:, 0]), n0=t(n[:, 0]),
                           n1=t(n[:, 1]), n2=t(n[:, 2]),
                           lo=t(c.reshape(-1, 3).min(0) - 1e-4),
                           hi=t(c.reshape(-1, 3).max(0) + 1e-4))
            self.geoms.append(rec)
        self.lights = light_table(scene)


# ---------------------------------------------------------------------------
# camera rays
# ---------------------------------------------------------------------------

def camera_rays(tab: Tables, pix: torch.Tensor, draws, antialias=True,
                dof=False, motion=False):
    """Primary rays (origin [L,3], direction [L,3], time [L]); lane i at
    pixel (pix % W, pix // W)."""
    cam, dt, W, H = tab.camera, tab.dt, tab.scene.width, tab.scene.height
    x = (pix % W).to(dt)
    y = (pix // W).to(dt)
    if antialias:
        ax, ay = draws.camera(2, SALT_AA)
        x, y = x + ax.to(dt), y + ay.to(dt)
    sx = cam["pixel_length"][0] * (x - W * 0.5)
    sy = cam["pixel_length"][1] * (y - H * 0.5)
    d = normalize(cam["view"] - cam["right"] * sx[:, None]
                  - cam["up"] * sy[:, None])
    o = cam["position"].expand_as(d)
    if dof:
        u0, u1 = (u.to(dt) for u in draws.camera(2, SALT_LENS))
        ap, foc = cam["aperture"], cam["focal_distance"]
        r = torch.sqrt(u0) * ap
        phi = u1 * TWO_PI
        lr, lu = r * torch.cos(phi), r * torch.sin(phi)
        o_dof = o + cam["right"] * lr[:, None] + cam["up"] * lu[:, None]
        focus = o + d * maximum(foc, 1e-6)
        d_dof = normalize(focus - o_dof)
        use = (ap > 0.0) & (foc > 0.0)
        o = torch.where(use, o_dof, o)
        d = torch.where(use, d_dof, d)
    if motion:
        (ut,) = draws.camera(1, SALT_TIME)
        times = ut.to(dt) * cam["shutter"]
    else:
        times = torch.zeros_like(x)
    return o, d, times


# ---------------------------------------------------------------------------
# intersection
# ---------------------------------------------------------------------------

def _box(qo, qd):
    """Unit cube slab test: (t_obj, hit, outside, local normal)."""
    tiny = torch.where(qd < 0, -1e-12, 1e-12).to(qd.dtype)
    inv = 1.0 / torch.where(qd.abs() < 1e-12, tiny, qd)
    t1 = (-0.5 - qo) * inv
    t2 = (0.5 - qo) * inv
    ta, tb = torch.minimum(t1, t2), torch.maximum(t1, t2)
    sign = torch.where(t2 < t1, 1.0, -1.0).to(qd.dtype)
    tap = torch.where(ta > 0, ta, torch.full_like(ta, -BIG))
    tmin = tap.max(-1).values
    tmax = tb.min(-1).values
    hit = (tmax >= tmin) & (tmax > 0)
    outside = tmin > 0
    # the face: first axis (x, then y, then z) whose slab sets the distance
    on = torch.where(outside[:, None], tap == tmin[:, None],
                     tb == tmax[:, None])
    ex = on[:, 0]
    ey = ~ex & on[:, 1]
    ez = ~(ex | ey)
    axis = torch.stack([ex, ey, ez], -1)
    n_local = torch.where(axis, sign, torch.zeros_like(sign))
    return torch.where(outside, tmin, tmax), hit, outside, n_local


def _sphere(qo, qd):
    """r = 0.5 sphere: (t_obj, hit, outside)."""
    b = dot(qo, qd)
    disc = b * b - (dot(qo, qo) - 0.25)
    ok = disc >= 0
    s = torch.sqrt(torch.where(ok, maximum(disc, 0.0),
                               torch.ones_like(disc)))
    t1, t2 = -b + s, -b - s
    both_pos = (t1 > 0) & (t2 > 0)
    t = torch.where(both_pos, torch.minimum(t1, t2), torch.maximum(t1, t2))
    return t, ok & ~((t1 < 0) & (t2 < 0)), both_pos


def _primitive(g, o, d):
    """One cube or sphere against every lane: (t, normal, point, outside)
    with the world distance to the backed-off point."""
    qo = xform_pt(g["inv"], o)
    qd = normalize(xform_dir(g["inv"], d))
    if g["kind"] == CUBE:
        t_obj, hit, outside, n_local = _box(qo, qd)
    else:
        t_obj, hit, outside = _sphere(qo, qd)
    ip_obj = fma((t_obj - RAY_EPS)[:, None], qd, qo)
    point = xform_pt(g["M"], ip_obj)
    if g["kind"] == SPHERE:
        flip = torch.where(outside, 1.0, -1.0).to(qd.dtype)
        n_local = ip_obj * flip[:, None]
    normal = normalize(xform_dir(g["invt"], n_local))
    t = torch.where(hit, dot(o - point, o - point).sqrt(),
                    torch.full_like(t_obj, BIG))
    return t, normal, point, outside


def _mesh(tab, g, o, d, bound, lanes_per_block=256):
    """Nearest triangle of the mesh by brute force (Moller-Trumbore in
    object space, t > 1e-6), lanes whose ray meets the mesh's bounding box
    only, in blocks of lanes against every triangle."""
    dt, dev = tab.dt, tab.dev
    qo = xform_pt(g["inv"], o)
    qd = normalize(xform_dir(g["inv"], d))
    n = qo.shape[0]
    t_obj = torch.full((n,), BIG, dtype=dt, device=dev)
    nl = torch.zeros((n, 3), dtype=dt, device=dev)
    # the box: lanes alive whose slab interval is not empty
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
        tk = torch.where(hit, tk, torch.full_like(tk, BIG))
        best, tri = tk.min(-1)
        got = best < BIG
        bu_w = bu.gather(1, tri[:, None])[:, 0]
        bv_w = bv.gather(1, tri[:, None])[:, 0]
        bw = 1.0 - bu_w - bv_w
        nrm = (bw[:, None] * g["n0"][tri] + bu_w[:, None] * g["n1"][tri]
               + bv_w[:, None] * g["n2"][tri])
        t_obj[rows] = torch.where(got, best, t_obj[rows])
        nl[rows] = torch.where(got[:, None], nrm, nl[rows])
    hit = t_obj < BIG
    ip_obj = fma((t_obj - RAY_EPS)[:, None], qd, qo)
    point = xform_pt(g["M"], ip_obj)
    normal = normalize(xform_dir(g["invt"], nl))
    facing = dot(normal, d) < 0
    normal = torch.where(facing[:, None], normal, -normal)
    t = torch.where(hit, dot(o - point, o - point).sqrt(),
                    torch.full_like(t_obj, BIG))
    return t, normal, point, facing


def intersect(tab: Tables, o, d, alive=None, max_t=None):
    """Nearest hit over all objects, primitives first and then meshes, a
    candidate winning only when strictly nearer. Returns (t, normal, point,
    material, outside); a miss has t = -1 and material 0."""
    n = o.shape[0]
    dt, dev = tab.dt, tab.dev
    t0 = (torch.full((n,), BIG, dtype=dt, device=dev) if max_t is None
          else torch.clamp(max_t, max=BIG))
    t, normal = t0, torch.zeros_like(o)
    point = torch.zeros_like(o)
    mat = torch.zeros((n,), dtype=torch.int64, device=dev)
    outside = torch.ones((n,), dtype=torch.bool, device=dev)
    order = ([g for g in tab.geoms if g["kind"] != MESH]
             + [g for g in tab.geoms if g["kind"] == MESH])
    for g in order:
        if g["kind"] == MESH:
            live = alive if alive is not None else torch.ones_like(outside)
            ct, cn, cp, co = _mesh(tab, g, o.detach(), d.detach(), live)
        else:
            ct, cn, cp, co = _primitive(g, o, d)
        closer = ct < t
        t = torch.where(closer, ct, t)
        normal = torch.where(closer[:, None], cn, normal)
        point = torch.where(closer[:, None], cp, point)
        mat = torch.where(closer, g["mat"], mat)
        outside = torch.where(closer, co, outside)
    miss = t >= t0
    return (torch.where(miss, -1.0, t).to(dt), normal, point,
            torch.where(miss, 0, mat), outside)


# ---------------------------------------------------------------------------
# lights (next-event estimation)
# ---------------------------------------------------------------------------

def light_table(scene: Scene):
    """The emissive cubes' faces, uniform by area: (rows, total area) with
    rows (cumulative fraction, corner, edge u, edge v, normal, material),
    or None without an emissive object."""
    faces = []
    emit = scene.materials["emittance"]
    for g in scene.geoms:
        if emit[g.material] <= 0:
            continue
        if g.kind != CUBE:
            return None
        m = g.transform.astype(np.float64)
        for k in range(3):
            for s in (0.5, -0.5):
                corner = np.full(3, -0.5)
                corner[k] = s
                eu = m[:3, (k + 1) % 3]
                ev = m[:3, (k + 2) % 3]
                nrm = g.inverse_transpose[:3, :3].astype(np.float64)[:, k] \
                    * np.sign(s)
                faces.append((m[:3, :3] @ corner + m[:3, 3], eu, ev,
                              nrm / np.linalg.norm(nrm),
                              float(np.linalg.norm(np.cross(eu, ev))),
                              g.material))
    if not faces:
        return None
    total = sum(f[4] for f in faces)
    cum = np.cumsum([f[4] / total for f in faces])
    cum[-1] = 1.0
    rows = [(c, *o, *eu, *ev, *nrm, mat)
            for c, (o, eu, ev, nrm, _, mat) in zip(cum, faces)]
    return np.asarray(rows, np.float64), float(total)


def sample_light(tab: Tables, us):
    """A point uniform by area on the lights: (point, normal, material)."""
    rows, _ = tab.lights
    tbl = torch.as_tensor(rows, device=tab.dev).to(F32)
    if tbl.shape[0] > 1:
        fi = torch.searchsorted(tbl[:-1, 0].contiguous(), us[0].to(F32),
                                right=True)
    else:
        fi = torch.zeros_like(us[0], dtype=torch.int64)
    r = tbl[fi].to(tab.dt)
    u1, u2 = us[1].to(tab.dt), us[2].to(tab.dt)
    lp = r[:, 1:4] + u1[:, None] * r[:, 4:7] + u2[:, None] * r[:, 7:10]
    return lp, r[:, 10:13], r[:, 13].to(torch.int64)


# ---------------------------------------------------------------------------
# the path
# ---------------------------------------------------------------------------

def _take(table, mat):
    return torch.index_select(table, 0, mat)


def cosine_hemisphere(n, u1, u2):
    up = torch.sqrt(u1)
    over = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    around = u2 * TWO_PI
    px = n[:, 0].abs() < SQRT_OF_ONE_THIRD
    py = ~px & (n[:, 1].abs() < SQRT_OF_ONE_THIRD)
    other = torch.stack([px, py, ~(px | py)], -1).to(n.dtype)
    p1 = normalize(torch.cross(n, other, dim=-1))
    p2 = normalize(torch.cross(n, p1, dim=-1))
    return (up[:, None] * n + (torch.cos(around) * over)[:, None] * p1
            + (torch.sin(around) * over)[:, None] * p2)


def trace(tab: Tables, pix: torch.Tensor, draws, depth: int,
          nee: bool = False, antialias=True, dof=False,
          motion=False, stats: Optional[dict] = None) -> torch.Tensor:
    """The radiance [L,3] of one path a lane. `stats`, when given, gets
    the number of live lanes that enter each bounce ("live")."""
    mats, dt, dev = tab.materials, tab.dt, tab.dev
    o, d, _ = camera_rays(tab, pix, draws, antialias, dof, motion)
    n = o.shape[0]
    thr = torch.ones((n, 3), dtype=dt, device=dev)
    rad = torch.zeros((n, 3), dtype=dt, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((n,), dtype=dt, device=dev)
    zero = torch.zeros((n,), dtype=dt, device=dev)
    if nee and tab.lights is None:
        raise ValueError("NEE needs an emissive cube")
    area = tab.lights[1] if nee else 0.0
    if stats is not None:
        stats["live"] = []
    for b in range(depth):
        last = b == depth - 1
        if stats is not None:
            stats["live"].append(int(alive.sum()))
        t, normal, point, mat, _ = intersect(tab, o, d, alive)
        us = [u.to(dt) for u in draws.bounce(b)]
        albedo = _take(mats["color"], mat)
        spec = _take(mats["specular_color"], mat)
        emit = _take(mats["emittance"], mat)
        p_refr = clip(_take(mats["has_refractive"], mat), 0.0, 1.0)
        p_spec = clip(_take(mats["has_reflective"], mat), 0.0, 1.0) \
            * (1.0 - p_refr)
        p_diff = maximum(1.0 - p_refr - p_spec, 0.0)
        hit_ok = t > 0.0
        is_light = hit_ok & (emit > 0.0)
        lit = alive & is_light
        scale = torch.where(lit, emit, zero)
        if nee:
            cos_hit = dot(normal, d).abs()
            pdf_hit = t * t / maximum(cos_hit * area, 1e-9)
            scale = scale * torch.where(
                prev_pdf > 0.0, prev_pdf / maximum(prev_pdf + pdf_hit, 1e-30),
                torch.ones_like(prev_pdf))
            lp, ln, lmat = sample_light(tab, draws.light(b))
            dv = lp - point
            dist = torch.sqrt(torch.clamp(dot(dv, dv), min=1e-12))
            wl = dv / dist[:, None]
            geom = dot(ln, wl).abs() * area / (dist * dist)
            pdf_l = 1.0 / maximum(geom, 1e-20)
            le = _take(mats["color"], lmat) * _take(mats["emittance"],
                                                    lmat)[:, None]
            if last:
                vis = torch.zeros_like(alive)
            else:
                with torch.no_grad():
                    st = intersect(tab, point, wl, alive,
                                   max_t=dist * (1.0 - 1e-3) - 1e-3)[0]
                vis = st <= 0.0
        # the environment is black: a miss adds nothing
        rad = rad + torch.where(lit[:, None], thr * albedo * scale[:, None],
                                torch.zeros_like(rad))
        u_lobe = us[0].detach()
        take_refr = u_lobe < p_refr
        take_spec = ~take_refr & (u_lobe < p_refr + p_spec)
        d_diff = cosine_hemisphere(normal, us[1], us[2]).detach()
        d_spec = d - 2.0 * dot(d, normal)[:, None] * normal
        new_dir = normalize(torch.where(take_spec[:, None], d_spec, d_diff))
        if nee:
            cos_s = maximum(dot(normal, wl), 0.0)
            ok = alive & hit_ok & ~is_light & vis & (not last)
            pdf_bd = p_diff * cos_s * (1.0 / math.pi)
            wd = torch.where(ok, pdf_bd / (pdf_l + pdf_bd + 1e-30), zero)
            rad = rad + thr * le * (albedo * wd[:, None])
        factor = torch.where(take_spec[:, None],
                             spec * (1.0 / maximum(p_spec, 1e-6))[:, None],
                             albedo * (1.0 / maximum(p_diff, 1e-6))[:, None])
        scattering = alive & hit_ok & ~is_light
        thr = torch.where(scattering[:, None], thr * factor, thr)
        alive = scattering & (not last)
        if nee:
            diff_next = alive & ~take_refr & ~take_spec
            prev_pdf = torch.where(
                diff_next, p_diff * maximum(dot(normal, new_dir), 0.0)
                * (1.0 / math.pi), zero)
        o, d = point, new_dir
    return rad
