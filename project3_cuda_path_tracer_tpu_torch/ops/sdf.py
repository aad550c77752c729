"""Signed-distance-field primitives and CSG (`sdf <kind>` objects).

Counterpart of project3_cuda_path_tracer_tpu/ops/sdf.py, function for
function and with the same arithmetic: an SDF geom's object-space surface
is the zero set of a distance function, found by sphere tracing with a
fixed step count (MARCH_STEPS masked steps over the whole wavefront; a
converged lane stops advancing). Kinds, static per geom as the triple
(kind, aux_a, aux_b) of Scene.sdf_kinds:

  torus R r              ring in the object-space xz plane
  roundbox hx hy hz r    box with rounded edges
  capsule hh r           y-axis capsule of half-height hh
  metaball k (x y z r)*  smooth-min blend of up to MAX_BALLS spheres
                         (aux_a = the ball count)
  csg_union / csg_inter / csg_diff   of sub-shapes A and B (aux_a, aux_b:
                         SUB_SPHERE cx cy cz r, or SUB_BOX cx cy cz hx hy hz)

`params` is the geom's [PARAM_SLOTS] row of Geoms.sdf_params; its entries
are 0-dim tensors, so shape parameters stay differentiable. Normals are
tetrahedral finite differences (4 evaluations).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import vec
from .vec import V3

TORUS = 0
ROUNDBOX = 1
CAPSULE = 2
METABALL = 3
CSG_UNION = 4
CSG_INTER = 5
CSG_DIFF = 6

SUB_NONE = -1
SUB_SPHERE = 0
SUB_BOX = 1

KINDS = dict(torus=TORUS, roundbox=ROUNDBOX, capsule=CAPSULE,
             metaball=METABALL, csg_union=CSG_UNION, csg_inter=CSG_INTER,
             csg_diff=CSG_DIFF)
SUB_SHAPES = dict(sphere=SUB_SPHERE, box=SUB_BOX)

MAX_BALLS = 4
PARAM_SLOTS = 20          # Geoms.sdf_params is [G, PARAM_SLOTS]
MARCH_STEPS = 64          # sphere-tracing steps
HIT_EPS = 1e-3            # object-space convergence band
NORMAL_EPS = 1e-3
T_MAX = 1e4


def _sd_sphere(p: V3, cx, cy, cz, r):
    return vec.norm(V3(p.x - cx, p.y - cy, p.z - cz)) - r


def _sd_box(p: V3, cx, cy, cz, hx, hy, hz):
    qx = torch.abs(p.x - cx) - hx
    qy = torch.abs(p.y - cy) - hy
    qz = torch.abs(p.z - cz) - hz
    outside = vec.norm(V3(torch.clamp(qx, min=0.0), torch.clamp(qy, min=0.0),
                          torch.clamp(qz, min=0.0)))
    inside = torch.clamp(torch.maximum(qx, torch.maximum(qy, qz)), max=0.0)
    return outside + inside


def _sd_torus(p: V3, big_r, r):
    ring = torch.sqrt(p.x * p.x + p.z * p.z) - big_r
    return torch.sqrt(ring * ring + p.y * p.y) - r


def _sd_roundbox(p: V3, hx, hy, hz, rad):
    return _sd_box(p, 0.0, 0.0, 0.0, hx - rad, hy - rad, hz - rad) - rad


def _sd_capsule(p: V3, hh, r):
    py = p.y - torch.minimum(torch.maximum(p.y, -hh), hh)
    return vec.norm(V3(p.x, py, p.z)) - r


def _smin(a, b, k):
    """Polynomial smooth min of blend radius k: <= min(a, b), Lipschitz-1."""
    h = torch.clamp(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return b * (1.0 - h) + a * h - k * h * (1.0 - h)


def _sub_shape(p: V3, sub_kind: int, prm) -> torch.Tensor:
    """A CSG sub-shape's distance; `prm` is its 8-slot view of the row."""
    if sub_kind == SUB_SPHERE:
        return _sd_sphere(p, prm[0], prm[1], prm[2], prm[3])
    if sub_kind == SUB_BOX:
        return _sd_box(p, prm[0], prm[1], prm[2], prm[3], prm[4], prm[5])
    raise ValueError(f"bad CSG sub-shape kind {sub_kind}")


def sdf_eval(p: V3, kind: Tuple[int, int, int], params) -> torch.Tensor:
    """Distance at the object-space points `p`."""
    k, a, b = kind
    if k == TORUS:
        return _sd_torus(p, params[0], params[1])
    if k == ROUNDBOX:
        return _sd_roundbox(p, params[0], params[1], params[2], params[3])
    if k == CAPSULE:
        return _sd_capsule(p, params[0], params[1])
    if k == METABALL:
        nballs = max(1, min(a, MAX_BALLS))
        kblend = params[0]
        d = _sd_sphere(p, params[1], params[2], params[3], params[4])
        for i in range(1, nballs):
            o = 1 + 4 * i
            d = _smin(d, _sd_sphere(p, params[o], params[o + 1],
                                    params[o + 2], params[o + 3]), kblend)
        return d
    if k in (CSG_UNION, CSG_INTER, CSG_DIFF):
        da = _sub_shape(p, a, params[0:8])
        db = _sub_shape(p, b, params[8:16])
        if k == CSG_UNION:
            return torch.minimum(da, db)
        if k == CSG_INTER:
            return torch.maximum(da, db)
        return torch.maximum(da, -db)
    raise ValueError(f"bad SDF kind {k}")


def _bounding_radius(kind: Tuple[int, int, int], params) -> torch.Tensor:
    """A conservative object-space bounding-sphere radius (0-dim): rays
    that miss it skip the march, the others start at its entry."""
    k, a, _ = kind
    if k == TORUS:
        return params[0] + params[1]
    if k == ROUNDBOX:
        return torch.sqrt(params[0] ** 2 + params[1] ** 2 + params[2] ** 2)
    if k == CAPSULE:
        return params[0] + params[1]
    if k == METABALL:
        r = torch.zeros((), dtype=params.dtype, device=params.device)
        for i in range(max(1, min(a, MAX_BALLS))):
            o = 1 + 4 * i
            c = torch.sqrt(params[o] ** 2 + params[o + 1] ** 2
                           + params[o + 2] ** 2)
            # smin can pull the blended surface out by up to k/4
            r = torch.maximum(r, c + params[o + 3] + params[0])
        return r

    def sub_r(sub_kind, prm):
        if sub_kind == SUB_SPHERE:
            return torch.sqrt(prm[0] ** 2 + prm[1] ** 2 + prm[2] ** 2) + prm[3]
        return (torch.sqrt(prm[0] ** 2 + prm[1] ** 2 + prm[2] ** 2)
                + torch.sqrt(prm[3] ** 2 + prm[4] ** 2 + prm[5] ** 2))
    # CSG: the union of the two sub-shapes' bounds
    return torch.maximum(sub_r(kind[1], params[0:8]),
                         sub_r(kind[2], params[8:16]))


def march_local(qo: V3, qd: V3, kind: Tuple[int, int, int], params):
    """Sphere-trace the SDF in object space along the unit direction qd.
    Returns (t_obj [N], hit [N] bool, outside [N] bool).

    MARCH_STEPS masked steps: a converged or escaped lane stops advancing.
    Rays that start inside march the sign-flipped field (`sgn`). A lane may
    report a hit only once armed, i.e. clear of the HIT_EPS band (judged at
    its true origin or any later point), and advances at least HIT_EPS a
    step until then, so a scattered ray born ~1e-4 off the surface does not
    re-hit it at t = 0. Lanes that run out of steps inside the loose band
    (4 HIT_EPS) still count as hits."""
    f0 = sdf_eval(qo, kind, params)
    outside = f0 >= 0.0
    sgn = torch.where(outside, 1.0, -1.0).to(f0.dtype)

    rb = _bounding_radius(kind, params) + HIT_EPS
    oc2 = vec.dot(qo, qo)
    proj = -vec.dot(qo, qd)                       # t of closest approach
    perp2 = oc2 - proj * proj
    half = torch.sqrt(torch.clamp(rb * rb - perp2, min=0.0))
    t_in = torch.clamp(proj - half, min=0.0)
    misses_bound = (perp2 > rb * rb) | (proj + half <= 0.0)

    t = torch.where(misses_bound, torch.full_like(t_in, T_MAX), t_in)
    live = ~misses_bound
    armed = live & (sgn * f0 > 2.0 * HIT_EPS)
    hit = torch.zeros_like(live)
    t_end = 2.0 * rb + t_in
    zero = torch.zeros_like(t)
    eps = torch.full_like(t, HIT_EPS)
    for _ in range(MARCH_STEPS):
        p = V3(qo.x + t * qd.x, qo.y + t * qd.y, qo.z + t * qd.z)
        d = sgn * sdf_eval(p, kind, params)
        armed = armed | (d > 2.0 * HIT_EPS)
        hit_now = live & armed & (d <= HIT_EPS)
        hit = hit | hit_now
        adv = torch.where(live & ~hit_now,
                          torch.maximum(d, torch.where(armed, zero, eps)),
                          zero)
        t = t + adv
        live = live & ~hit_now & (t < t_end)
    p = V3(qo.x + t * qd.x, qo.y + t * qd.y, qo.z + t * qd.z)
    d_final = sgn * sdf_eval(p, kind, params)
    hit = hit | (armed & (d_final <= 4.0 * HIT_EPS) & (t < T_MAX))
    return t, hit, outside


def normal_local(p: V3, kind: Tuple[int, int, int], params) -> V3:
    """The tetrahedral finite-difference gradient of the field (4
    evaluations), normalised."""
    e = NORMAL_EPS
    n = V3(torch.zeros_like(p.x), torch.zeros_like(p.x),
           torch.zeros_like(p.x))
    for sx, sy, sz in ((1, -1, -1), (-1, -1, 1), (-1, 1, -1), (1, 1, 1)):
        d = sdf_eval(V3(p.x + sx * e, p.y + sy * e, p.z + sz * e),
                     kind, params)
        n = V3(n.x + sx * d, n.y + sy * d, n.z + sz * d)
    return vec.normalize(n)
