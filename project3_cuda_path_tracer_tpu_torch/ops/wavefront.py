"""Planar wavefront stages in torch ops: ray generation, intersection, shading.

Counterpart of the primitive path of project3_cuda_path_tracer_tpu/ops/
wavefront.py, function for function and with the same arithmetic, so that
the tests can hold each stage against the JAX one on the same inputs. These
stages are the plain version of the CUDA megakernel (csrc/megakernel.cu):
`render.integrator.trace_wavefront` chains them into one iteration.

Scope: cubes, spheres and triangle meshes (through the BVH traversal
kernels of ops/bvh8.py and ops/pallas_bvh.py), untextured albedo, a constant
environment, the optional glossy Phong lobe, Fresnel refraction, area-light
NEE with one-sample MIS (ops/nee.py: the shadow rays are occlusion queries
of `intersect_planar`, the MIS terms live in `shade_planar`), and the
batched sphere pass of many-light scenes. SDFs, textures, the procedural
sky, env-map NEE, dispersion, bump and normal maps come with later slices.

Reference: src/intersections.h:27-144 (slab + quadratic in object space,
world-distance t, 1e-4 back-off) and scatterRay, src/interactions.h:44-79.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import bvh8 as B8
from . import pallas_bvh as PB
from . import vec
from .vec import V3
from ..scene import types as T
from ..utils.math import SQRT_OF_ONE_THIRD, TWO_PI, RAY_EPS

BIG = 1e30
_U32 = 0xFFFFFFFF
F32 = torch.float32


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    """max(x, c) with jnp.maximum's gradient: at a tie x == c the gradient
    is halved (torch.clamp passes all of it). Materials sit on such ties,
    e.g. REFR 0 against the clip's lower bound."""
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip, as jax differentiates it (see `_max`)."""
    return torch.minimum(_max(x, lo), torch.tensor(hi, dtype=x.dtype))


# ---------------------------------------------------------------------------
# Ray generation (reference: src/pathtrace.cu:122-143)
# ---------------------------------------------------------------------------

def _hash01(idx: torch.Tensor, salt: int) -> torch.Tensor:
    """Per-pixel uniform in [0,1) from an integer hash (the JAX `_hash01`).
    uint32 wraparound is emulated in int64: every product of a value below
    2^32 with the 27-bit multiplier fits, and `& 0xFFFFFFFF` wraps it."""
    x = (idx.to(torch.int64) & _U32) ^ (salt & _U32)
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _U32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _U32
    x = x ^ (x >> 16)
    return (x & 0x00FFFFFF).to(F32) * (1.0 / (1 << 24))


# R_d rank-1 lattices (Roberts 2018): the i-th point is frac(0.5 + i*ALPHA).
_R2A = (0.7548776662466927, 0.5698402909980532)
_R3A = (0.8191725133961645, 0.6710436067037893, 0.5497004779019703)
_R4A = (0.8566748838545029, 0.7338918566271259,
        0.6287067210378086, 0.5385972572236101)
_PHI_INV = 0.6180339887498949
_ALPHAS = {1: (_PHI_INV,), 2: _R2A, 3: _R3A, 4: _R4A}

# "depth" slot of the camera dims (distinct from every bounce depth)
CAMERA_SLOT = 0x7FFFFFFF
# salts of the stratified draws (ops/wavefront.py and render/integrator.py
# of the JAX package)
SALT_AA = 0x68BC21EB
SALT_LENS = 0x51633E2D
SALT_TIME = 0x3504F333
SALT_BOUNCE = 0x2545F491
SALT_NEE_AREA = 0x7F4A7C15


def stratified_planes(iteration, depth: int, pixel_index: torch.Tensor,
                      num_dims: int, salt0: int) -> Tuple[torch.Tensor, ...]:
    """`num_dims` stratified uniform planes for (iteration, depth, pixel):
    CP-rotated R_d lattices (the JAX "lattice" impl), bit for bit."""
    dev = pixel_index.device
    it_f = torch.as_tensor(iteration, dtype=F32, device=dev)
    mix = (pixel_index.to(torch.int64) & _U32) ^ (
        (int(depth) * 0x9E3779B9) & _U32)
    return tuple(
        torch.fmod(0.5 + it_f * torch.tensor(a, dtype=F32, device=dev)
                   + _hash01(mix, salt0 + 101 * k), 1.0)
        for k, a in enumerate(_ALPHAS[num_dims][:num_dims]))


def generate_rays_planar(cam: dict, width: int, height: int,
                         generator: Optional[torch.Generator] = None,
                         antialias: bool = True, dof: bool = True,
                         motion: bool = True, stratified: bool = False,
                         iteration=None, cam_u: Optional[torch.Tensor] = None):
    """Primary rays as (origin V3, dir V3, time [N], pixel_index [N]), path i
    at pixel (i % W, i // W).

    Camera draws (AA jitter x/y, lens disk r/phi, shutter time) come from,
    in this order of precedence: `cam_u` [5, N] injected uniforms in that
    row order; the stratified lattice when `stratified` and `iteration` is
    given; else `torch.rand` on `generator`."""
    dev = cam["position"].device
    n = width * height
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    xi, yi = idx % width, idx // width
    pixel_index = xi + yi * width
    x = xi.to(F32)
    y = yi.to(F32)
    strat = stratified and iteration is not None

    def draw(num, salt, row):
        if cam_u is not None:
            return tuple(cam_u[row + i] for i in range(num))
        if strat:
            return stratified_planes(iteration, CAMERA_SLOT, pixel_index,
                                     num, salt)
        u = torch.rand((num * n,), generator=generator, dtype=F32, device=dev)
        return tuple(u[i * n:(i + 1) * n] for i in range(num))

    if antialias:
        u_ax, u_ay = draw(2, SALT_AA, 0)
        x = x + u_ax
        y = y + u_ay

    view, right, up = (vec.from_rows(cam[k]) for k in ("view", "right", "up"))
    plx, ply = cam["pixel_length"][0], cam["pixel_length"][1]
    sx = plx * (x - width * 0.5)
    sy = ply * (y - height * 0.5)
    d = vec.normalize(V3(view.x - right.x * sx - up.x * sy,
                         view.y - right.y * sx - up.y * sy,
                         view.z - right.z * sx - up.z * sy))
    o = vec.splat(cam["position"], like=x)

    if dof:
        aperture, focal = cam["aperture"], cam["focal_distance"]
        u_l0, u_l1 = draw(2, SALT_LENS, 2)
        r = torch.sqrt(u_l0) * aperture
        phi = u_l1 * TWO_PI
        lr, lu = r * torch.cos(phi), r * torch.sin(phi)
        o_dof = V3(o.x + right.x * lr + up.x * lu,
                   o.y + right.y * lr + up.y * lu,
                   o.z + right.z * lr + up.z * lu)
        f = _max(focal, 1e-6)
        focus = V3(o.x + d.x * f, o.y + d.y * f, o.z + d.z * f)
        d_dof = vec.normalize(focus - o_dof)
        use_dof = (aperture > 0.0) & (focal > 0.0)
        o = vec.where(use_dof, o_dof, o)
        d = vec.where(use_dof, d_dof, d)

    if motion:
        (u_t,) = draw(1, SALT_TIME, 4)
        times = u_t * cam["shutter"]
    else:
        times = torch.zeros((n,), dtype=F32, device=dev)
    return o, d, times, pixel_index


# ---------------------------------------------------------------------------
# Intersection
# ---------------------------------------------------------------------------

class HitP(NamedTuple):
    """Planar hit record. `point` is the 1e-4 backed-off hit point
    (getPointOnRay, src/intersections.h:27-29) that reflected and diffuse
    rays continue from; `surf` is the exact surface point that transmitted
    rays push through. `u`, `v` are the mesh hit's interpolated texture
    coordinates (0 on primitives: their uv comes with the texture slice)."""
    t: torch.Tensor        # [N]; -1 = miss (after intersect_planar)
    normal: V3
    mat_id: torch.Tensor   # [N] int64
    point: V3
    surf: V3
    u: torch.Tensor        # [N]
    v: torch.Tensor        # [N]
    outside: torch.Tensor  # [N] bool


def _nz(c: torch.Tensor) -> torch.Tensor:
    """Exact-zero direction components bumped to +-1e-12: slab decisions
    are those of 1/0 = inf, and 1/x's derivative stays finite."""
    return torch.where(c.abs() < 1e-12,
                       torch.where(c < 0, -1e-12, 1e-12).to(c.dtype), c)


def _box_local_planar(qo: V3, qd: V3):
    """Unit-cube slab test (src/intersections.h:48-90) with the axis
    argmax/argmin written as comparison selects (x > y > z tie priority)."""
    inv = V3(1.0 / _nz(qd.x), 1.0 / _nz(qd.y), 1.0 / _nz(qd.z))
    t1 = V3((-0.5 - qo.x) * inv.x, (-0.5 - qo.y) * inv.y,
            (-0.5 - qo.z) * inv.z)
    t2 = V3((0.5 - qo.x) * inv.x, (0.5 - qo.y) * inv.y, (0.5 - qo.z) * inv.z)
    ta = V3(*(torch.minimum(a, b) for a, b in zip(t1, t2)))
    tb = V3(*(torch.maximum(a, b) for a, b in zip(t1, t2)))
    one = torch.ones_like(qo.x)
    sign = V3(*(torch.where(b < a, one, -one) for a, b in zip(t1, t2)))
    neg_big = torch.full_like(qo.x, -BIG)
    tap = V3(*(torch.where(a > 0, a, neg_big) for a in ta))
    tmin = torch.maximum(tap.x, torch.maximum(tap.y, tap.z))
    tmax = torch.minimum(tb.x, torch.minimum(tb.y, tb.z))

    hit = (tmax >= tmin) & (tmax > 0)
    outside = tmin > 0
    t_obj = torch.where(outside, tmin, tmax)
    ex = torch.where(outside, tap.x == tmin, tb.x == tmax)
    ey = (~ex) & torch.where(outside, tap.y == tmin, tb.y == tmax)
    ez = ~(ex | ey)
    zero = torch.zeros_like(qo.x)
    n_local = V3(torch.where(ex, sign.x, zero), torch.where(ey, sign.y, zero),
                 torch.where(ez, sign.z, zero))
    return t_obj, hit, outside, n_local


def _sphere_local_planar(qo: V3, qd: V3):
    """r=0.5 sphere quadratic (src/intersections.h:102-144); the
    discriminant sqrt is double-where'd so miss lanes never take sqrt of
    a clamped zero."""
    v_dot_d = vec.dot(qo, qd)
    radicand = v_dot_d * v_dot_d - (vec.dot(qo, qo) - 0.25)
    has_root = radicand >= 0
    s = torch.sqrt(torch.where(has_root, _max(radicand, 0.0),
                               torch.ones_like(radicand)))
    t1 = -v_dot_d + s
    t2 = -v_dot_d - s
    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_obj = torch.where(both_pos, torch.minimum(t1, t2),
                        torch.maximum(t1, t2))
    return t_obj, has_root & ~both_neg, both_pos


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c rounded once, as a fused multiply-add: the float32 product is
    exact in float64, so only the sum rounds (twice, float64 then float32;
    that differs from a true FMA only at rare exact ties).

    The hit points need it. Object-space distances to a thin slab are ~100x
    the world ones (cornell's walls are scaled by 0.01), so the product
    t*dir reaches ~1e3, where a float32 rounding step (6e-5) eats most of
    the 1e-4 back-off: rounded separately, the continuation point lands on
    the wrong side of the surface often enough to shift cornell's image
    mean by ~5%. The JAX package's result depends on whether XLA fuses the
    expression (ROADMAP.md Queue 3); the CUDA kernel calls fmaf."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _primitive_hit_planar(o: V3, d: V3, times: torch.Tensor, geoms: T.Geoms,
                          g: int, gtype: int) -> HitP:
    """One primitive against the whole wavefront, elementwise."""
    inv = geoms.inverse_transform[g]
    fwd = geoms.transform[g]
    inv_tr = geoms.inverse_transpose[g]
    vel = geoms.velocity[g]
    velx, vely, velz = vel[0], vel[1], vel[2]

    o_shift = V3(o.x - velx * times, o.y - vely * times, o.z - velz * times)
    qo = vec.xform_pt(inv, o_shift)
    qd = vec.normalize(vec.xform_dir(inv, d))

    if gtype == T.CUBE:
        t_obj, hit, outside, n_local = _box_local_planar(qo, qd)
    else:
        t_obj, hit, outside = _sphere_local_planar(qo, qd)

    tb = t_obj - RAY_EPS
    ip_obj = V3(*(_fma(tb, q, p) for q, p in zip(qd, qo)))
    sf_obj = V3(*(_fma(t_obj, q, p) for q, p in zip(qd, qo)))
    ip_world = vec.xform_pt(fwd, ip_obj)
    ip_world = V3(ip_world.x + velx * times, ip_world.y + vely * times,
                  ip_world.z + velz * times)
    sf_world = vec.xform_pt(fwd, sf_obj)
    sf_world = V3(sf_world.x + velx * times, sf_world.y + vely * times,
                  sf_world.z + velz * times)
    t_world = vec.norm(o - ip_world)

    if gtype != T.CUBE:
        flip = torch.where(outside, 1.0, -1.0).to(F32)
        n_local = V3(ip_obj.x * flip, ip_obj.y * flip, ip_obj.z * flip)
    normal = vec.normalize(vec.xform_dir(inv_tr, n_local))
    zero = torch.zeros_like(t_world)
    return HitP(t=torch.where(hit, t_world, torch.full_like(t_world, BIG)),
                normal=normal,
                mat_id=geoms.material_id[g].to(torch.int64).expand_as(
                    t_world),
                point=ip_world, surf=sf_world, u=zero, v=zero,
                outside=outside)


def mesh_query(o: V3, d: V3, times: torch.Tensor, geoms: T.Geoms, g: int,
               t_world_bound: Optional[torch.Tensor] = None,
               alive: Optional[torch.Tensor] = None):
    """The traversal's inputs for MESH geom g: object-space rays (qo, qd
    normalised) and the object-space bound t_bound [N].

    The occlusion bound turns a world distance into object units: the world
    distance along the ray is t_obj * |M_linear qd| for an affine M, and a
    small slack (x1.0005 + 1e-3) keeps borderline hits for the world-space
    merge to decide. Dead lanes (`alive` False) get the bound -1, so they
    never enter a box or a leaf."""
    inv = geoms.inverse_transform[g]
    vel = geoms.velocity[g]
    o_shift = V3(o.x - vel[0] * times, o.y - vel[1] * times,
                 o.z - vel[2] * times)
    qo = vec.xform_pt(inv, o_shift)
    qd = vec.normalize(vec.xform_dir(inv, d))
    t_bound = torch.full_like(qo.x, PB.BIG)
    if t_world_bound is not None:
        md = vec.xform_dir(geoms.transform[g], qd)
        t_bound = (t_world_bound / torch.clamp(vec.norm(md), min=1e-12)
                   * 1.0005 + 1e-3)
    if alive is not None:
        t_bound = torch.where(alive, t_bound, torch.full_like(t_bound, -1.0))
    return qo, qd, t_bound.detach()


def _mesh_hit_packet(o: V3, d: V3, times: torch.Tensor, geoms: T.Geoms,
                     packed, g: int,
                     t_world_bound: Optional[torch.Tensor] = None,
                     alive: Optional[torch.Tensor] = None,
                     meshes: Optional[T.MeshBundle] = None,
                     differentiable: bool = False,
                     tri_offset=0, any_hit: bool = False) -> HitP:
    """MESH geom g through its packed BVH: kernel K2 for a PackedMesh8, K3
    for a binary PackedMesh (the JAX `_mesh_hit_packet`).

    `any_hit` (shadow rays) runs K2 in its occlusion mode: a ray stops at
    the first leaf where it accepts a triangle, so only `t` says anything.
    The binary tree has no such mode and runs K3's nearest hit under the
    same bound, as the JAX package does.

    The traversal is a discrete decision and carries no gradient: its rays
    and outputs are detached. With `differentiable`, t, the barycentrics,
    the smooth normal and the uv are recomputed from the winning triangle
    (row `tri + tri_offset` of the global `meshes` bundle) by
    Moller-Trumbore in torch ops, so gradients reach the camera through the
    object-space ray. The hit point is rebuilt in object space as
    qo + (t - 1e-4)*qd with a fused multiply-add (the primitive path's
    rule, ROADMAP F3), taken back to world space with the velocity shift,
    and the normal is flipped two-sided toward the incoming ray."""
    qo, qd, t_bound = mesh_query(o, d, times, geoms, g, t_world_bound, alive)
    q_o = tuple(c.detach() for c in qo)
    q_d = tuple(c.detach() for c in qd)
    if isinstance(packed, B8.PackedMesh8):
        t_obj, nl, u, v, tri = B8.traverse8(q_o, q_d, packed, t_bound=t_bound,
                                            any_hit=any_hit)
    else:
        t_obj, nl, u, v, tri = PB.traverse(q_o, q_d, packed, t_bound=t_bound)
    hit = tri >= 0

    if differentiable:
        tri_g = torch.clamp(tri, min=0).to(torch.int64) + tri_offset

        def take(table):
            return vec.from_rows(table[tri_g])
        v0, e1, e2 = (take(meshes.tri_v0), take(meshes.tri_e1),
                      take(meshes.tri_e2))
        pvec = vec.cross(qd, e2)
        det = vec.dot(e1, pvec)
        # double where: a dead lane's det of 0 must not turn 1/det's
        # infinite derivative into a NaN gradient
        ok = det.abs() > 1e-12
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det,
                                                    torch.ones_like(det)),
                              torch.zeros_like(det))
        tvec = qo - v0
        bu = vec.dot(tvec, pvec) * inv_det
        qvec = vec.cross(tvec, e1)
        bv = vec.dot(qd, qvec) * inv_det
        t_obj = vec.dot(e2, qvec) * inv_det
        bw = 1.0 - bu - bv
        n0, n1, n2 = (take(meshes.tri_n0), take(meshes.tri_n1),
                      take(meshes.tri_n2))
        nl = tuple(bw * a + bu * b + bv * c for a, b, c in zip(n0, n1, n2))
        uv0, uv1, uv2 = (meshes.tri_uv0[tri_g], meshes.tri_uv1[tri_g],
                         meshes.tri_uv2[tri_g])
        u = bw * uv0[:, 0] + bu * uv1[:, 0] + bv * uv2[:, 0]
        v = bw * uv0[:, 1] + bu * uv1[:, 1] + bv * uv2[:, 1]

    fwd = geoms.transform[g]
    vel = geoms.velocity[g]
    tb = t_obj - RAY_EPS
    ip_obj = V3(*(_fma(tb, q, p) for q, p in zip(qd, qo)))
    sf_obj = V3(*(_fma(t_obj, q, p) for q, p in zip(qd, qo)))
    ip_world = vec.xform_pt(fwd, ip_obj)
    ip_world = V3(ip_world.x + vel[0] * times, ip_world.y + vel[1] * times,
                  ip_world.z + vel[2] * times)
    sf_world = vec.xform_pt(fwd, sf_obj)
    sf_world = V3(sf_world.x + vel[0] * times, sf_world.y + vel[1] * times,
                  sf_world.z + vel[2] * times)
    t_world = torch.where(hit, vec.norm(o - ip_world),
                          torch.full_like(t_obj, BIG))

    normal = vec.normalize(vec.xform_dir(geoms.inverse_transpose[g],
                                         V3(*nl)))
    facing = vec.dot(normal, d) < 0   # two-sided: open surfaces
    normal = vec.where(facing, normal, -normal)
    return HitP(t=t_world, normal=normal,
                mat_id=geoms.material_id[g].to(torch.int64).expand_as(
                    t_world),
                point=ip_world, surf=sf_world, u=u, v=v, outside=facing)


# Spheres tested per step of the batched sphere pass: each step computes a
# [K, N] block and keeps only the running (t_best, winner).
SPHERE_BATCH_K = 16


def _batched_spheres_planar(o: V3, d: V3, times: torch.Tensor,
                            geoms: T.Geoms, idxs: Sequence[int]) -> HitP:
    """Every sphere of `idxs` against the wavefront in one blocked pass (the
    JAX `_batched_spheres_planar`): the many-light path, where the per-geom
    unroll would enqueue one primitive test per emitter.

    Eligible spheres (render/integrator._eligible_sphere_batch) have a
    uniform scale, so each is a world-space centre and radius, and an
    untextured material, so no lane reads its uv. Each step tests
    SPHERE_BATCH_K spheres as one [K, N] block and carries only (t_best,
    winner); the winner's attributes are recomputed at the end. The
    semantics are `_primitive_hit_planar`'s for a sphere: the first sphere
    with the smallest positive world distance wins, the point backs off
    RAY_EPS object units (RAY_EPS * 2r in the world), interior hits flip
    the normal."""
    dev = o.x.device
    gi = torch.as_tensor(list(idxs), dtype=torch.int64, device=dev)
    tm = geoms.transform[gi]                              # [B,4,4]
    cx, cy, cz = tm[:, 0, 3], tm[:, 1, 3], tm[:, 2, 3]
    r = 0.5 * torch.sqrt(tm[:, 0, 0] * tm[:, 0, 0] + tm[:, 1, 0] * tm[:, 1, 0]
                         + tm[:, 2, 0] * tm[:, 2, 0])
    vel = geoms.velocity[gi]                              # [B,3]
    mid = geoms.material_id[gi].to(torch.int64)
    n, b_count = o.x.shape[0], len(idxs)
    t_best = torch.full((n,), BIG, dtype=F32, device=dev)
    i_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for base in range(0, b_count, SPHERE_BATCH_K):
        sl = slice(base, min(base + SPHERE_BATCH_K, b_count))
        col = lambda a: a[sl, None]  # noqa: E731  [K,1] against [N]
        ocx = o.x - col(vel[:, 0]) * times - col(cx)
        ocy = o.y - col(vel[:, 1]) * times - col(cy)
        ocz = o.z - col(vel[:, 2]) * times - col(cz)
        bq = ocx * d.x + ocy * d.y + ocz * d.z
        cq = ocx * ocx + ocy * ocy + ocz * ocz - col(r) * col(r)
        disc = bq * bq - cq
        has = disc >= 0.0
        # double where (see _sphere_local_planar)
        sq = torch.sqrt(torch.where(has, _max(disc, 0.0),
                                    torch.ones_like(disc)))
        t1 = -bq + sq
        t2 = -bq - sq
        both_neg = (t1 < 0) & (t2 < 0)
        both_pos = (t1 > 0) & (t2 > 0)
        t_c = torch.where(both_pos, torch.minimum(t1, t2),
                          torch.maximum(t1, t2))
        t_c = torch.where(has & ~both_neg, t_c, torch.full_like(t_c, BIG))
        # the first of the block's smallest t: the strict `<` merge of the
        # spheres one by one
        t_blk, j_blk = torch.min(t_c, dim=0)
        closer = t_blk < t_best
        t_best = torch.where(closer, t_blk, t_best)
        i_best = torch.where(closer, j_blk + base, i_best)

    got = i_best >= 0
    iw = torch.clamp(i_best, 0, b_count - 1)
    rw = _max(r[iw], 1e-12)
    # the centre moved into the ray's time frame (the primitive path moves
    # the origin out of it)
    cwx = cx[iw] + vel[iw, 0] * times
    cwy = cy[iw] + vel[iw, 1] * times
    cwz = cz[iw] + vel[iw, 2] * times
    surf = V3(o.x + t_best * d.x, o.y + t_best * d.y, o.z + t_best * d.z)
    tb = t_best - (2.0 * RAY_EPS) * rw
    point = V3(o.x + tb * d.x, o.y + tb * d.y, o.z + tb * d.z)
    inv_r = 1.0 / rw
    nr = V3((surf.x - cwx) * inv_r, (surf.y - cwy) * inv_r,
            (surf.z - cwz) * inv_r)
    ox_c, oy_c, oz_c = o.x - cwx, o.y - cwy, o.z - cwz
    outside = ox_c * ox_c + oy_c * oy_c + oz_c * oz_c > rw * rw
    flip = torch.where(outside, 1.0, -1.0).to(F32)
    normal = vec.normalize(V3(nr.x * flip, nr.y * flip, nr.z * flip))
    half = torch.full((n,), 0.5, dtype=F32, device=dev)  # uv: unread
    return HitP(t=torch.where(got, t_best, torch.full_like(t_best, BIG)),
                normal=normal, mat_id=mid[iw], point=point, surf=surf,
                u=half, v=half, outside=outside)


def intersect_planar(o: V3, d: V3, times: torch.Tensor, geoms: T.Geoms,
                     geom_types: Sequence[int], packed_meshes: tuple = (),
                     mesh_ids: Sequence[int] = (),
                     alive: Optional[torch.Tensor] = None,
                     meshes: Optional[T.MeshBundle] = None,
                     differentiable_mesh: bool = False,
                     any_hit: bool = False,
                     max_t: Optional[torch.Tensor] = None,
                     sphere_batch: Sequence[int] = ()) -> HitP:
    """Nearest hit over all geoms (src/pathtrace.cu:176-199): a strict `<`
    merge in geom order, then misses become t = -1, material 0.

    Primitives are tested first (the spheres of `sphere_batch` in one
    `_batched_spheres_planar` pass, before the others); their nearest hit
    becomes the meshes' occlusion bound. MESH geom g traverses
    `packed_meshes[mesh_ids[g]]`, and `alive` ([N] bool) marks the lanes
    that may still hit: dead lanes take no part in the traversal.
    `differentiable_mesh` recomputes the mesh hits from the bundle `meshes`
    (`_mesh_hit_packet`).

    Occlusion queries (NEE shadow rays): `max_t` ([N]) caps the search, so
    a hit beyond it reports a miss (t = -1) and mesh subtrees beyond it are
    pruned; `any_hit` runs the 8-wide traversal in its occlusion mode. Only
    `t > 0` of such a query means anything."""
    for g, gtype in enumerate(geom_types):
        if gtype == T.MESH:
            mid = mesh_ids[g] if g < len(mesh_ids) else -1
            if not 0 <= mid < len(packed_meshes):
                raise ValueError(f"mesh geom {g} has no packed mesh "
                                 f"(mesh id {mid}, {len(packed_meshes)} "
                                 "packed)")
            if differentiable_mesh and meshes is None:
                raise ValueError("differentiable_mesh needs the MeshBundle")
        elif gtype not in (T.CUBE, T.SPHERE):
            raise NotImplementedError(
                "only cube, sphere and mesh geoms are ported (SDFs: "
                "ROADMAP slice E)")
    n = o.x.shape[0]
    z = torch.zeros((n,), dtype=F32, device=o.x.device)
    t_init = (torch.full((n,), BIG, dtype=F32, device=o.x.device)
              if max_t is None else torch.clamp(max_t, max=BIG))
    best = HitP(t=t_init,
                normal=V3(z, z, z),
                mat_id=torch.zeros((n,), dtype=torch.int64,
                                   device=o.x.device),
                point=V3(z, z, z), surf=V3(z, z, z), u=z, v=z,
                outside=torch.ones((n,), dtype=torch.bool, device=o.x.device))

    def merge(best: HitP, cand: HitP) -> HitP:
        closer = cand.t < best.t
        return HitP(t=torch.where(closer, cand.t, best.t),
                    normal=vec.where(closer, cand.normal, best.normal),
                    mat_id=torch.where(closer, cand.mat_id, best.mat_id),
                    point=vec.where(closer, cand.point, best.point),
                    surf=vec.where(closer, cand.surf, best.surf),
                    u=torch.where(closer, cand.u, best.u),
                    v=torch.where(closer, cand.v, best.v),
                    outside=torch.where(closer, cand.outside, best.outside))

    batched = set(sphere_batch)
    if batched:
        best = merge(best, _batched_spheres_planar(o, d, times, geoms,
                                                   sphere_batch))
    for g, gtype in enumerate(geom_types):
        if gtype != T.MESH and g not in batched:
            best = merge(best, _primitive_hit_planar(o, d, times, geoms, g,
                                                     gtype))
    for g, gtype in enumerate(geom_types):
        if gtype == T.MESH:
            mid = mesh_ids[g]
            best = merge(best, _mesh_hit_packet(
                o, d, times, geoms, packed_meshes[mid], g,
                t_world_bound=best.t, alive=alive, meshes=meshes,
                differentiable=differentiable_mesh,
                tri_offset=(meshes.mesh_tri_offset[mid].to(torch.int64)
                            if differentiable_mesh else 0),
                any_hit=any_hit))
    miss = best.t >= t_init
    return best._replace(t=torch.where(miss, -1.0, best.t),
                         mat_id=torch.where(miss, 0, best.mat_id))


# ---------------------------------------------------------------------------
# Shading (reference contract: src/interactions.h:44-79, pathtrace.cu:224-266)
# ---------------------------------------------------------------------------

class ShadeOutP(NamedTuple):
    origin: V3
    direction: V3
    throughput: V3
    radiance: V3
    alive: torch.Tensor
    # under NEE: the chosen lobe's pdf of the new direction (0 for the delta
    # lobes), which MIS-weights the next bounce's emissive hit; else None
    nee_pdf: Optional[torch.Tensor] = None


def _mat_select(table: torch.Tensor, mat_id: torch.Tensor):
    """Per-lane material fetch from an [M] or [M,3] table."""
    rows = table[mat_id]
    if table.ndim == 1:
        return rows
    return V3(rows[:, 0], rows[:, 1], rows[:, 2])


def cosine_hemisphere_planar(n: V3, u1, u2) -> V3:
    """calculateRandomDirectionInHemisphere (src/interactions.h:10-42)."""
    up = torch.sqrt(u1)
    over = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    around = u2 * TWO_PI
    pick_x = n.x.abs() < SQRT_OF_ONE_THIRD
    pick_y = (~pick_x) & (n.y.abs() < SQRT_OF_ONE_THIRD)
    not_n = V3(pick_x.to(F32), pick_y.to(F32), (~(pick_x | pick_y)).to(F32))
    p1 = vec.normalize(vec.cross(n, not_n))
    p2 = vec.normalize(vec.cross(n, p1))
    c = torch.cos(around) * over
    s = torch.sin(around) * over
    return V3(up * n.x + c * p1.x + s * p2.x,
              up * n.y + c * p1.y + s * p2.y,
              up * n.z + c * p1.z + s * p2.z)


def reflect_planar(d: V3, n: V3) -> V3:
    k = 2.0 * vec.dot(d, n)
    return V3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z)


def _pow5(x: torch.Tensor) -> torch.Tensor:
    """x**5 as jax.lax.integer_pow evaluates it: x * ((x*x) * (x*x))."""
    x2 = x * x
    return x * (x2 * x2)


def shade_planar(hit: HitP, ray_d: V3, throughput: V3, alive: torch.Tensor,
                 materials: T.Materials, textures: T.Textures,
                 uniforms: Sequence[torch.Tensor],
                 last_bounce: torch.Tensor, glossy: bool = True,
                 nee: Optional[tuple] = None,
                 nee_area: float = 0.0) -> ShadeOutP:
    """One scattering step over the wavefront; `uniforms` holds the four
    planes (u_lobe, u1, u2, u_fresnel). The JAX `shade_planar` with sky
    off, area-light NEE or none.

    `nee` (None = BSDF sampling alone) is the tuple (wl V3, vis [N] bool,
    le V3, pdf_l [N], prev_pdf [N]): this bounce's shadow-tested light
    sample (direction, visibility, emitted radiance, the light sampler's
    solid-angle pdf) and the previous bounce's lobe pdf. Light and BSDF
    sampling combine by the one-sample balance heuristic: the direct term
    of the diffuse and glossy lobes is weighted pdf_bsdf / (pdf_l +
    pdf_bsdf), and with `nee_area` > 0 (the light union's area) an
    emissive BSDF hit is weighted prev_pdf / (prev_pdf + pdf_l(hit)), with
    pdf_l(hit) = t^2 / (|cos| * area) and prev_pdf == 0 (camera, mirror,
    refraction) meaning full weight. The direct term is skipped on the last
    bounce, so the estimator covers the plain one's transport at equal
    depth. The lobe's pdf of the new direction comes back as `nee_pdf`.

    Detach convention: the lobe and Fresnel decisions and the diffuse
    direction are detached; the mirror, refraction and glossy directions
    keep their dependence on the materials (the training slice relies on
    it)."""
    mat_id = hit.mat_id
    albedo = _mat_select(materials.color, mat_id)
    spec_color = _mat_select(materials.specular_color, mat_id)
    emittance = _mat_select(materials.emittance, mat_id)
    p_refr = _clip(_mat_select(materials.has_refractive, mat_id), 0.0, 1.0)
    p_spec = (_clip(_mat_select(materials.has_reflective, mat_id), 0.0, 1.0)
              * (1.0 - p_refr))
    p_diff = _max(1.0 - p_refr - p_spec, 0.0)
    ior = _mat_select(materials.ior, mat_id)

    hit_ok = hit.t > 0.0
    is_light = hit_ok & (emittance > 0.0)
    missed = ~hit_ok

    e = textures.env[0, 0].to(hit.t.device) * textures.env_enabled.to(
        hit.t.device)
    env = vec.splat(e, like=hit.t)

    lit = alive & is_light
    mis = alive & missed
    zero = torch.zeros_like(hit.t)
    rad_scale = torch.where(lit, emittance, zero)
    if nee is not None and nee_area > 0.0:
        prev_pdf = nee[4]
        cos_l_hit = torch.abs(vec.dot(hit.normal, ray_d))
        pdf_l_hit = (hit.t * hit.t) / _max(cos_l_hit * nee_area, 1e-9)
        w_hit = torch.where(prev_pdf > 0.0,
                            prev_pdf / _max(prev_pdf + pdf_l_hit, 1e-30),
                            torch.ones_like(prev_pdf))
        rad_scale = rad_scale * w_hit
    radiance = V3(*(torch.where(lit, th * al * rad_scale,
                                torch.where(mis, th * en, zero))
                    for th, al, en in zip(throughput, albedo, env)))

    u_lobe = uniforms[0].detach()
    take_refr = u_lobe < p_refr
    take_spec = (~take_refr) & (u_lobe < p_refr + p_spec)

    n = hit.normal
    d_diff = cosine_hemisphere_planar(n, uniforms[1], uniforms[2])
    d_spec = reflect_planar(ray_d, n)
    d_mirror = d_spec  # the mirror axis (the glossy lobe's pdf under NEE)

    if glossy:
        # Phong cos^n lobe around the mirror axis (SPECEX > 0)
        spec_exp = _mat_select(materials.specular_exponent, mat_id)
        cos_a = torch.pow(torch.clamp(uniforms[1], 1e-9, 1.0),
                          1.0 / (spec_exp + 1.0))
        sin_a = torch.sqrt(_max(1.0 - cos_a * cos_a, 1e-20))
        phi_g = uniforms[2] * TWO_PI
        pick_gx = d_spec.x.abs() < SQRT_OF_ONE_THIRD
        pick_gy = (~pick_gx) & (d_spec.y.abs() < SQRT_OF_ONE_THIRD)
        not_s = V3(pick_gx.to(F32), pick_gy.to(F32),
                   (~(pick_gx | pick_gy)).to(F32))
        g1 = vec.normalize(vec.cross(d_spec, not_s))
        g2 = vec.cross(d_spec, g1)
        cg = torch.cos(phi_g) * sin_a
        sg = torch.sin(phi_g) * sin_a
        d_gloss = V3(cos_a * d_spec.x + cg * g1.x + sg * g2.x,
                     cos_a * d_spec.y + cg * g1.y + sg * g2.y,
                     cos_a * d_spec.z + cg * g1.z + sg * g2.z)
        above = vec.dot(d_gloss, n) > 0.0
        d_gloss = vec.where(above, d_gloss, d_spec)
        d_spec = vec.where(spec_exp > 0.0, d_gloss, d_spec)

    outside = hit.outside
    safe_ior = _max(ior, 1e-6)
    one = torch.ones_like(ior)
    eta = torch.where(outside, 1.0 / safe_ior, safe_ior)
    cos_i = _clip(-vec.dot(ray_d, n), 0.0, 1.0)
    eta_i = torch.where(outside, one, ior)
    eta_t = torch.where(outside, ior, one)
    q = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = q * q
    fres = r0 + (1.0 - r0) * _pow5(1.0 - cos_i)

    sin2_t = eta * eta * _max(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(_max(1.0 - sin2_t, 1e-20))
    k_r = eta * cos_i - cos_t
    d_refr = V3(eta * ray_d.x + k_r * n.x,
                eta * ray_d.y + k_r * n.y,
                eta * ray_d.z + k_r * n.z)
    refl_instead = tir | (uniforms[3].detach() < fres.detach())
    d_refr = vec.where(refl_instead, d_spec, d_refr)

    d_diff = V3(*(c.detach() for c in d_diff))
    new_dir = vec.normalize(vec.where(take_refr, d_refr,
                                      vec.where(take_spec, d_spec, d_diff)))

    if nee is not None:
        # the direct term through the non-delta lobes, each MIS-weighted:
        #   diffuse: albedo * le * pdf_bd / (pdf_l + pdf_bd)
        #   glossy:  spec_color * le * q_l / (pdf_l + p_spec * q_l)
        # pdf_bd = p_diff * cos_s / pi, q_l = (e+1)/(2 pi) * cos^e of the
        # angle to the mirror axis
        wl, vis, le_n, pdf_l = nee[0], nee[1], nee[2], nee[3]
        cos_s = _max(vec.dot(hit.normal, wl), 0.0)
        nee_ok = alive & hit_ok & ~is_light & ~last_bounce & vis
        pdf_bd = p_diff * cos_s * (1.0 / math.pi)
        wd = torch.where(nee_ok, pdf_bd / (pdf_l + pdf_bd + 1e-30), zero)
        f = V3(albedo.x * wd, albedo.y * wd, albedo.z * wd)
        if glossy:
            cos_al = _clip(vec.dot(wl, d_mirror), 1e-9, 1.0)
            q_l = ((spec_exp + 1.0) * (0.5 / math.pi)
                   * torch.pow(cos_al, spec_exp))
            q_l = torch.where((spec_exp > 0.0) & (cos_s > 0.0), q_l, zero)
            wg = torch.where(nee_ok,
                             q_l / (pdf_l + p_spec * q_l + 1e-30), zero)
            f = V3(f.x + spec_color.x * wg, f.y + spec_color.y * wg,
                   f.z + spec_color.z * wg)
        radiance = V3(*(r + th * le * fc for r, th, le, fc
                        in zip(radiance, throughput, le_n, f)))

    inv_pd = 1.0 / _max(p_diff, 1e-6)
    inv_ps = 1.0 / _max(p_spec, 1e-6)
    inv_pr = 1.0 / _max(p_refr, 1e-6)
    factor = vec.where(take_refr, spec_color * inv_pr,
                       vec.where(take_spec, spec_color * inv_ps,
                                 albedo * inv_pd))

    scattering = alive & hit_ok & ~is_light
    new_throughput = vec.where(scattering, throughput * factor, throughput)

    # transmitted rays start just past the EXACT surface point; reflected and
    # diffuse rays keep the backed-off point (the safe side of the surface)
    transmit = take_refr & ~refl_instead
    push = torch.where(transmit, 2.0 * RAY_EPS, 0.0).to(F32)
    new_origin = V3(*(torch.where(transmit, s, p) + push * nd
                      for s, p, nd in zip(hit.surf, hit.point, new_dir)))
    still_alive = scattering & ~last_bounce
    nee_pdf = None
    if nee is not None:
        # the chosen lobe's density at the chosen direction; 0 for the
        # delta lobes (mirror, refraction, the glossy fallback), which NEE
        # never covers
        take_diff = still_alive & ~take_refr & ~take_spec
        cos_next = _max(vec.dot(n, new_dir), 0.0)
        nee_pdf = torch.where(take_diff, p_diff * cos_next * (1.0 / math.pi),
                              zero)
        if glossy:
            q_samp = ((spec_exp + 1.0) * (0.5 / math.pi)
                      * torch.pow(_clip(cos_a, 1e-9, 1.0), spec_exp))
            gloss = still_alive & take_spec & (spec_exp > 0.0) & above
            nee_pdf = torch.where(gloss, p_spec * q_samp, nee_pdf)
    return ShadeOutP(origin=new_origin, direction=new_dir,
                     throughput=new_throughput, radiance=radiance,
                     alive=still_alive, nee_pdf=nee_pdf)
