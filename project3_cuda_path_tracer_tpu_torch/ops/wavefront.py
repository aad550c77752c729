"""Planar wavefront stages in torch ops: ray generation, intersection, shading.

Counterpart of the primitive path of project3_cuda_path_tracer_tpu/ops/
wavefront.py, function for function and with the same arithmetic, so that
the tests can hold each stage against the JAX one on the same inputs. These
stages are the plain version of the CUDA megakernel (csrc/megakernel.cu):
`render.integrator.trace_wavefront` chains them into one iteration.

Scope: cubes, spheres and triangle meshes (through the BVH traversal
kernels of ops/bvh8.py and ops/pallas_bvh.py) with their uv and, for normal
maps, uv tangents; textured albedo (the atlas, nearest or bilinear, and
--bilinear-fast's pair planes), the procedural checker, bump and
tangent-space normal maps; a constant or equirect environment and the
procedural sky; the optional glossy Phong lobe, Fresnel refraction; direct
lighting from area lights, the env map or both with one-sample MIS
(ops/nee.py: the shadow rays are occlusion queries of `intersect_planar`,
the MIS terms live in `shade_planar`), and the batched sphere pass of
many-light scenes; SDF primitives sphere-traced in object space
(ops/sdf.py) and spectral dispersion in the refractive lobe. Every 32-bit
texel fetch goes through `ops.texfetch.take_u32` (kernel P1 on the card).
The stratified draws come from the CP-rotated lattices or from Owen-
scrambled Sobol pairs (ops/qmc.py).

Reference: src/intersections.h:27-144 (slab + quadratic in object space,
world-distance t, 1e-4 back-off) and scatterRay, src/interactions.h:44-79.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import bvh8 as B8
from . import matgrad
from . import pallas_bvh as PB
from . import qmc
from . import sdf as S
from . import texfetch
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


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """torch.atan2 whose value for a lane does not depend on where the lane
    sits in the wavefront. On the CPU torch computes the last few lanes of
    each thread's range with a scalar routine that differs from its vector
    one in the last bit, so a permuted wavefront (sort/compact) would change
    those lanes; the float64 evaluation, rounded, hides that difference. On
    the card every lane runs the same code."""
    if y.is_cuda:
        return torch.atan2(y, x)
    return torch.atan2(y.double(), x.double()).to(y.dtype)


def _pow(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """torch.pow with a tensor exponent, lane-position invariant as
    `_atan2`."""
    if x.is_cuda:
        return torch.pow(x, e)
    return torch.pow(x.double(), torch.as_tensor(e).double()).to(x.dtype)


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
_R8A = (0.921599319633983, 0.8493453059498204,
        0.7827560560976716, 0.721387448738994,
        0.6648301819503516, 0.6127070433575812,
        0.5646703942932961, 0.5203998511981547)
_PHI_INV = 0.6180339887498949
_ALPHAS = {1: (_PHI_INV,), 2: _R2A, 3: _R3A, 4: _R4A,
           5: _R4A + (_PHI_INV,), 8: _R8A}

# "depth" slot of the camera dims (distinct from every bounce depth)
CAMERA_SLOT = 0x7FFFFFFF
# salts of the stratified draws (ops/wavefront.py and render/integrator.py
# of the JAX package)
SALT_AA = 0x68BC21EB
SALT_LENS = 0x51633E2D
SALT_TIME = 0x3504F333
SALT_BOUNCE = 0x2545F491
SALT_NEE_AREA = 0x7F4A7C15
SALT_NEE_ENV = 0x1D872B41
SALT_NEE_MIXED = 0x5B7E9D23
SALT_RR = 0x68E31DA4  # Russian roulette's survival draw
STRAT_IMPLS = ("lattice", "sobol")


def stratified_planes(iteration, depth: int, pixel_index: torch.Tensor,
                      num_dims: int, salt0: int,
                      impl: str = "lattice") -> Tuple[torch.Tensor, ...]:
    """`num_dims` stratified uniform planes for (iteration, depth, pixel),
    bit for bit with the JAX `stratified_planes`: CP-rotated R_d lattices
    ("lattice"), or padded Owen-scrambled Sobol pairs ("sobol",
    ops/qmc.sample_planes). Both are keyed only on (iteration, depth,
    pixel), so a permuted wavefront draws the same values.

    `iteration` is an int or a 0-dim integer tensor on the pixels' device
    (the Renderer's, which a captured iteration graph reads at each
    replay); both give the same bits. The lattice's constants are CPU
    scalars, so the draw copies nothing from the host."""
    if impl == "sobol":
        return qmc.sample_planes(iteration, depth, pixel_index, num_dims,
                                 salt0)
    if impl != "lattice":
        raise ValueError(f"stratified sampler must be one of {STRAT_IMPLS}, "
                         f"got {impl!r}")
    dev = pixel_index.device
    it_f = torch.as_tensor(iteration, device=dev).to(F32)
    mix = (pixel_index.to(torch.int64) & _U32) ^ (
        (int(depth) * 0x9E3779B9) & _U32)
    return tuple(
        torch.fmod(0.5 + it_f * torch.tensor(a, dtype=F32)
                   + _hash01(mix, salt0 + 101 * k), 1.0)
        for k, a in enumerate(_ALPHAS[num_dims][:num_dims]))


def rand_planes(generator: Optional[torch.Generator], rows: int, n: int,
                dev, frame_range: Tuple[int, ...] = (),
                full: int = 0) -> torch.Tensor:
    """[rows, n] uniforms from `generator`, drawn as one rows*n call; with
    `frame_range` (lo, hi), drawn for the `full` lanes of the whole frame
    and sliced to lo..hi-1, so a sharded trace sees the numbers of the
    single-process one (each rank pays for the whole frame's draws)."""
    if not frame_range:
        return torch.rand((rows * n,), generator=generator, dtype=F32,
                          device=dev).reshape(rows, n)
    lo, hi = frame_range
    return torch.rand((rows * full,), generator=generator, dtype=F32,
                      device=dev).reshape(rows, full)[:, lo:hi]


def generate_rays_planar(cam: dict, width: int, height: int,
                         generator: Optional[torch.Generator] = None,
                         antialias: bool = True, dof: bool = True,
                         motion: bool = True, stratified: bool = False,
                         iteration=None, cam_u: Optional[torch.Tensor] = None,
                         strat_impl: str = "lattice",
                         pixel_override: Optional[torch.Tensor] = None,
                         strat_index: Optional[torch.Tensor] = None,
                         frame_range: Tuple[int, ...] = ()):
    """Primary rays as (origin V3, dir V3, time [N], pixel_index [N]), path i
    at pixel (i % W, i // W).

    Camera draws (AA jitter x/y, lens disk r/phi, shutter time) come from,
    in this order of precedence: `cam_u` [5, N] injected uniforms in that
    row order; the stratified sampler `strat_impl` when `stratified` and
    `iteration` is given; else `torch.rand` on `generator`.

    Adaptive sampling (render/adaptive.py): under `pixel_override` ([N]
    pixel ids, several paths may share one) path i shoots at pixel
    pixel_override[i], and N is the override's length. `strat_index` ([N],
    the surrogate pixel + occurrence * W*H, below 2^31) then keys the
    stratified draws, so that co-located paths draw distinct samples.

    Sharding (parallel/sharding.py): `frame_range` (lo, hi) traces the
    paths lo..hi-1 of the frame, and its `torch.rand` draws are taken for
    the whole W*H frame and sliced, so that the rows of a sharded frame
    equal the single-process frame's."""
    dev = cam["position"].device
    full = width * height
    lo, hi = frame_range if frame_range else (0, full)
    if frame_range:
        pix = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        n = hi - lo
        xi, yi = pix % width, pix // width
    elif pixel_override is not None:
        pix = pixel_override.to(device=dev, dtype=torch.int64)
        n = pix.shape[0]
        xi, yi = pix % width, pix // width
    else:
        n = width * height
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        xi, yi = idx % width, idx // width
    pixel_index = xi + yi * width
    samp_key = pixel_index if strat_index is None else strat_index.to(
        device=dev, dtype=torch.int64)
    x = xi.to(F32)
    y = yi.to(F32)
    strat = stratified and iteration is not None

    def draw(num, salt, row):
        if cam_u is not None:
            return tuple(cam_u[row + i] for i in range(num))
        if strat:
            return stratified_planes(iteration, CAMERA_SLOT, samp_key,
                                     num, salt, impl=strat_impl)
        u = rand_planes(generator, num, n, dev, frame_range, full)
        return tuple(u[i] for i in range(num))

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
    rays push through. `u`, `v` are the texture coordinates: a cube face's
    planar uv, a sphere's equirect uv, a mesh hit's interpolated uv. `tan`
    is the world-space dP/du (unnormalised), only under
    `intersect_planar(tangents=True)`: the normal map's frame."""
    t: torch.Tensor        # [N]; -1 = miss (after intersect_planar)
    normal: V3
    mat_id: torch.Tensor   # [N] int64
    point: V3
    surf: V3
    u: torch.Tensor        # [N]
    v: torch.Tensor        # [N]
    outside: torch.Tensor  # [N] bool
    tan: Optional[V3] = None


def _nz(c: torch.Tensor) -> torch.Tensor:
    """Exact-zero direction components bumped to +-1e-12: slab decisions
    are those of 1/0 = inf, and 1/x's derivative stays finite."""
    return torch.where(c.abs() < 1e-12,
                       torch.where(c < 0, -1e-12, 1e-12).to(c.dtype), c)


def _box_local_planar(qo: V3, qd: V3):
    """Unit-cube slab test (src/intersections.h:48-90) with the axis
    argmax/argmin written as comparison selects (x > y > z tie priority).
    Also returns the face masks ex, ez, which pick the face's uv axes."""
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
    return t_obj, hit, outside, n_local, ex, ez


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
                          g: int, gtype: int,
                          tangents: bool = False) -> HitP:
    """One primitive against the whole wavefront, elementwise, with its uv
    (a cube face parameterised by two object axes, a sphere by longitude
    and latitude) and, with `tangents`, dP/du in the world."""
    inv = geoms.inverse_transform[g]
    fwd = geoms.transform[g]
    inv_tr = geoms.inverse_transpose[g]
    vel = geoms.velocity[g]
    velx, vely, velz = vel[0], vel[1], vel[2]

    o_shift = V3(o.x - velx * times, o.y - vely * times, o.z - velz * times)
    qo = vec.xform_pt(inv, o_shift)
    qd = vec.normalize(vec.xform_dir(inv, d))

    if gtype == T.CUBE:
        t_obj, hit, outside, n_local, ex, ez = _box_local_planar(qo, qd)
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

    tan = None
    zero = torch.zeros_like(t_world)
    if gtype == T.CUBE:
        u = torch.where(ex, ip_obj.y, ip_obj.x) + 0.5
        v = torch.where(ez, ip_obj.y, ip_obj.z) + 0.5
        if tangents:
            # dP_obj/du follows the uv rule: the x faces run u along object
            # y, the others along object x
            one = torch.ones_like(zero)
            tan = vec.xform_dir(fwd, V3(torch.where(ex, zero, one),
                                        torch.where(ex, one, zero), zero))
    else:
        flip = torch.where(outside, 1.0, -1.0).to(F32)
        n_local = V3(ip_obj.x * flip, ip_obj.y * flip, ip_obj.z * flip)
        u = 0.5 + _atan2(ip_obj.z, ip_obj.x) / (2 * math.pi)
        # the 1e-7 inset keeps asin's derivative finite at the poles
        v = 0.5 + torch.asin(_clip(ip_obj.y / 0.5, -1.0 + 1e-7,
                                   1.0 - 1e-7)) / math.pi
        if tangents:
            # the equirect dP_obj/du ~ (-z, 0, x); it vanishes at the poles,
            # where shade_planar takes its fallback frame
            tan = vec.xform_dir(fwd, V3(-ip_obj.z, zero, ip_obj.x))
    normal = vec.normalize(vec.xform_dir(inv_tr, n_local))
    return HitP(t=torch.where(hit, t_world, torch.full_like(t_world, BIG)),
                normal=normal,
                mat_id=geoms.material_id[g].to(torch.int64).expand_as(
                    t_world),
                point=ip_world, surf=sf_world, u=u, v=v,
                outside=outside, tan=tan)


def _sdf_hit_planar(o: V3, d: V3, times: torch.Tensor, geoms: T.Geoms,
                    g: int, kind: Tuple[int, int, int],
                    tangents: bool = False) -> HitP:
    """SDF geom g against the whole wavefront (the JAX `_sdf_hit_planar`):
    the primitives' object-space convention, the surface found by sphere
    tracing (`ops.sdf.march_local`) along the normalised object-space
    direction, t returned as a world distance. The hit point backs off
    RAY_EPS object units with a fused multiply-add, the primitives' rule
    (`_fma`). The normal is the field's finite-difference gradient, flipped
    for rays that start inside (the march flips the field's sign there);
    the uv is spherical, from the local normal, and so is the tangent."""
    inv = geoms.inverse_transform[g]
    fwd = geoms.transform[g]
    inv_tr = geoms.inverse_transpose[g]
    params = geoms.sdf_params[g]
    vel = geoms.velocity[g]
    velx, vely, velz = vel[0], vel[1], vel[2]

    o_shift = V3(o.x - velx * times, o.y - vely * times, o.z - velz * times)
    qo = vec.xform_pt(inv, o_shift)
    qd = vec.normalize(vec.xform_dir(inv, d))

    t_obj, hit, outside = S.march_local(qo, qd, kind, params)

    tb = t_obj - RAY_EPS
    ip_obj = V3(*(_fma(tb, q, p) for q, p in zip(qd, qo)))
    sf_obj = V3(*(_fma(t_obj, q, p) for q, p in zip(qd, qo)))
    n_local = S.normal_local(sf_obj, kind, params)
    n_local = vec.where(outside, n_local, -n_local)

    ip_world = vec.xform_pt(fwd, ip_obj)
    ip_world = V3(ip_world.x + velx * times, ip_world.y + vely * times,
                  ip_world.z + velz * times)
    sf_world = vec.xform_pt(fwd, sf_obj)
    sf_world = V3(sf_world.x + velx * times, sf_world.y + vely * times,
                  sf_world.z + velz * times)
    t_world = vec.norm(o - ip_world)

    u = 0.5 + _atan2(n_local.z, n_local.x) / (2 * math.pi)
    v = 0.5 + torch.asin(torch.clamp(n_local.y, -1.0, 1.0)) / math.pi
    tan = None
    if tangents:
        tan = vec.xform_dir(fwd, V3(-n_local.z, torch.zeros_like(u),
                                    n_local.x))
    normal = vec.normalize(vec.xform_dir(inv_tr, n_local))
    return HitP(t=torch.where(hit, t_world, torch.full_like(t_world, BIG)),
                normal=normal,
                mat_id=geoms.material_id[g].to(torch.int64).expand_as(
                    t_world),
                point=ip_world, surf=sf_world, u=u, v=v, outside=outside,
                tan=tan)


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
                     tri_offset=0, any_hit: bool = False,
                     tangents: bool = False) -> HitP:
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
    and the normal is flipped two-sided toward the incoming ray.

    `tangents` adds the winning triangle's uv tangent, dP/du = (e1 dv2 -
    e2 dv1) / (du1 dv2 - du2 dv1) in the world (0 where the uv map is
    degenerate), read from the bundle `meshes` and detached."""
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
    tan = None
    if tangents:
        with torch.no_grad():
            tri_g = torch.clamp(tri, min=0).to(torch.int64) + tri_offset
            e1t = vec.from_rows(meshes.tri_e1[tri_g])
            e2t = vec.from_rows(meshes.tri_e2[tri_g])
            uv0, uv1, uv2 = (meshes.tri_uv0[tri_g], meshes.tri_uv1[tri_g],
                             meshes.tri_uv2[tri_g])
            du1, dv1 = uv1[:, 0] - uv0[:, 0], uv1[:, 1] - uv0[:, 1]
            du2, dv2 = uv2[:, 0] - uv0[:, 0], uv2[:, 1] - uv0[:, 1]
            det = du1 * dv2 - du2 * dv1
            ok = det.abs() > 1e-12
            inv_det = torch.where(ok, 1.0 / torch.where(
                ok, det, torch.ones_like(det)), torch.zeros_like(det))
            tan = vec.xform_dir(fwd, V3(*((a * dv2 - b * dv1) * inv_det
                                          for a, b in zip(e1t, e2t))))
    return HitP(t=t_world, normal=normal,
                mat_id=geoms.material_id[g].to(torch.int64).expand_as(
                    t_world),
                point=ip_world, surf=sf_world, u=u, v=v, outside=facing,
                tan=tan)


# Spheres tested per step of the batched sphere pass: each step computes a
# [K, N] block and keeps only the running (t_best, winner).
SPHERE_BATCH_K = 16

_INDEX_TENSORS = {}  # (indices, device) -> their int64 tensor


def _index_tensor(idxs: Tuple[int, ...], dev) -> torch.Tensor:
    """`idxs` as an int64 tensor on `dev`, copied from the host once per
    tuple and device (a captured iteration may not copy from the host)."""
    key = (idxs, str(dev))
    if key not in _INDEX_TENSORS:
        _INDEX_TENSORS[key] = torch.as_tensor(idxs, dtype=torch.int64,
                                              device=dev)
    return _INDEX_TENSORS[key]


def _batched_spheres_planar(o: V3, d: V3, times: torch.Tensor,
                            geoms: T.Geoms, idxs: Sequence[int],
                            tangents: bool = False) -> HitP:
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
    the normal. With `tangents` the tangent is 0 (no lane reads it)."""
    dev = o.x.device
    gi = _index_tensor(tuple(idxs), dev)
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
    zero = torch.zeros_like(half)
    return HitP(t=torch.where(got, t_best, torch.full_like(t_best, BIG)),
                normal=normal, mat_id=mid[iw], point=point, surf=surf,
                u=half, v=half, outside=outside,
                tan=V3(zero, zero, zero) if tangents else None)


def intersect_planar(o: V3, d: V3, times: torch.Tensor, geoms: T.Geoms,
                     geom_types: Sequence[int], packed_meshes: tuple = (),
                     mesh_ids: Sequence[int] = (),
                     alive: Optional[torch.Tensor] = None,
                     meshes: Optional[T.MeshBundle] = None,
                     differentiable_mesh: bool = False,
                     any_hit: bool = False,
                     max_t: Optional[torch.Tensor] = None,
                     sphere_batch: Sequence[int] = (),
                     tangents: bool = False,
                     sdf_kinds: Sequence[Tuple[int, int, int]] = ()) -> HitP:
    """Nearest hit over all geoms (src/pathtrace.cu:176-199): a strict `<`
    merge in geom order, then misses become t = -1, material 0.

    Primitives are tested first (the spheres of `sphere_batch` in one
    `_batched_spheres_planar` pass, before the others; SDF geom g sphere-
    traced by `_sdf_hit_planar` with its kind `sdf_kinds[g]`, for nearest
    and any hit alike, as in the JAX package); their nearest hit
    becomes the meshes' occlusion bound. MESH geom g traverses
    `packed_meshes[mesh_ids[g]]`, and `alive` ([N] bool) marks the lanes
    that may still hit: dead lanes take no part in the traversal.
    `differentiable_mesh` recomputes the mesh hits from the bundle `meshes`
    (`_mesh_hit_packet`).

    Occlusion queries (NEE shadow rays): `max_t` ([N]) caps the search, so
    a hit beyond it reports a miss (t = -1) and mesh subtrees beyond it are
    pruned; `any_hit` runs the 8-wide traversal in its occlusion mode. Only
    `t > 0` of such a query means anything.

    `tangents` fills `HitP.tan` (normal maps): a mesh hit's tangent comes
    from the bundle `meshes`, a miss keeps a zero tangent."""
    for g, gtype in enumerate(geom_types):
        if gtype == T.MESH:
            mid = mesh_ids[g] if g < len(mesh_ids) else -1
            if not 0 <= mid < len(packed_meshes):
                raise ValueError(f"mesh geom {g} has no packed mesh "
                                 f"(mesh id {mid}, {len(packed_meshes)} "
                                 "packed)")
            if (differentiable_mesh or tangents) and meshes is None:
                raise ValueError("differentiable_mesh and tangents need the "
                                 "MeshBundle")
        elif gtype == T.SDF:
            if g >= len(sdf_kinds) or geoms.sdf_params is None:
                raise ValueError(f"SDF geom {g} has no kind or parameters "
                                 "(TraceConfig.sdf_kinds, Geoms.sdf_params)")
        elif gtype not in (T.CUBE, T.SPHERE):
            raise ValueError(f"geom {g} has an unknown type {gtype}")
    n = o.x.shape[0]
    z = torch.zeros((n,), dtype=F32, device=o.x.device)
    t_init = (torch.full((n,), BIG, dtype=F32, device=o.x.device)
              if max_t is None else torch.clamp(max_t, max=BIG))
    best = HitP(t=t_init,
                normal=V3(z, z, z),
                mat_id=torch.zeros((n,), dtype=torch.int64,
                                   device=o.x.device),
                point=V3(z, z, z), surf=V3(z, z, z), u=z, v=z,
                outside=torch.ones((n,), dtype=torch.bool, device=o.x.device),
                tan=V3(z, z, z) if tangents else None)

    def merge(best: HitP, cand: HitP) -> HitP:
        closer = cand.t < best.t
        return HitP(t=torch.where(closer, cand.t, best.t),
                    normal=vec.where(closer, cand.normal, best.normal),
                    mat_id=torch.where(closer, cand.mat_id, best.mat_id),
                    point=vec.where(closer, cand.point, best.point),
                    surf=vec.where(closer, cand.surf, best.surf),
                    u=torch.where(closer, cand.u, best.u),
                    v=torch.where(closer, cand.v, best.v),
                    outside=torch.where(closer, cand.outside, best.outside),
                    tan=(vec.where(closer, cand.tan, best.tan) if tangents
                         else None))

    batched = set(sphere_batch)
    if batched:
        best = merge(best, _batched_spheres_planar(o, d, times, geoms,
                                                   sphere_batch, tangents))
    for g, gtype in enumerate(geom_types):
        if gtype == T.SDF:
            best = merge(best, _sdf_hit_planar(o, d, times, geoms, g,
                                               tuple(sdf_kinds[g]),
                                               tangents))
        elif gtype != T.MESH and g not in batched:
            best = merge(best, _primitive_hit_planar(o, d, times, geoms, g,
                                                     gtype, tangents))
    for g, gtype in enumerate(geom_types):
        if gtype == T.MESH:
            mid = mesh_ids[g]
            best = merge(best, _mesh_hit_packet(
                o, d, times, geoms, packed_meshes[mid], g,
                t_world_bound=best.t, alive=alive, meshes=meshes,
                differentiable=differentiable_mesh,
                tri_offset=(meshes.mesh_tri_offset[mid].to(torch.int64)
                            if differentiable_mesh or tangents else 0),
                any_hit=any_hit, tangents=tangents))
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
    """Per-lane material fetch from an [M] or [M,3] table. A table that
    takes a gradient goes through ops/matgrad.select: the same gather, with
    a per-material sum (kernel G1 on the card) as its backward in place of
    index_put_'s."""
    if table.requires_grad and torch.is_grad_enabled():
        rows = matgrad.select(table, mat_id)
        return rows if table.ndim == 1 else V3(*rows)
    rows = table[mat_id]
    if table.ndim == 1:
        return rows
    return V3(rows[:, 0], rows[:, 1], rows[:, 2])


# ---------------------------------------------------------------------------
# Texel fetch helpers (the JAX ops/wavefront.py:928-1124). Indices are int32
# and every 32-bit table take goes through ops.texfetch.take_u32.
# ---------------------------------------------------------------------------

def _between(x: torch.Tensor, lo: float, hi: torch.Tensor) -> torch.Tensor:
    """jnp.clip(x, lo, hi) with a per-lane upper bound."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


def _rect_select(textures: T.Textures, mat_id, rect=None, tid_table=None):
    """The material's atlas rect (x, y, w, h) as float32 planes, and its
    texture id plane; `rect`/`tid_table` default to the colour textures'."""
    rect = textures.rect if rect is None else rect
    tid_table = textures.tex_id if tid_table is None else tid_table
    rf = rect.to(F32)
    return (*(_mat_select(rf[:, i], mat_id) for i in range(4)),
            _mat_select(tid_table.to(F32), mat_id))


def _atlas_flat_index(textures: T.Textures, mat_id, u, v, rect=None,
                      tid_table=None):
    """(flat texel index [N] int32, textured mask) of the nearest atlas
    fetch. Normal maps pass textures.nrm_rect / nrm_id."""
    rx, ry, rw, rh, tid = _rect_select(textures, mat_id, rect, tid_table)
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    xi = rx + _between(torch.floor(uu * rw), 0.0, _max(rw - 1, 0.0))
    yi = ry + _between(torch.floor((1.0 - vv) * rh), 0.0, _max(rh - 1, 0.0))
    ha, wa = textures.atlas.shape[0], textures.atlas.shape[1]
    flat = (torch.clamp(yi, 0, ha - 1) * wa
            + torch.clamp(xi, 0, wa - 1)).to(torch.int32)
    return flat, tid >= 0


def _unpack_rgb8(p: torch.Tensor) -> V3:
    """R8G8B8 texels (int32 bits) -> linear RGB, equal to the float32 atlas
    (utils/image.pack_rgb8)."""
    return V3((p & 0xFF).to(F32) / 255.0, ((p >> 8) & 0xFF).to(F32) / 255.0,
              ((p >> 16) & 0xFF).to(F32) / 255.0)


def _env_flat_index(textures: T.Textures, d: V3) -> torch.Tensor:
    """Flat equirect texel index [N] int32 of the nearest env fetch."""
    he, we = textures.env.shape[0], textures.env.shape[1]
    u = 0.5 + _atan2(d.x, -d.z) / (2.0 * math.pi)
    v = torch.acos(torch.clamp(d.y, -1.0, 1.0)) / math.pi
    xi = torch.clamp((u * we).to(torch.int32), 0, we - 1)
    yi = torch.clamp((v * he).to(torch.int32), 0, he - 1)
    return yi * we + xi


def _atlas_bilinear_indices(textures: T.Textures, mat_id, u, v):
    """Four corner indices (x0y0, x1y0, x0y1, x1y1; int32), the fractions
    and the textured mask of a bilinear atlas fetch (--bilinear): texel
    centres at (x + 0.5)/w, corners clamped inside the material's rect.
    Left of the first centre fu collapses to 0, so that the pair plane
    (--bilinear-fast), which always returns (t0, t1), reproduces the
    clamped fetch."""
    rx, ry, rw, rh, tid = _rect_select(textures, mat_id)
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    xf = uu * rw - 0.5
    yf = (1.0 - vv) * rh - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    fu = torch.where(x0 < 0.0, torch.zeros_like(xf), xf - x0)
    fv = yf - y0
    hi_x = _max(rw - 1, 0.0)
    hi_y = _max(rh - 1, 0.0)
    ha, wa = textures.atlas.shape[0], textures.atlas.shape[1]

    def at(xc, yc):
        xi = rx + _between(xc, 0.0, hi_x)
        yi = ry + _between(yc, 0.0, hi_y)
        return (torch.clamp(yi, 0, ha - 1) * wa
                + torch.clamp(xi, 0, wa - 1)).to(torch.int32)

    return (at(x0, y0), at(x0 + 1, y0), at(x0, y0 + 1), at(x0 + 1, y0 + 1),
            fu, fv, tid >= 0)


def _env_bilinear_indices(textures: T.Textures, d: V3):
    """Four corner indices (int32) and the fractions of a bilinear
    equirect fetch: longitude wraps, latitude clamps at the poles (the
    1e-7 inset keeps acos's derivative finite straight up and down)."""
    he, we = textures.env.shape[0], textures.env.shape[1]
    u = 0.5 + _atan2(d.x, -d.z) / (2.0 * math.pi)
    v = torch.acos(torch.clamp(d.y, -1.0 + 1e-7, 1.0 - 1e-7)) / math.pi
    xf = u * we - 0.5
    yf = v * he - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    fu = xf - x0
    fv = yf - y0

    def at(xc, yc):
        xi = torch.remainder(xc, we)
        yi = torch.clamp(yc, 0, he - 1)
        return (yi * we + xi).to(torch.int32)

    return (at(x0, y0), at(x0 + 1, y0), at(x0, y0 + 1), at(x0 + 1, y0 + 1),
            fu, fv)


def _unpack_565pair(p: torch.Tensor):
    """One atlas_pair texel -> (texel, its right neighbour) as linear RGB
    at RGB565 precision. The masks after each arithmetic shift make the
    int32 sign extension harmless."""
    def one(q):
        return V3((q & 31).to(F32) / 31.0, ((q >> 5) & 63).to(F32) / 63.0,
                  ((q >> 11) & 31).to(F32) / 31.0)
    return one(p), one(p >> 16)


def _pow2(biased: torch.Tensor) -> torch.Tensor:
    """2^(biased - 127) as float32, built from its exponent bits (exact;
    the argument is clamped to the normal range by the callers)."""
    return (biased << 23).view(F32)


def _unpack_envpair(p: torch.Tensor, scale: torch.Tensor):
    """One env_pair texel -> (texel, its right neighbour) as linear HDR
    RGB (utils/image.pack_env_pair): two 12-bit 4/4/4 texels sharing one
    8-bit exponent E, channel = (m + 0.5) * 2^(E-132); E = 0 is black."""
    ex = (p >> 24) & 0xFF
    s = torch.where(ex > 0, _pow2(torch.clamp(ex - 5, 1, 254)),
                    torch.zeros((), dtype=F32, device=p.device)) * scale

    def one(t):
        return V3(((t & 15).to(F32) + 0.5) * s,
                  (((t >> 4) & 15).to(F32) + 0.5) * s,
                  (((t >> 8) & 15).to(F32) + 0.5) * s)
    return one(p), one(p >> 12)


def _bilerp(c00: V3, c10: V3, c01: V3, c11: V3, fu, fv) -> V3:
    a = V3(*(p + (q - p) * fu for p, q in zip(c00, c10)))
    b = V3(*(p + (q - p) * fu for p, q in zip(c01, c11)))
    return V3(*(p + (q - p) * fv for p, q in zip(a, b)))


def _unpack_rgbe(p: torch.Tensor, scale: torch.Tensor) -> V3:
    """Radiance RGBE texels -> linear RGB, equal to the float32 env map
    (utils/image.pack_rgbe): (m + 0.5) * 2^(E-136), the power of two built
    from its bits; the parser's round-trip guard refuses assets whose
    texels fall below the normal range."""
    ex = (p >> 24) & 0xFF
    s = torch.where(ex > 0, _pow2(torch.clamp(ex - 9, 1, 254)),
                    torch.zeros((), dtype=F32, device=p.device)) * scale
    return V3(((p & 0xFF).to(F32) + 0.5) * s,
              (((p >> 8) & 0xFF).to(F32) + 0.5) * s,
              (((p >> 16) & 0xFF).to(F32) + 0.5) * s)


def _take_f32x3(image: torch.Tensor, flat: torch.Tensor) -> V3:
    """Three float32 takes from an [H,W,3] image: the form of sources whose
    packed plane does not round-trip (the JAX package computes it outside
    any Pallas kernel, so it stays torch indexing)."""
    idx = flat.long()
    return V3(*(image[:, :, c].reshape(-1)[idx] for c in range(3)))


def _sample_texture_planar(textures: T.Textures, mat_id, u, v,
                           base: V3) -> V3:
    """Nearest atlas fetch: one packed take (or three float32 takes), the
    material colour `base` where the material is untextured."""
    flat, textured = _atlas_flat_index(textures, mat_id, u, v)
    ha, wa = textures.atlas.shape[0], textures.atlas.shape[1]
    if texfetch.full(textures.atlas_packed, ha * wa):
        rgb = _unpack_rgb8(texfetch.take_u32(textures.atlas_packed, flat))
    else:
        rgb = _take_f32x3(textures.atlas, flat)
    return vec.where(textured, rgb, base)


def _sample_env_planar(textures: T.Textures, d: V3) -> V3:
    """Nearest equirect env fetch in direction d."""
    he, we = textures.env.shape[0], textures.env.shape[1]
    flat = _env_flat_index(textures, d)
    scale = textures.env_enabled
    if texfetch.full(textures.env_packed, he * we):
        return _unpack_rgbe(texfetch.take_u32(textures.env_packed, flat),
                            scale)
    return V3(*(c * scale for c in _take_f32x3(textures.env, flat)))


def _fused(table: torch.Tensor, texels: int) -> torch.Tensor:
    """A fused atlas+env table (`ops.texfetch.fuse`), which must exist."""
    if table.shape[0] != texels:
        raise ValueError("the fused atlas+env table is missing: build it "
                         "once with ops.texfetch.fuse(textures)")
    return table


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


def _textured_albedo(hit: HitP, ray_d: V3, textures: T.Textures,
                     albedo: V3, bilinear: bool, bilinear_fast: bool):
    """The atlas and env fetches of one bounce (the branches of the JAX
    shade_planar, ops/wavefront.py:1194-1295): (albedo with its texels,
    the env radiance of the miss lanes where it rode the same fetch, else
    None). Where the scene has both an atlas and an env map, hit lanes read
    the atlas and miss lanes the env through one take of the fused table
    (`ops.texfetch.fuse`); each side decodes every lane and keeps its own."""
    mat_id = hit.mat_id
    ha, wa = textures.atlas.shape[0], textures.atlas.shape[1]
    he, we = textures.env.shape[0], textures.env.shape[1]
    na = ha * wa
    has_atlas, has_env = textures.has_atlas, textures.has_env
    fuse = (has_atlas and has_env
            and texfetch.full(textures.atlas_packed, na)
            and texfetch.full(textures.env_packed, he * we))
    has_pair = texfetch.full(textures.atlas_pair, na)
    has_env_pair = texfetch.full(textures.env_pair, he * we)
    fast = bilinear and bilinear_fast
    take = texfetch.take_u32
    scale = textures.env_enabled
    on_env = hit.t <= 0.0
    if fuse and fast and has_pair:
        # --bilinear-fast: two takes of the pair table give the atlas's
        # four corners on hit lanes and, with env_pair, the env's on miss
        # lanes (else a nearest RGBE env texel)
        table = _fused(textures.fused_pair, na + he * we)
        a00, _, a01, _, fua, fva, textured = _atlas_bilinear_indices(
            textures, mat_id, hit.u, hit.v)
        if has_env_pair:
            e00, _, e01, _, fue, fve = _env_bilinear_indices(textures, ray_d)
        else:
            e00 = e01 = _env_flat_index(textures, ray_d)
        p_top = take(table, torch.where(on_env, e00 + na, a00))
        p_bot = take(table, torch.where(on_env, e01 + na, a01))
        c00, c10 = _unpack_565pair(p_top)
        c01, c11 = _unpack_565pair(p_bot)
        albedo = vec.where(textured & ~on_env,
                           _bilerp(c00, c10, c01, c11, fua, fva), albedo)
        if not has_env_pair:
            return albedo, _unpack_rgbe(p_top, scale)
        ec00, ec10 = _unpack_envpair(p_top, scale)
        ec01, ec11 = _unpack_envpair(p_bot, scale)
        return albedo, _bilerp(ec00, ec10, ec01, ec11, fue, fve)
    if has_atlas and fast and has_pair:
        a00, _, a01, _, fu, fv, textured = _atlas_bilinear_indices(
            textures, mat_id, hit.u, hit.v)
        c00, c10 = _unpack_565pair(take(textures.atlas_pair, a00))
        c01, c11 = _unpack_565pair(take(textures.atlas_pair, a01))
        return vec.where(textured, _bilerp(c00, c10, c01, c11, fu, fv),
                         albedo), None
    if fuse and bilinear:
        # --bilinear: four corner takes of the fused table
        table = _fused(textures.fused_packed, na + he * we)
        a00, a10, a01, a11, fua, fva, textured = _atlas_bilinear_indices(
            textures, mat_id, hit.u, hit.v)
        e00, e10, e01, e11, fue, fve = _env_bilinear_indices(textures, ray_d)
        fu = torch.where(on_env, fue, fua)
        fv = torch.where(on_env, fve, fva)
        ps = [take(table, torch.where(on_env, e + na, a))
              for a, e in ((a00, e00), (a10, e10), (a01, e01), (a11, e11))]
        albedo = vec.where(textured & ~on_env,
                           _bilerp(*[_unpack_rgb8(q) for q in ps], fu, fv),
                           albedo)
        return albedo, _bilerp(*[_unpack_rgbe(q, scale) for q in ps], fu, fv)
    if fuse:
        table = _fused(textures.fused_packed, na + he * we)
        aflat, textured = _atlas_flat_index(textures, mat_id, hit.u, hit.v)
        eflat = _env_flat_index(textures, ray_d)
        q = take(table, torch.where(on_env, eflat + na, aflat))
        albedo = vec.where(textured & ~on_env, _unpack_rgb8(q), albedo)
        return albedo, _unpack_rgbe(q, scale)
    if has_atlas and bilinear and texfetch.full(textures.atlas_packed, na):
        a00, a10, a01, a11, fu, fv, textured = _atlas_bilinear_indices(
            textures, mat_id, hit.u, hit.v)
        cs4 = [_unpack_rgb8(take(textures.atlas_packed, i))
               for i in (a00, a10, a01, a11)]
        return vec.where(textured, _bilerp(*cs4, fu, fv), albedo), None
    if has_atlas:
        return _sample_texture_planar(textures, mat_id, hit.u, hit.v,
                                      albedo), None
    return albedo, None


def _env_radiance(ray_d: V3, textures: T.Textures, like: torch.Tensor,
                  bilinear: bool, bilinear_fast: bool) -> V3:
    """The env map's radiance in direction ray_d where no fused fetch gave
    it: bilinear from the pair plane or four RGBE corners, nearest, or the
    constant env of a scene without an env map."""
    he, we = textures.env.shape[0], textures.env.shape[1]
    take = texfetch.take_u32
    scale = textures.env_enabled
    if textures.has_env and bilinear and bilinear_fast \
            and texfetch.full(textures.env_pair, he * we):
        e00, _, e01, _, fu, fv = _env_bilinear_indices(textures, ray_d)
        ec00, ec10 = _unpack_envpair(take(textures.env_pair, e00), scale)
        ec01, ec11 = _unpack_envpair(take(textures.env_pair, e01), scale)
        return _bilerp(ec00, ec10, ec01, ec11, fu, fv)
    if textures.has_env and bilinear \
            and texfetch.full(textures.env_packed, he * we):
        e00, e10, e01, e11, fu, fv = _env_bilinear_indices(textures, ray_d)
        return _bilerp(*[_unpack_rgbe(take(textures.env_packed, i), scale)
                         for i in (e00, e10, e01, e11)], fu, fv)
    if textures.has_env:
        return _sample_env_planar(textures, ray_d)
    e = textures.env[0, 0].to(like.device) * scale.to(like.device)
    return vec.splat(e, like=like)


def _sky_radiance(ray_d: V3, sk: torch.Tensor) -> V3:
    """The procedural sky (ENVSKY): a horizon-to-zenith gradient plus a sun
    lobe, weighted by sk[0]."""
    up_t = _clip(ray_d.y, 0.0, 1.0)
    zero = torch.zeros_like(up_t)
    sun = vec.normalize(V3(sk[7] + zero, sk[8] + zero, sk[9] + zero))
    sun_cos = _clip(vec.dot(ray_d, sun), 0.0, 1.0)
    sun_lobe = _pow(sun_cos, _max(sk[13], 1.0))
    return V3(*((sk[4 + c] + (sk[1 + c] - sk[4 + c]) * up_t
                 + sk[10 + c] * sun_lobe) * sk[0] for c in range(3)))


def _bump_normal(hit: HitP, n_sh: V3, textures: T.Textures, mat_id) -> V3:
    """The procedural world-space bump h(p) = sin(f x) sin(f y) sin(f z):
    its analytic gradient, projected on the tangent plane, tilts the
    shading normal by `scale` (materials with BUMP scale > 0)."""
    bs = _mat_select(textures.bump[:, 0], mat_id)
    bf = _mat_select(textures.bump[:, 1], mat_id)
    px, py, pz = hit.surf.x * bf, hit.surf.y * bf, hit.surf.z * bf
    sx, sy, sz = torch.sin(px), torch.sin(py), torch.sin(pz)
    grad = V3(bf * torch.cos(px) * sy * sz, bf * sx * torch.cos(py) * sz,
              bf * sx * sy * torch.cos(pz))
    gn = vec.dot(grad, n_sh)
    pert = vec.normalize(V3(*(n - bs * (g - gn * n)
                              for n, g in zip(n_sh, grad))))
    return vec.where(bs > 0.0, pert, n_sh)


def _normal_map(hit: HitP, n_sh: V3, textures: T.Textures, mat_id) -> V3:
    """The tangent-space normal map (NORMALMAP): one texel fetch of the
    same atlas strip, in the frame of the uv tangent Gram-Schmidt'ed
    against the normal (a normal-derived frame where the tangent vanishes),
    kept only where it stays on the geometric hemisphere."""
    nflat, has_map = _atlas_flat_index(textures, mat_id, hit.u, hit.v,
                                       rect=textures.nrm_rect,
                                       tid_table=textures.nrm_id)
    ha, wa = textures.atlas.shape[0], textures.atlas.shape[1]
    if texfetch.full(textures.atlas_packed, ha * wa):
        texel = _unpack_rgb8(texfetch.take_u32(textures.atlas_packed, nflat))
    else:
        texel = _take_f32x3(textures.atlas, nflat)
    tn = V3(*(c * 2.0 - 1.0 for c in texel))
    tdn = vec.dot(hit.tan, n_sh)
    tperp = V3(*(t - tdn * n for t, n in zip(hit.tan, n_sh)))
    tlen2 = vec.dot(tperp, tperp)
    fx = n_sh.x.abs() < SQRT_OF_ONE_THIRD
    fy = (~fx) & (n_sh.y.abs() < SQRT_OF_ONE_THIRD)
    not_n = V3(fx.to(F32), fy.to(F32), (~(fx | fy)).to(F32))
    t_fb = vec.normalize(vec.cross(n_sh, not_n))
    ok_t = tlen2 > 1e-12
    inv_l = torch.rsqrt(_max(tlen2, 1e-12))
    t_dir = vec.where(ok_t, tperp * inv_l, t_fb)
    b_dir = vec.cross(n_sh, t_dir)
    n_map = vec.normalize(V3(*(t * tn.x + b * tn.y + n * tn.z
                               for t, b, n in zip(t_dir, b_dir, n_sh))))
    keep = has_map & (vec.dot(n_map, hit.normal) > 1e-3)
    return vec.where(keep, n_map, n_sh)


def shade_planar(hit: HitP, ray_d: V3, throughput: V3, alive: torch.Tensor,
                 materials: T.Materials, textures: T.Textures,
                 uniforms: Sequence[torch.Tensor],
                 last_bounce: torch.Tensor, glossy: bool = True,
                 nee: Optional[tuple] = None,
                 nee_area: float = 0.0, sky: bool = False,
                 nee_env_c: float = 0.0, nee_q: float = 1.0,
                 bump: bool = False, nmap: bool = False,
                 bilinear: bool = False,
                 bilinear_fast: bool = False,
                 dispersion: bool = False) -> ShadeOutP:
    """One scattering step over the wavefront; `uniforms` holds the four
    planes (u_lobe, u1, u2, u_fresnel). The JAX `shade_planar`.

    Albedo: the material colour, its atlas texel where the material is
    textured (nearest; `bilinear` four corners; with `bilinear_fast` the
    pair planes' two takes; `_textured_albedo`), and the procedural
    checker. `bump` and `nmap` (static gates) tilt the shading normal
    (`_bump_normal`, `_normal_map`, the latter reading `hit.tan`). A miss
    collects the env map (or the constant env) plus, with `sky`, the
    procedural sky.

    `nee` (None = BSDF sampling alone) is the tuple (wl V3, vis [N] bool,
    le V3, pdf_l [N], prev_pdf [N]): this bounce's shadow-tested light
    sample (direction, visibility, emitted radiance, the light sampler's
    solid-angle pdf times its selection probability) and the previous
    bounce's lobe pdf. Light and BSDF sampling combine by the one-sample
    balance heuristic: the direct term of the diffuse and glossy lobes is
    weighted pdf_bsdf / (pdf_l + pdf_bsdf); with `nee_area` > 0 (the light
    union's area) an emissive BSDF hit is weighted prev_pdf / (prev_pdf +
    pdf_l(hit)), pdf_l(hit) = t^2 / (|cos| * area); with `nee_env_c` > 0 an
    env miss is weighted prev_pdf / (prev_pdf + lum(env) * C). In the mixed
    mode `nee_q` is the probability of sampling the area union (1 - nee_q
    the env), which scales each side's light pdf. prev_pdf == 0 (camera,
    mirror, refraction) means full weight. The direct term is skipped on
    the last bounce, so the estimator covers the plain one's transport at
    equal depth. The lobe's pdf of the new direction comes back as
    `nee_pdf`.

    Detach convention: the lobe and Fresnel decisions and the diffuse
    direction are detached; the mirror, refraction and glossy directions
    keep their dependence on the materials (the training slice relies on
    it).

    `dispersion` (static; some material has DISPERSION d > 0): a path that
    takes the refractive lobe of such a material samples one RGB band ch
    from the lobe draw, reused (u_lobe / p_refr is again uniform inside the
    lobe) and detached, refracts with ior + d (ch - 1), and its throughput
    keeps 3x that band alone: E[3 onehot(ch) L] = sum of L's bands, so white
    light stays unbiased while caustics split by wavelength."""
    mat_id = hit.mat_id
    albedo, env_fused = _textured_albedo(
        hit, ray_d, textures, _mat_select(materials.color, mat_id),
        bilinear, bilinear_fast)
    cs = _mat_select(textures.checker_scale, mat_id)
    c2 = _mat_select(textures.checker_color2, mat_id)
    par = torch.remainder(torch.floor(hit.u * cs) + torch.floor(hit.v * cs),
                          2.0)
    albedo = vec.where((cs > 0) & (par > 0.5), c2, albedo)
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

    # the shading normal replaces the geometric one from here on; the
    # normal map's hemisphere guard reads the geometric one
    n_sh = hit.normal
    if bump:
        n_sh = _bump_normal(hit, n_sh, textures, mat_id)
    if nmap and hit.tan is not None:
        n_sh = _normal_map(hit, n_sh, textures, mat_id)
    if bump or nmap:
        hit = hit._replace(normal=n_sh)

    env = (env_fused if env_fused is not None else
           _env_radiance(ray_d, textures, hit.t, bilinear, bilinear_fast))
    if sky:
        env = env + _sky_radiance(ray_d, textures.sky)

    lit = alive & is_light
    mis = alive & missed
    zero = torch.zeros_like(hit.t)
    rad_scale = torch.where(lit, emittance, zero)
    if nee is not None and nee_area > 0.0:
        prev_pdf = nee[4]
        cos_l_hit = torch.abs(vec.dot(hit.normal, ray_d))
        pdf_l_hit = (hit.t * hit.t) / _max(cos_l_hit * nee_area, 1e-9)
        if nee_q != 1.0:
            pdf_l_hit = pdf_l_hit * nee_q
        w_hit = torch.where(prev_pdf > 0.0,
                            prev_pdf / _max(prev_pdf + pdf_l_hit, 1e-30),
                            torch.ones_like(prev_pdf))
        rad_scale = rad_scale * w_hit
    if nee is not None and nee_env_c > 0.0:
        # the env-sampling pdf of this miss direction is lum(texel) * C,
        # free off the texel already fetched
        prev_pdf = nee[4]
        from . import nee as nee_mod  # nee imports this module
        pdf_env_dir = nee_mod.env_lum(env) * nee_env_c
        if nee_q != 0.0:
            pdf_env_dir = pdf_env_dir * (1.0 - nee_q)
        w_env = torch.where(prev_pdf > 0.0,
                            prev_pdf / _max(prev_pdf + pdf_env_dir, 1e-30),
                            torch.ones_like(prev_pdf))
        env = V3(*(c * w_env for c in env))
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
        cos_a = _pow(torch.clamp(uniforms[1], 1e-9, 1.0),
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

    disp_scale = None
    if dispersion:
        disp = _mat_select(materials.dispersion, mat_id)
        u_ch = _clip(u_lobe / _max(p_refr, 1e-9), 0.0, 1.0 - 1e-7).detach()
        ch = torch.floor(u_ch * 3.0)
        dispersing = take_refr & (disp > 0.0)
        ior = torch.where(dispersing, ior + disp * (ch - 1.0), ior)
        one = torch.ones_like(ior)
        three, zero_c = torch.full_like(ior, 3.0), torch.zeros_like(ior)
        disp_scale = V3(*(torch.where(
            dispersing, torch.where(ch == c, three, zero_c), one)
            for c in range(3)))

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
                   * _pow(cos_al, spec_exp))
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
    if dispersion:
        factor = factor * disp_scale

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
                      * _pow(_clip(cos_a, 1e-9, 1.0), spec_exp))
            gloss = still_alive & take_spec & (spec_exp > 0.0) & above
            nee_pdf = torch.where(gloss, p_spec * q_samp, nee_pdf)
    return ShadeOutP(origin=new_origin, direction=new_dir,
                     throughput=new_throughput, radiance=radiance,
                     alive=still_alive, nee_pdf=nee_pdf)
