"""K1's least time at the published FP32 peak, from the path segments the
inputs need (not from how the megakernel schedules them), beside
roofline.k2_work.

K1 traces a whole iteration in one launch: a camera ray a pixel, then each
live segment tests every geom for the nearest hit and, where the path
goes on, shades the winner by the lobe its draw picks. It moves only the
accumulator (12 B in and out a pixel) and the scene table, so its FP32
operations bound it.

The counts are hand counts of csrc/megakernel.cu, each of its expressions
as written there (add, sub, mul, division, min, max, compare, select, abs,
sqrt, rsqrt, cos, sin, fmod: 1 each; fmaf: 2; a negation, integer work and
conversions: 0):

- OPS_RAY 44: a test's object-space ray (`local_hit`: xform_pt 18,
  xform_dir 15, normalize 11);
- OPS_CUBE 50: the cube's slabs (3 guarded reciprocals 18, 6 planes 12,
  6 min/max, 3 front-plane picks 6, entry and exit 4, hit, side and t 4);
- OPS_SPHERE 26: the sphere's quadratic (2 dots 10, the radicand 3, its
  guarded root 4, the two roots 2, their signs 4, the pick 3);
- OPS_DISTANCE 36: only where the test hits: the backed-off point (1 + 3
  fmaf), to the world (18), its distance (3 + 5 + 1) and the merge (2);
- OPS_MOTION_TEST 6, OPS_MOTION_POINT 3: the velocity shift of a test's
  ray, and of each world point, in a scene with a shutter;
- OPS_MISS 2: the miss test after the loop, every live segment;
- OPS_WINNER 52 + OPS_CUBE_FACE 15 or OPS_SPHERE_NORMAL 4: a segment that
  hits runs its winner's test again (OPS_RAY and OPS_CUBE or OPS_SPHERE),
  its local normal, the backed-off point (25), the world normal (26) and
  the emission test (1);
- OPS_EMIT 9: radiance += throughput * albedo * emittance;
- OPS_SHADE 23: a segment that shades, besides its draws and lobe: the
  lobe choice (3), the new direction's normalisation (11), the lobe's
  factor (3) and the throughput (6);
- the lobes: OPS_DIFFUSE 73 (the cosine-hemisphere: its frame, two
  normalisations, cos and sin, the probability), OPS_MIRROR 14 (the
  mirror direction 12, the probability 2), OPS_GLASS 44 (the mirror
  direction, Schlick's term and the refraction test 30, the probability),
  and OPS_TRANSMIT 44 more where the ray goes through (the refracted
  direction 14, the exact surface point in the world 24, the push 6);
- OPS_CAMERA 32: a pixel's camera ray (the AA offset 2, the screen point
  4, the direction 12, its normalisation 11) and its accumulation (3);
  OPS_LENS 48 with a thin lens, OPS_SHUTTER 1 with a shutter;
- OPS_DRAW: one uniform's float work by sampler: Philox's scaling (1),
  the lattice's (a scaled iteration, two sums, the hash's scaling and the
  fmod: 5), injected uniforms (0). A pixel draws 2 for AA, 2 for the lens,
  1 for the shutter; a segment that shades draws 4.

The lanes come from `segment_counts`, the reference's path of each lane
(reference/texenv.py's `intersect` and `trace`'s scatter, restated here
for K1's scenes: no texture, no environment)."""
from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import torch

OPS_RAY = 44
OPS_CUBE = 50
OPS_SPHERE = 26
OPS_DISTANCE = 36
OPS_MOTION_TEST = 6
OPS_MOTION_POINT = 3
OPS_MISS = 2
OPS_WINNER = 52
OPS_CUBE_FACE = 15
OPS_SPHERE_NORMAL = 4
OPS_EMIT = 9
OPS_SHADE = 23
OPS_DIFFUSE = 73
OPS_MIRROR = 14
OPS_GLASS = 44
OPS_TRANSMIT = 44
OPS_CAMERA = 32
OPS_LENS = 48
OPS_SHUTTER = 1
OPS_DRAW = {"philox": 1, "stratified": 5, "uniforms": 0}
K1_PIXEL_BYTES = 2 * 3 * 4    # the accumulator's pixel in and out
BYTES_F32 = 4
# segment_counts' keys: by bounce, the segments alive on entering it
# ("live"), their tests that hit ("hits"), those whose nearest hit is a
# cube or a sphere, those that hit an emitter, and those that shade, by
# the lobe their draw picks (glass split by whether the ray goes through)
LOBES = ("diffuse", "mirror", "glass", "transmit")
COUNTS = ("live", "hits", "cube_wins", "sphere_wins", "emit") + LOBES
LOBE_OPS = {"diffuse": OPS_DIFFUSE, "mirror": OPS_MIRROR,
            "glass": OPS_GLASS, "transmit": OPS_GLASS + OPS_TRANSMIT}


def test_ops(kind: str) -> int:
    """One test of a geom of `kind` ("cube" or "sphere") up to its hit."""
    return OPS_RAY + (OPS_CUBE if kind == "cube" else OPS_SPHERE)


def k1_work(pixels: int, counts: Dict[str, List[int]],
            geom_kinds: Sequence[str], *, motion: bool, lens: bool,
            sampler: str, table_floats: int) -> Dict[str, float]:
    """One K1 launch's operations and bytes: `pixels` camera rays and
    accumulator pixels; the segments of `counts` (`segment_counts`' keys)
    testing every geom (`geom_kinds`), each test that hits its distance,
    each hit its winner, emission or shading; the scene table read once."""
    s = {k: sum(counts[k]) for k in COUNTS}
    draw = OPS_DRAW[sampler]
    per_live = sum(test_ops(k) for k in geom_kinds) + OPS_MISS
    per_hit = OPS_DISTANCE
    per_win = OPS_WINNER
    camera = OPS_CAMERA + 2 * draw
    if motion:
        per_live += OPS_MOTION_TEST * len(geom_kinds)
        per_hit += OPS_MOTION_POINT
        per_win += OPS_MOTION_TEST + OPS_MOTION_POINT
        camera += OPS_SHUTTER + draw
    if lens:
        camera += OPS_LENS + 2 * draw
    shades = sum(s[k] for k in LOBES)
    flops = (s["live"] * per_live + s["hits"] * per_hit
             + s["cube_wins"] * (per_win + test_ops("cube") + OPS_CUBE_FACE)
             + s["sphere_wins"] * (per_win + test_ops("sphere")
                                   + OPS_SPHERE_NORMAL)
             + s["emit"] * OPS_EMIT
             + shades * (OPS_SHADE + 4 * draw)
             + sum(s[k] * LOBE_OPS[k] for k in LOBES)
             + (s["transmit"] * OPS_MOTION_POINT if motion else 0)
             + pixels * camera)
    return dict(flops=float(flops),
                bytes=float(pixels * K1_PIXEL_BYTES
                            + table_floats * BYTES_F32))


def table_floats(geoms: int, materials: int) -> int:
    """The packed scene table's floats (ops/megakernel.py's layout: a
    20-float header, 40 a geom, 16 a material)."""
    return 20 + 40 * geoms + 16 * materials


def segment_counts(tab, pix: torch.Tensor, iteration: int,
                   depth: int) -> Dict[str, List[int]]:
    """`COUNTS` by bounce of the lanes `pix` at `iteration` of the lattice,
    on the reference's paths: each bounce takes the nearest hit from
    reference/texenv.intersect over all geoms, each geom's own hit from it
    over that geom alone, and the next ray by trace's scatter."""
    from reference import scene as RS
    from reference import texenv as TX
    from reference import tracer as R
    from reference.tracer import RAY_EPS, dot, maximum, normalize
    draws = R.LatticeDraws(torch.full_like(pix, iteration), pix)
    o, d, _ = R.camera_rays(tab, pix, draws, antialias=True, dof=True)
    dt, mats = tab.dt, tab.materials
    alone = []
    for g in tab.geoms:
        one = copy.copy(tab)
        one.geoms = [g]
        alone.append(one)
    cube = torch.tensor([g["kind"] == RS.CUBE for g in tab.geoms],
                        device=pix.device)
    alive = torch.ones(pix.shape, dtype=torch.bool, device=pix.device)
    out: Dict[str, List[int]] = {k: [] for k in COUNTS}
    with torch.no_grad():
        for b in range(depth):
            t, normal, point, surf, outside, _, _, mat = TX.intersect(
                tab, o, d, alive)
            ts = torch.stack([TX.intersect(one, o, d, alive)[0]
                              for one in alone])
            hits = ts != -1.0
            # the first geom strictly nearest, as K1's loop keeps it
            won = torch.where(hits, ts, torch.inf).argmin(0)
            hit_ok = t > 0.0
            emit = mats["emittance"][mat]
            is_light = hit_ok & (emit > 0.0)
            us = [x.to(dt) for x in draws.bounce(b)]
            ior = mats["ior"][mat]
            p_refr = R.clip(mats["has_refractive"][mat], 0.0, 1.0)
            p_spec = R.clip(mats["has_reflective"][mat], 0.0, 1.0) \
                * (1.0 - p_refr)
            take_refr = us[0] < p_refr
            take_spec = ~take_refr & (us[0] < p_refr + p_spec)
            d_diff = R.cosine_hemisphere(normal, us[1], us[2])
            d_spec = d - 2.0 * dot(d, normal)[:, None] * normal
            safe_ior = maximum(ior, 1e-6)
            one_ = torch.ones_like(ior)
            eta = torch.where(outside, 1.0 / safe_ior, safe_ior)
            cos_i = R.clip(-dot(d, normal), 0.0, 1.0)
            eta_i = torch.where(outside, one_, ior)
            eta_t = torch.where(outside, ior, one_)
            q = (eta_i - eta_t) / (eta_i + eta_t)
            r0 = q * q
            x = 1.0 - cos_i
            x2 = x * x
            fres = r0 + (1.0 - r0) * (x * (x2 * x2))
            sin2_t = eta * eta * maximum(1.0 - cos_i * cos_i, 0.0)
            cos_t = torch.sqrt(maximum(1.0 - sin2_t, 1e-20))
            k_r = eta * cos_i - cos_t
            d_refr = eta[:, None] * d + k_r[:, None] * normal
            refl_instead = (sin2_t > 1.0) | (us[3] < fres)
            d_refr = torch.where(refl_instead[:, None], d_spec, d_refr)
            new_dir = normalize(torch.where(
                take_refr[:, None], d_refr,
                torch.where(take_spec[:, None], d_spec, d_diff)))
            shades = alive & hit_ok & ~is_light
            transmit = take_refr & ~refl_instead
            for k, m in (("live", alive),
                         ("cube_wins", alive & hit_ok & cube[won]),
                         ("sphere_wins", alive & hit_ok & ~cube[won]),
                         ("emit", alive & is_light),
                         ("diffuse", shades & ~take_refr & ~take_spec),
                         ("mirror", shades & take_spec),
                         ("glass", shades & take_refr & ~transmit),
                         ("transmit", shades & transmit)):
                out[k].append(int(m.sum()))
            out["hits"].append(int((hits & alive).sum()))
            push = torch.where(transmit, 2.0 * RAY_EPS, 0.0).to(dt)
            o = torch.where(transmit[:, None], surf, point) \
                + push[:, None] * new_dir
            d = new_dir
            alive = shades & (b < depth - 1)
    return out
