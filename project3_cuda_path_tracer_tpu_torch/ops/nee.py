"""Next-event estimation: the area-light table, its sampler and the
shadow-ray set-up, and the env map's alias table and sampler.

Counterpart of project3_cuda_path_tracer_tpu/ops/nee.py. At every diffuse-capable hit the integrator samples one point
uniformly by area over the union of the scene's emissive surfaces, casts a
shadow ray through `ops.wavefront.intersect_planar(any_hit=True, max_t=)`
and adds the area-form direct term in `ops.wavefront.shade_planar`, weighted
against BSDF sampling by the one-sample balance heuristic:

    throughput * albedo * Le * pdf_bsdf / (pdf_light + pdf_bsdf)

with pdf_light = d^2 / (|cos_l| * A_total). Emitters are two-sided (any hit
on an emissive geom collects its emittance, as in the reference); a sample
on a face turned away is killed by its own occlusion test.

The light table is static, built on the host from the scene's transforms
(which the train step never optimises); the emitted radiance is read from
the traced material table at shade time, so NEE stays differentiable in the
lights' colour and emittance.

Env-map NEE samples a texel of the equirect env map by the alias method
(`build_env_alias`, texels weighted by luminance times solid angle) and a
direction uniform in solid angle inside it (`sample_env_planar`), so that
the pdf of any direction is lum(its texel) * C; the BSDF side's MIS weight
on an env miss is then free (`env_lum` of the texel already fetched). The
alias table's fetches and the env texel's go through ops/texfetch.py (P1 on
the card).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .vec import V3
from . import texfetch
from . import vec
from . import wavefront as wf
from ..scene import types as T

# Face record layout (floats):
#   (cum_frac, kind, ox,oy,oz, ux,uy,uz, vx,vy,vz, nx,ny,nz, mat_id, radius)
# kind 0 = parallelogram (a cube face), kind 1 = sphere (o = centre).
FACE_LEN = 16


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def build_light_table(scene: T.Scene) -> Tuple[tuple, float]:
    """The static light table of `scene`: (faces, total_area).

    Eligible emitters: a CUBE under any affine transform (each face is a
    world-space parallelogram, so uniform area sampling stays uniform) and
    a SPHERE of uniform scale. Returns ((), 0.0) when the scene has no
    emitter or any emitter is ineligible (a mesh, an ellipsoid): a partial
    table would bias the MIS pairing, so it is all or nothing."""
    types = _np(scene.geoms.type)
    mat_ids = _np(scene.geoms.material_id)
    emit = _np(scene.materials.emittance)
    xforms = _np(scene.geoms.transform)
    inv_t = _np(scene.geoms.inverse_transpose)

    faces = []
    for g in range(types.shape[0]):
        m = int(mat_ids[g])
        if emit[m] <= 0.0:
            continue
        M = xforms[g]
        if types[g] == T.CUBE:
            for k in range(3):
                for s in (0.5, -0.5):
                    ka, kb = (k + 1) % 3, (k + 2) % 3
                    corner = np.full(3, -0.5)
                    corner[k] = s
                    o = (M[:3, :3] @ corner) + M[:3, 3]
                    eu = M[:3, ka].copy()
                    ev = M[:3, kb].copy()
                    area = float(np.linalg.norm(np.cross(eu, ev)))
                    n_obj = np.zeros(3)
                    n_obj[k] = np.sign(s)
                    n = inv_t[g][:3, :3] @ n_obj
                    nn = np.linalg.norm(n)
                    n = n / nn if nn > 0 else n_obj
                    faces.append((0.0, 0.0, *o.tolist(), *eu.tolist(),
                                  *ev.tolist(), *n.tolist(), float(m),
                                  0.0, area))
        elif types[g] == T.SPHERE:
            s0, s1, s2 = (np.linalg.norm(M[:3, i]) for i in range(3))
            if abs(s0 - s1) > 1e-5 * s0 or abs(s0 - s2) > 1e-5 * s0:
                return (), 0.0  # an ellipsoid: ineligible
            r = 0.5 * float(s0)
            c = M[:3, 3]
            area = 4.0 * math.pi * r * r
            faces.append((0.0, 1.0, *c.tolist(), 0.0, 0.0, 0.0,
                          0.0, 0.0, 0.0, 0.0, 0.0, 0.0, float(m), r, area))
        else:
            return (), 0.0  # an emissive mesh or SDF: ineligible
    if not faces:
        return (), 0.0
    total = sum(f[-1] for f in faces)
    out = []
    cum = 0.0
    for f in faces:
        cum += f[-1] / total
        out.append((cum,) + tuple(f[1:-1]))
    out[-1] = (1.0,) + out[-1][1:]  # pin the last cum against float drift
    return tuple(out), float(total)


_TABLES = {}  # (faces, device) -> the [F, FACE_LEN] float32 table


def light_table(faces: tuple, device) -> torch.Tensor:
    """The face records as one float32 [F, FACE_LEN] tensor on `device`,
    made once per table and device."""
    key = (faces, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.tensor(faces, dtype=torch.float32,
                                    device=device)
    return _TABLES[key]


def sample_lights_planar(faces: tuple, u_face: torch.Tensor,
                         u1: torch.Tensor, u2: torch.Tensor):
    """A uniform-by-area sample over the light union: (lp V3, ln V3,
    light_mat [N] int64).

    One form for every table size: the face index by a search of the CDF
    column (u in [cum_{j-1}, cum_j) picks face j), then the face's row by
    a gather. The JAX package unrolls tables of up to 16 faces into
    chained selects and gathers above; both give these samples (the JAX
    tests/test_nee.py::test_gather_sampler_matches_unroll)."""
    tab = light_table(faces, u1.device)
    if tab.shape[0] > 1:
        fi = torch.searchsorted(tab[:-1, 0].contiguous(), u_face.detach(),
                                right=True)
    else:
        fi = torch.zeros(u1.shape, dtype=torch.int64, device=u1.device)
    rows = tab[fi]

    def g(col):
        return rows[:, col]

    o = V3(g(2), g(3), g(4))
    # sphere: a uniform point on the sphere of radius r about o
    r = g(15)
    z = 1.0 - 2.0 * u1
    rxy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = u2 * (2.0 * math.pi)
    w = V3(rxy * torch.cos(phi), rxy * torch.sin(phi), z)
    lp_s = V3(o.x + r * w.x, o.y + r * w.y, o.z + r * w.z)
    # parallelogram: o + u1 * eu + u2 * ev
    eu = V3(g(5), g(6), g(7))
    ev = V3(g(8), g(9), g(10))
    lp_p = V3(o.x + u1 * eu.x + u2 * ev.x,
              o.y + u1 * eu.y + u2 * ev.y,
              o.z + u1 * eu.z + u2 * ev.z)
    sph = g(1) >= 0.5
    lp = vec.where(sph, lp_s, lp_p)
    ln = vec.where(sph, w, V3(g(11), g(12), g(13)))
    return lp, ln, g(14).to(torch.int64)


def shadow_setup(p: V3, lp: V3, ln: V3, total_area: float):
    """The shadow ray's direction and the area-form geometry term:
    (wl V3, dist [N], geom [N]) with geom = |cos_l| * A_total / d^2."""
    dv = V3(lp.x - p.x, lp.y - p.y, lp.z - p.z)
    dist = torch.sqrt(torch.clamp(vec.dot(dv, dv), min=1e-12))
    wl = V3(dv.x / dist, dv.y / dist, dv.z / dist)
    cos_l = torch.abs(vec.dot(ln, wl))
    geom = cos_l * total_area / (dist * dist)
    return wl, dist, geom


_LUM = (0.2126, 0.7152, 0.0722)


def build_env_alias(env: np.ndarray):
    """The alias table of env-map importance sampling (the JAX
    `build_env_alias`, Vose's construction, bit for bit).

    `env` is the [He,We,3] equirect radiance image. Texel weights are
    luminance times the texel's exact solid angle, so the solid-angle pdf
    of a direction is lum(its texel) * C with C = We / (2 pi sum(lum *
    dcos)). Returns (alias [T] int32, prob [T] float32, C) with T = He*We,
    or None for a black or absent env."""
    he, we = env.shape[0], env.shape[1]
    if he * we <= 1:
        return None
    lum = (env[..., 0] * _LUM[0] + env[..., 1] * _LUM[1]
           + env[..., 2] * _LUM[2]).astype(np.float64)
    # the exact solid angle of a row: the integral of sin over its band
    edges = np.cos(np.arange(he + 1, dtype=np.float64) * math.pi / he)
    dcos = edges[:-1] - edges[1:]
    w = (lum * dcos[:, None]).reshape(-1)
    total = w.sum()
    if total <= 0:
        return None
    t = w.size
    p = w / total * t
    alias = np.arange(t, dtype=np.int64)
    prob = p.copy()
    small = [i for i in np.nonzero(p < 1.0)[0]]
    large = [i for i in np.nonzero(p >= 1.0)[0]]
    while small and large:
        s, big = small.pop(), large.pop()
        prob[s] = p[s]
        alias[s] = big
        p[big] = (p[big] + p[s]) - 1.0
        (small if p[big] < 1.0 else large).append(big)
    for i in small + large:
        prob[i] = 1.0
    c = we / (2.0 * math.pi * total)
    return alias.astype(np.int32), prob.astype(np.float32), float(c)


def sample_env_planar(textures: T.Textures, u_idx: torch.Tensor,
                      u_acc: torch.Tensor, u_x: torch.Tensor,
                      u_y: torch.Tensor):
    """One env-map direction a lane from the alias table: (wl V3, le V3).

    u_idx picks a texel slot, u_acc keeps it or takes its alias, and the
    direction inverts the equirect mapping of
    ops/wavefront._env_flat_index with cos(theta) linear inside the texel's
    band (uniform in solid angle, which makes pdf = env_lum(le) * C exact).
    The slot's probability, its alias and the texel are three fetches
    through ops/texfetch.py."""
    he, we = textures.env.shape[0], textures.env.shape[1]
    t = he * we
    i = torch.clamp((u_idx * t).to(torch.int32), 0, t - 1)
    take_alias = u_acc >= texfetch.take_f32(textures.env_prob, i)
    idx = torch.where(take_alias, texfetch.take_u32(textures.env_alias, i), i)
    y = torch.div(idx, we, rounding_mode="floor").to(torch.float32)
    x = torch.remainder(idx, we).to(torch.float32)
    c0 = torch.cos(y * (math.pi / he))
    c1 = torch.cos((y + 1.0) * (math.pi / he))
    ct = c0 + u_y * (c1 - c0)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    a = ((x + u_x) / we - 0.5) * (2.0 * math.pi)
    wl = V3(st * torch.sin(a), ct, -st * torch.cos(a))
    if texfetch.full(textures.env_packed, t):
        le = wf._unpack_rgbe(texfetch.take_u32(textures.env_packed, idx),
                             textures.env_enabled)
    else:
        le = wf._take_f32x3(textures.env, idx)
    return wl, le


def env_lum(v: V3) -> torch.Tensor:
    """The luminance plane of build_env_alias' texel weights."""
    return v.x * _LUM[0] + v.y * _LUM[1] + v.z * _LUM[2]
