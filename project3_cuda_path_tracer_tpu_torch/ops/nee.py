"""Next-event estimation, the area-light half: the light table, its
sampler and the shadow-ray set-up.

Counterpart of the area-light functions of project3_cuda_path_tracer_tpu/
ops/nee.py. At every diffuse-capable hit the integrator samples one point
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
lights' colour and emittance. The env-map sampler (`build_env_alias`,
`sample_env_planar`) waits for slice D.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .vec import V3
from . import vec
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
