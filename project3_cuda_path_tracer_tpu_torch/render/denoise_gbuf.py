"""G-buffer construction for the à-trous denoiser (render/denoise.py).

Counterpart of project3_cuda_path_tracer_tpu/render/denoise_gbuf.py: the
render-side queries of the filter (deterministic camera rays, first hits
through the port's `intersect_planar` (K2 on a mesh, on the card), the
one-level mirror relay, the shade-time base albedo, whose atlas texels come
through `ops.texfetch.take_u32`, P1 on the card).

Two differences from the JAX module, both by decision:
  - the pixels come in row-major order: the port has no TxT tile swizzle
    (TraceConfig.tile), so there is nothing to unswizzle;
  - on a scene with an aperture or a shutter the JAX G-buffer draws its
    camera rays' lens and time samples from PRNGKey(0), the port from a
    torch generator seeded 0; the two then differ lane for lane. Without
    either the rays are the pinhole's in both packages.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import vec
from ..ops import wavefront as wf


def _base_albedo(scene, mat_id, u, v, materials=None, textures=None):
    """Shade-time base colour for per-lane material ids: flat material
    colour -> atlas texel -> procedural checker (the precedence of
    ops/wavefront.shade_planar). `materials`/`textures` default to the
    scene's."""
    mats = scene.materials if materials is None else materials
    tex = scene.textures if textures is None else textures
    alb = wf._mat_select(mats.color, mat_id)
    if tex.atlas.shape[0] > 1 or tex.atlas.shape[1] > 1:
        alb = wf._sample_texture_planar(tex, mat_id, u, v, alb)
    cs = wf._mat_select(tex.checker_scale, mat_id)
    c2 = wf._mat_select(tex.checker_color2, mat_id)
    par = torch.remainder(torch.floor(u * cs) + torch.floor(v * cs), 2.0)
    return vec.where((cs > 0) & (par > 0.5), c2, alb)


def _lobe_probs(scene, mat_id, materials=None):
    """(p_refr, p_spec) per lane: shade_planar's lobe split."""
    mats = scene.materials if materials is None else materials
    p_refr = wf._clip(wf._mat_select(mats.has_refractive, mat_id), 0., 1.)
    p_spec = (wf._clip(wf._mat_select(mats.has_reflective, mat_id), 0., 1.)
              * (1.0 - p_refr))
    return p_refr, p_spec


def gbuffer(scene, cfg, packed_meshes=(), albedo: bool = False,
            relay: bool = True, tables: Optional[tuple] = None):
    """First-hit [H,W,3] (normal, world position) G-buffers from the
    deterministic (no-AA) camera rays; with `albedo`, also the [H,W,3]
    base-albedo plane for demodulated filtering. Miss lanes get normal 0,
    position 1e6 and albedo 1, so background pixels only mix with each
    other.

    `tables` = (materials, camera dict, geoms, textures) on the device to
    trace on (a Renderer's `tables`), with `packed_meshes` on the same
    device; by default the scene's own tables, on the CPU.

    Mirror relay (`relay`, and some material reflective): pixels whose
    first hit is specular-dominant carry the reflected surface's geometry
    (one deterministic bounce), so the filter edge-stops on the reflected
    geometry and mirror images stay sharp. Glass stays first-surface.

    Albedo: diffuse-dominant non-emissive hits carry their shade-time base
    colour; through a mirror the factor is spec_color x (the reflected
    surface's base colour when that is diffuse non-emissive, else 1);
    emissive, glass and miss lanes get 1 (not albedo-separable)."""
    if tables is None:
        tables = (scene.materials, scene.camera.flat(), scene.geoms,
                  scene.textures)
    mats, cam, geoms, tex = tables
    dev = cam["position"].device
    gen = None
    if cfg.dof or cfg.motion:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    o, d, times, _ = wf.generate_rays_planar(
        cam, cfg.width, cfg.height, gen, antialias=False, dof=cfg.dof,
        motion=cfg.motion)

    def intersect(orig, dirs):
        return wf.intersect_planar(orig, dirs, times, geoms, cfg.geom_types,
                                   packed_meshes, cfg.mesh_ids,
                                   sphere_batch=cfg.sphere_batch,
                                   sdf_kinds=cfg.sdf_kinds)

    hit = intersect(o, d)
    h, w = cfg.height, cfg.width
    p_refr1, p_spec1 = _lobe_probs(scene, hit.mat_id, mats)

    any_mirror = relay and bool(
        np.any(mats.has_reflective.detach().cpu().numpy() > 0))
    if any_mirror:
        mirror = (hit.t > 0.0) & (p_spec1 >= 0.5)
        ddn = vec.dot(d, hit.normal)
        d2 = vec.V3(d.x - 2.0 * ddn * hit.normal.x,
                    d.y - 2.0 * ddn * hit.normal.y,
                    d.z - 2.0 * ddn * hit.normal.z)
        hit2 = intersect(hit.point, d2)
        eff_t = torch.where(mirror, hit2.t, hit.t)
        eff_normal = vec.where(mirror, hit2.normal, hit.normal)
        eff_point = vec.where(mirror, hit2.point, hit.point)
        eff_mat = torch.where(mirror, hit2.mat_id, hit.mat_id)
        eff_u = torch.where(mirror, hit2.u, hit.u)
        eff_v = torch.where(mirror, hit2.v, hit.v)
    else:
        eff_t, eff_normal, eff_point = hit.t, hit.normal, hit.point
        eff_mat, eff_u, eff_v = hit.mat_id, hit.u, hit.v

    miss = eff_t <= 0.0

    def plane(v, far=0.0):
        return torch.where(miss, torch.full_like(v, far), v).reshape(h, w)

    normal = torch.stack([plane(c) for c in eff_normal], dim=-1)
    pos = torch.stack([plane(c, 1e6) for c in eff_point], dim=-1)
    if not albedo:
        return normal, pos

    alb = _base_albedo(scene, eff_mat, eff_u, eff_v, mats, tex)
    p_refr_e, p_spec_e = _lobe_probs(scene, eff_mat, mats)
    emitt_e = wf._mat_select(mats.emittance, eff_mat)
    # the effective surface demodulates when it is a diffuse-dominant,
    # non-emissive hit (through a mirror: the reflected surface)
    ok = (eff_t > 0.0) & (emitt_e <= 0.0) & (p_refr_e + p_spec_e < 0.5)
    one = torch.ones_like(alb.x)
    alb = vec.where(ok, alb, vec.V3(one, one, one))
    if any_mirror:
        # mirror pixels: radiance = spec_color x L_reflected, so the
        # specular tint demodulates on those lanes unconditionally
        spec1 = wf._mat_select(mats.specular_color, hit.mat_id)
        alb = vec.where(mirror, vec.V3(alb.x * spec1.x, alb.y * spec1.y,
                                       alb.z * spec1.z), alb)
        demod_on = mirror | ok
    else:
        demod_on = ok
    alb_img = torch.stack([torch.where(demod_on, c, one).reshape(h, w)
                           for c in alb], dim=-1)
    return normal, pos, alb_img
