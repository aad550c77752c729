"""Progressive path-tracing integrator: primitive, SDF and mesh scenes,
textures and environment lighting, direct lighting, and the integrator
features of slice E.

Counterpart of project3_cuda_path_tracer_tpu/render/integrator.py: one
iteration (one sample per pixel) traces the whole W*H wavefront through
`trace_wavefront` (ray generation, then depth x (intersect -> [light sample
and shadow pass] -> [sort] -> shade -> [Russian roulette])) and adds its
radiance, clamped per sample on request, into the [H,W,3] accumulator
(finalGather, reference src/pathtrace.cu:269-278).

`Renderer` picks one of two routes from the scene and the settings:
  megakernel  every scene `ops.megakernel.supports` accepts (cubes and
              spheres, no glossy lobe or dispersion) rendered without NEE
              and without the knobs K1 lacks (`_megakernel_lacks`: sort,
              compaction, Russian roulette, the Sobol sampler, the clamp,
              the first-bounce cache): one `ops.megakernel.iteration` per
              iteration, the CUDA megakernel on the card;
  wavefront   the other scenes (meshes, SDFs, dispersion, the glossy lobe,
              textures, checkers, bump and normal maps, env maps and the
              procedural sky), and every render with NEE, RIS or ReSTIR or
              one of those knobs:
              `trace_wavefront` on the Renderer's device, whose mesh hits
              go through the BVH traversal kernels (ops/bvh8.py,
              ops/pallas_bvh.py), the shadow rays through K2's any-hit
              mode, and the texel fetches through P1 (ops/texfetch.py).
Direct lighting (`settings.nee`, `nee_ris`, `restir`) follows ops/nee.py:
one light sample a bounce with one-sample MIS from the area lights, the
env map, or a mixture of both (`_wire_nee`), RIS over M candidates, and
the per-pixel temporal reservoir of ReSTIR at depth 0 (area lights only).
Slice E (`trace_wavefront`): material sort and compaction of the path state
each bounce (ops/compact.py), Russian roulette, the Sobol sampler
(ops/qmc.py), SDF primitives (ops/sdf.py), spectral dispersion, the
per-sample clamp and the first-bounce cache (`Renderer`). Slice F, the
render services: adaptive sampling (`TraceConfig.adaptive`, the path->pixel
override of `trace_wavefront`, render/adaptive.py), the checkpoint extras
(render/checkpoint.py) and the denoised image (render/denoise.py), in
`Renderer`. Slice I, device-resident chunks: on the card `step_many`
replays one captured CUDA graph of a wavefront iteration (`render_chunk`,
the JAX `render_chunk`'s counterpart), bit for bit the eager steps.
"""
from __future__ import annotations

import dataclasses
import hashlib
import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..ops import compact as compaction
from ..ops import megakernel as mk
from ..ops import nee as nee_mod
from ..ops import texfetch
from ..ops import vec
from ..ops import wavefront as wf
from ..ops.vec import V3
from ..scene import parser
from ..scene import types as T
from ..utils import image as img_io
from ..utils.device import (CapturedGraph, capture_graph, resolve_device,
                            synchronize)
from ..utils.launches import launch_counts
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static render knobs of one trace (the JAX TraceConfig fields the
    slice reads)."""
    width: int
    height: int
    trace_depth: int
    antialias: bool = True
    geom_types: Tuple[int, ...] = ()
    # evaluate the glossy Phong lobe (some material has SPECEX > 0)
    glossy: bool = True
    # evaluate the procedural sky (the scene has ENVSKY)
    sky: bool = False
    # thin-lens / motion-blur math (the scene has APERTURE+FOCAL / SHUTTER)
    dof: bool = True
    motion: bool = True
    # stratified lattice draws keyed on (iteration, depth, pixel)
    stratified: bool = False
    # per-geom index into Scene.packed_meshes, -1 for primitives
    mesh_ids: Tuple[int, ...] = ()
    # recompute mesh hits from the winning triangle in torch ops, so
    # gradients flow through them (the train step on mesh scenes)
    differentiable_mesh: bool = False
    # geoms that `ops.wavefront._batched_spheres_planar` tests in one
    # blocked pass (set by build_trace_config above SPHERE_BATCH_MIN
    # eligible spheres: the many-light scenes)
    sphere_batch: Tuple[int, ...] = ()
    # Area-light NEE (ops/nee.py): the static light table (`nee_lights`,
    # face records, from nee.build_light_table) and the union's area.
    # Set by `_wire_nee`.
    nee: bool = False
    nee_lights: Tuple = ()
    nee_area: float = 0.0
    # RIS (--nee-ris M): one shadow ray a bounce, resampled from M light
    # candidates (Talbot et al. 2005). 0/1 = off.
    nee_ris: int = 0
    # temporal ReSTIR (--restir M): at depth 0 the M fresh candidates merge
    # with the pixel's reservoir from the previous iteration, whose count
    # is capped at restir_cap * M (trace_wavefront `reservoir=`)
    restir: bool = False
    restir_cap: float = 20.0
    # Env-map NEE (`_wire_nee`): an importance-sampled HDR env map, C its
    # pdf constant (pdf = lum * C). With area lights too each bounce
    # samples the area union with probability nee_q, else the env map;
    # nee_q is 1 with area lights alone and 0 with the env map alone.
    nee_env: bool = False
    nee_env_c: float = 0.0
    nee_q: float = 1.0
    # bump and normal maps (some material has BUMP / NORMALMAP); nmap also
    # makes the intersect stage return uv tangents
    bump: bool = False
    nmap: bool = False
    # bilinear texture and env filtering (--bilinear), through the pair
    # planes (--bilinear-fast)
    bilinear: bool = False
    bilinear_fast: bool = False
    # per-geom SDF kind triples (Scene.sdf_kinds), () without SDF geoms
    sdf_kinds: Tuple = ()
    # the refractive lobe's per-band ior (some material has DISPERSION > 0)
    dispersion: bool = False
    # Slice E. sort_materials / compact: permute the path state and the hit
    # each bounce, live hits grouped by material, then live misses, then
    # dead lanes (one permutation serves both, as in the JAX package); the
    # draws are keyed on the path's pixel, so the image is unchanged bit for
    # bit. russian_roulette: paths die from the third bounce with
    # probability 1 - q, q = clip(max(throughput), 0.05, 0.95), survivors
    # boosted by 1/q. strat_impl: the stratified sampler ("lattice" or
    # "sobol"). clamp > 0 caps each sample's radiance (biased, opt-in).
    sort_materials: bool = False
    compact: bool = False
    russian_roulette: bool = False
    strat_impl: str = "lattice"
    clamp: float = 0.0
    # Adaptive sampling (render/adaptive.py): the path->pixel mapping comes
    # from a host-planned override, several paths may share a pixel, and
    # trace_wavefront returns (per-path radiance, pixel ids) for the caller
    # to scatter.
    adaptive: bool = False
    # Under autograd, run each bounce (intersect + shade) under
    # torch.utils.checkpoint: the backward pass recomputes a bounce from its
    # inputs and the bounce's draws, which are taken before it, so only one
    # bounce's saved tensors live at a time (the JAX `remat`; set by the
    # train step's `models.inverse.train_config`). Renders without a
    # permutation, NEE or a cached first hit only.
    remat: bool = False
    # The global path range [lo, hi) this process traces, () for the whole
    # frame (the JAX `ray_sharding`; set by parallel/sharding.py). Paths
    # keep their global pixel index, and the pseudo-random draws are taken
    # for the whole frame and sliced, so a sharded frame equals the
    # single-process one.
    ray_range: Tuple[int, ...] = ()


# Fewest eligible spheres for the batched pass: scenes with a handful keep
# the per-geom tests, as in the JAX package.
SPHERE_BATCH_MIN = 9


def _eligible_sphere_batch(scene: T.Scene) -> Tuple[int, ...]:
    """Geom indices for TraceConfig.sphere_batch (the JAX
    `_eligible_sphere_batch`): the spheres of uniform scale whose material
    is not textured, checkered, normal-mapped or bumped (the batch computes
    no uv), when at least SPHERE_BATCH_MIN qualify; else ()."""
    xf = scene.geoms.transform.detach().cpu().numpy()
    mats = scene.geoms.material_id.tolist()
    tx = scene.textures
    plain = ((tx.tex_id < 0) & (tx.nrm_id < 0) & (tx.checker_scale <= 0)
             & (tx.bump[:, 0] <= 0)).tolist()
    elig = []
    for g, t in enumerate(scene.geoms.type.tolist()):
        if t != T.SPHERE or not plain[mats[g]]:
            continue
        s0, s1, s2 = (float(np.linalg.norm(xf[g][:3, i])) for i in range(3))
        if abs(s0 - s1) <= 1e-5 * s0 and abs(s0 - s2) <= 1e-5 * s0:
            elig.append(g)
    return tuple(elig) if len(elig) >= SPHERE_BATCH_MIN else ()


def build_trace_config(scene: T.Scene, settings=None) -> TraceConfig:
    """RenderSettings -> TraceConfig, as the JAX `build_trace_config`
    (integrator.py:992-1060) resolves the fields above. NEE and ReSTIR are
    wired by `Renderer` (`_wire_nee`), as in the JAX package.

    With `bilinear_fast` on a textured scene the pair planes are built here,
    at first use, and stored into scene.textures: the atlas's
    (parser.build_atlas_pair) and the env map's (image.pack_env_pair)."""
    settings = settings or scene.settings
    w, h = scene.camera.resolution
    tx = scene.textures
    fast = bool(settings.bilinear_fast)
    if fast and tx.atlas_pair.shape[0] == 1:
        pair = parser.build_atlas_pair(tx)
        if pair is not None:
            tx = dataclasses.replace(tx, atlas_pair=pair)
    if fast and tx.env_pair.shape[0] == 1 and tx.has_env:
        tx = dataclasses.replace(tx, env_pair=torch.from_numpy(
            img_io.pack_env_pair(tx.env.cpu().numpy()).view(np.int32)))
    scene.textures = tx
    mt = scene.materials
    return TraceConfig(
        width=w, height=h, trace_depth=settings.trace_depth,
        antialias=settings.antialias,
        geom_types=tuple(int(t) for t in scene.geoms.type.tolist()),
        glossy=bool((scene.materials.specular_exponent > 0).any()),
        sky=bool(float(scene.textures.sky[0]) > 0),
        dof=bool(scene.camera.aperture > 0
                 and scene.camera.focal_distance > 0),
        motion=bool(scene.camera.shutter > 0),
        stratified=settings.stratified,
        mesh_ids=tuple(int(m) for m in scene.geoms.mesh_id.tolist()),
        sphere_batch=_eligible_sphere_batch(scene),
        nee_ris=int(settings.nee_ris),
        bump=bool((tx.bump[:, 0] > 0).any()),
        nmap=bool((tx.nrm_id >= 0).any()),
        bilinear=bool(settings.bilinear), bilinear_fast=fast,
        sdf_kinds=tuple(scene.sdf_kinds),
        dispersion=bool(mt.dispersion is not None
                        and (mt.dispersion > 0).any()),
        sort_materials=bool(settings.sort_materials),
        compact=bool(settings.compact),
        russian_roulette=bool(settings.russian_roulette),
        strat_impl=settings.strat_impl, clamp=float(settings.clamp),
        adaptive=bool(settings.adaptive))


# mixed into the seed of a Renderer step's light generator
LIGHT_SALT = 0x4E4545

RESERVOIR_KEYS = ("lpx", "lpy", "lpz", "lnx", "lny", "lnz",
                  "lex", "ley", "lez", "W", "M")


def init_reservoir(n: int, device) -> dict:
    """An empty per-pixel temporal reservoir (ReSTIR): the stored light
    point, normal and emission planes and the running (W, M) pair, 11 [N]
    planes on `device`. M == 0 marks an empty slot, so the first iteration
    is plain fresh RIS."""
    return {k: torch.zeros((n,), dtype=torch.float32, device=device)
            for k in RESERVOIR_KEYS}


def light_generator(generator: torch.Generator) -> torch.Generator:
    """The light draws' own generator, derived from the state of the
    camera and BSDF draws' `generator` (so enabling NEE does not shift
    their stream, and two renders that share a generator, as the
    two-render train step's do, still draw independent lights)."""
    state = generator.get_state().numpy().tobytes()
    seed = int.from_bytes(hashlib.blake2b(state + b"nee", digest_size=8)
                          .digest(), "little") & 0x7FFFFFFFFFFFFFFF
    out = torch.Generator(device=generator.device)
    out.manual_seed(seed)
    return out


def _lum(v: V3) -> torch.Tensor:
    return 0.2126 * v.x + 0.7152 * v.y + 0.0722 * v.z


def _area_sample(cfg: TraceConfig, materials: T.Materials, point: V3,
                 us3: Sequence[torch.Tensor]):
    """One light sample a lane from the union (uniform by area) as seen
    from `point`: (wl, ldist, le, pdf, lp, ln), pdf in solid angle."""
    lp, ln, lmat = nee_mod.sample_lights_planar(cfg.nee_lights, *us3)
    wl, ldist, lgeom = nee_mod.shadow_setup(point, lp, ln, cfg.nee_area)
    le_rgb = wf._mat_select(materials.color, lmat)
    le_s = wf._mat_select(materials.emittance, lmat)
    le = V3(le_rgb.x * le_s, le_rgb.y * le_s, le_rgb.z * le_s)
    pdf = 1.0 / wf._max(lgeom, 1e-20)
    return wl, ldist, le, pdf, lp, ln


def _ris_target(cfg: TraceConfig, materials: T.Materials, hit: wf.HitP,
                ray_d: V3):
    """The scalar RIS target of a light sample at `hit`: the shade
    formula's unshadowed contribution from the base material values,
    floored for positivity (any positive target is unbiased). Returns the
    function (wl, le, pdf) -> t, shared by the fresh candidates and the
    temporal reservoir's re-evaluation; it broadcasts over [M, N]."""
    mid = hit.mat_id
    alb = wf._mat_select(materials.color, mid)
    lum_b = wf._max(_lum(alb), 0.05)
    p_refr = wf._clip(wf._mat_select(materials.has_refractive, mid), 0., 1.)
    p_spec = (wf._clip(wf._mat_select(materials.has_reflective, mid), 0., 1.)
              * (1.0 - p_refr))
    p_diff = wf._max(1.0 - p_refr - p_spec, 0.)
    spc = wf._mat_select(materials.specular_color, mid)
    lum_s = wf._max(_lum(spc), 0.05) * p_spec
    if cfg.glossy:
        se = wf._mat_select(materials.specular_exponent, mid)
        mirror = wf.reflect_planar(ray_d, hit.normal)

    def target(wl: V3, le: V3, pdf: torch.Tensor) -> torch.Tensor:
        cos_j = wf._max(vec.dot(hit.normal, wl), 0.0)
        pdf_bd = p_diff * cos_j * (1.0 / np.pi)
        lum_le = _lum(le)
        t = lum_le * lum_b * pdf_bd / (pdf + pdf_bd + 1e-30)
        if cfg.glossy:
            cos_al = wf._clip(vec.dot(wl, mirror), 1e-9, 1.0)
            q_l = (se + 1.0) * (0.5 / np.pi) * wf._pow(cos_al, se)
            q_l = torch.where((se > 0.0) & (cos_j > 0.0), q_l,
                              torch.zeros_like(q_l))
            return t + lum_le * lum_s * q_l / (pdf + p_spec * q_l + 1e-30)
        return t + (lum_le * lum_s * cos_j * (0.5 / np.pi)
                    / (pdf + pdf_bd + 1e-30))
    return target


def _env_sample(cfg: TraceConfig, textures: T.Textures,
                us4: Sequence[torch.Tensor]):
    """One env-map light sample a lane: (wl, le, pdf), pdf = lum(le) * C
    in solid angle."""
    wl, le = nee_mod.sample_env_planar(textures, *us4)
    return wl, le, wf._max(nee_mod.env_lum(le) * cfg.nee_env_c, 1e-20)


def _mixed_sample(cfg: TraceConfig, materials: T.Materials,
                  textures: T.Textures, point: V3, u_sel: torch.Tensor,
                  us_area: Sequence[torch.Tensor],
                  us_env: Sequence[torch.Tensor]):
    """The one-sample mixture of the mixed mode: the area union (sampled
    from the 3 planes `us_area`) where u_sel < nee_q, else the env map
    (from the 4 planes `us_env`). Returns (wl, ldist, le, pdf, take_area,
    lp, ln) with pdf scaled by the selection probability and ldist = BIG
    on env lanes."""
    q = cfg.nee_q
    take_area = u_sel < q
    wl_a, ld_a, le_a, pdf_a, lp, ln = _area_sample(cfg, materials, point,
                                                   us_area)
    wl_e, le_e, pdf_e = _env_sample(cfg, textures, us_env)
    return (vec.where(take_area, wl_a, wl_e),
            torch.where(take_area, ld_a, torch.full_like(ld_a, wf.BIG)),
            vec.where(take_area, le_a, le_e),
            torch.where(take_area, pdf_a * q, pdf_e * (1.0 - q)),
            take_area, lp, ln)


def _shadow_max_t(ldist: torch.Tensor, take_area: Optional[torch.Tensor]):
    """The shadow ray's search bound: `ldist` a little short of the light
    sample (an area light), unbounded (BIG) on env lanes."""
    max_t = ldist * (1.0 - 1e-3) - 1e-3
    if take_area is None:
        return max_t
    return torch.where(take_area, max_t, torch.full_like(max_t, wf.BIG))


def _ris_sample(cfg: TraceConfig, materials: T.Materials,
                textures: T.Textures, hit: wf.HitP, ray_d: V3,
                alive: torch.Tensor, uf: torch.Tensor, res: Optional[dict]):
    """RIS over M = max(cfg.nee_ris, 1) light candidates (the JAX
    integrator.py:540-771): candidate j takes rows cdim*j.. of `uf`
    ([cdim*M + 1 (+1 with `res`), N]; cdim = 3 with area lights alone, 5
    in the mixed mode, whose candidates are `_mixed_sample`'s), the winner
    is the first whose running target sum passes uf[cdim*M] * total, and
    its le is scaled by total / (M * t_winner). With `res` (ReSTIR, depth
    0, area lights alone) the stored light point, re-evaluated here, is
    merged by the draw uf[cdim*M + 1] and the winner is stored back
    (before visibility) with its count capped at restir_cap * M. Returns
    (wl, max_t of the shadow ray, le_scaled, pdf, new_reservoir or
    None)."""
    m = max(cfg.nee_ris, 1)
    n = alive.shape[0]
    mixed = bool(cfg.nee_lights) and cfg.nee_env
    cdim = 5 if mixed else 3
    target = _ris_target(cfg, materials, hit, ray_d)
    # all M candidates at once as [M, N] (elementwise, so each value is
    # the one a candidate-at-a-time loop computes)
    point = V3(*(c.expand(m, n).reshape(-1) for c in hit.point))
    rows = tuple(uf[i:cdim * m:cdim].reshape(-1) for i in range(cdim))
    take_area = None
    if mixed:
        # a candidate's env sample reuses its area planes (JAX's layout)
        wl, ld, le, pdf, take_area, lp, ln = _mixed_sample(
            cfg, materials, textures, point, rows[0], rows[1:4], rows[1:5])
        take_area = take_area.reshape(m, n)
    else:
        wl, ld, le, pdf, lp, ln = _area_sample(cfg, materials, point, rows)
    shape = (m, n)
    wl, le, lp, ln = (V3(*(c.reshape(shape) for c in v))
                      for v in (wl, le, lp, ln))
    ld, pdf = ld.reshape(shape), pdf.reshape(shape)
    t = target(wl, le, pdf)
    total = t[0]
    for j in range(1, m):
        total = total + t[j]
    thresh = uf[cdim * m] * total
    cum = torch.zeros_like(total)
    sel = torch.zeros((n,), dtype=torch.int64, device=total.device)
    done = torch.zeros((n,), dtype=torch.bool, device=total.device)
    for j in range(m):
        cum = cum + t[j]
        take = (thresh < cum) & ~done
        sel = torch.where(take, j, sel)
        done = done | take

    def pick(a):
        return a.gather(0, sel[None])[0]
    wl, le, lp, ln = (V3(*(pick(c) for c in v)) for v in (wl, le, lp, ln))
    ld, pdf, t_y = pick(ld), pick(pdf), pick(t)
    if take_area is not None:
        take_area = pick(take_area)

    new_res = None
    if res is not None:
        lp_p = V3(res["lpx"], res["lpy"], res["lpz"])
        ln_p = V3(res["lnx"], res["lny"], res["lnz"])
        le_p = V3(res["lex"], res["ley"], res["lez"])
        w_prev, m_prev = res["W"], res["M"]
        wl_p, ld_p, lg_p = nee_mod.shadow_setup(hit.point, lp_p, ln_p,
                                                cfg.nee_area)
        pdf_p = 1.0 / wf._max(lg_p, 1e-20)
        t_p = torch.where(m_prev > 0.0, target(wl_p, le_p, pdf_p),
                          torch.zeros_like(m_prev))
        w_temp = t_p * w_prev * m_prev
        wsum = total + w_temp
        take_prev = uf[cdim * m + 1] * wsum < w_temp
        wl = vec.where(take_prev, wl_p, wl)
        ld = torch.where(take_prev, ld_p, ld)
        le = vec.where(take_prev, le_p, le)
        pdf = torch.where(take_prev, pdf_p, pdf)
        lp = vec.where(take_prev, lp_p, lp)
        ln = vec.where(take_prev, ln_p, ln)
        t_y = torch.where(take_prev, t_p, t_y)
        m_new = float(m) + m_prev
        s = torch.where(t_y > 0.0, wsum / (m_new * wf._max(t_y, 1e-30)),
                        torch.zeros_like(t_y))
        # the winner is stored before visibility; misses and emissive
        # first hits invalidate the slot, so a stale light point never
        # crosses a silhouette
        em0 = wf._mat_select(materials.emittance, hit.mat_id)
        valid = (hit.t > 0.0) & (em0 <= 0.0) & alive
        z = torch.zeros_like(s)
        new_res = dict(lpx=lp.x, lpy=lp.y, lpz=lp.z, lnx=ln.x, lny=ln.y,
                       lnz=ln.z, lex=le.x, ley=le.y, lez=le.z,
                       W=torch.where(valid, s, z),
                       M=torch.where(valid, torch.clamp(
                           m_new, max=float(np.float32(cfg.restir_cap * m))),
                           z))
    else:
        s = torch.where(t_y > 0.0, total / (m * wf._max(t_y, 1e-30)),
                        torch.zeros_like(t_y))
    return (wl, _shadow_max_t(ld, take_area), V3(le.x * s, le.y * s,
                                                   le.z * s), pdf, new_res)


def _draw(generator, rows: int, n: int, dev,
          cfg: TraceConfig) -> torch.Tensor:
    """[rows, n] uniforms from `generator` (the whole frame's, sliced to
    `cfg.ray_range`, under sharding)."""
    return wf.rand_planes(generator, rows, n, dev, cfg.ray_range,
                          cfg.width * cfg.height)


def trace_wavefront(materials: T.Materials, cam: dict, geoms: T.Geoms,
                    textures: T.Textures, cfg: TraceConfig,
                    generator: Optional[torch.Generator] = None,
                    iteration: Optional[int] = None,
                    cam_u: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None,
                    packed_meshes: tuple = (),
                    meshes: Optional[T.MeshBundle] = None,
                    light_gen: Optional[torch.Generator] = None,
                    ris_u: Optional[Sequence[torch.Tensor]] = None,
                    reservoir: Optional[dict] = None,
                    first_hit: Optional[wf.HitP] = None,
                    pix_override: Optional[torch.Tensor] = None,
                    samp_index: Optional[torch.Tensor] = None):
    """One iteration's per-pixel radiance as a planar V3 of [N] tensors,
    differentiable in `materials` and `cam` (ops/wavefront detaches the
    discrete decisions); with `reservoir` (ReSTIR), (radiance, the new
    reservoir); under `cfg.adaptive`, (per-path radiance, the paths' pixel
    ids).

    Draws come from the injected `cam_u` [5,N] and `u` [depth,4,N] when
    given; else from the stratified sampler `cfg.strat_impl` when
    `cfg.stratified` and `iteration` is given; else from `torch.rand` on
    `generator`. Mesh geoms traverse `packed_meshes` (Scene.packed_meshes on
    the same device); `cfg.differentiable_mesh` recomputes their hits from
    `meshes`, and `cfg.nmap` reads their uv tangents from it. SDF geoms are
    sphere-traced (`cfg.sdf_kinds`). `textures` are the scene's on the same
    device, fused (`ops.texfetch.fuse`) where the scene has both an atlas
    and an env map.

    Under `cfg.nee` each bounce draws a light sample: 3 planes (area
    lights), 4 (the env map) or 8 (the mixture) from the lattice (salts
    SALT_NEE_AREA, SALT_NEE_ENV, SALT_NEE_MIXED) when stratified, else from
    `light_gen` (by default `light_generator(generator)`; the global
    stream when both are None). RIS candidates (`cfg.nee_ris` >= 2 or
    ReSTIR) come from `ris_u[depth]` ([cdim*M + 1, N], cdim 3 or 5 in the
    mixed mode, one more row at depth 0 with `reservoir`) when given, else
    from `light_gen`, even when stratified, as the JAX package draws them
    from jax.random. An area sample's shadow ray stops short of the light,
    an env sample's is unbounded. The shadow ray of the last bounce is not
    cast: `shade_planar` drops its term.

    Slice E. Under `cfg.sort_materials` or `cfg.compact` the path state and
    the hit are permuted each bounce after the intersection
    (`ops.compact.material_bucket_ids` -> `bucket_sort_permutation`): the
    live hits grouped by material, then the live misses, then the paths
    that had ended, so the next bounce's traversal walks the wavefront in
    that order. The draws follow the path's
    pixel, not its lane: the stratified ones are keyed on the permuted
    pixel index, the others are drawn in lane order and gathered by it, and
    the radiance goes back into pixel space by `index_add`, so the image
    equals the unsorted one bit for bit. `cfg.russian_roulette` ends paths
    from depth 2 (its draw: the stratified plane of salt SALT_RR, else one
    `generator` plane a bounce). `cfg.clamp` > 0 caps the iteration's
    radiance. `first_hit` (the first-bounce cache, `_first_hit_of`) stands
    in for the depth-0 intersection, whose bounce then shades without a
    light sample; the cache assumes the camera rays of a render without
    AA, depth of field or motion blur.

    Adaptive sampling (`cfg.adaptive`, render/adaptive.py): path i shoots
    at pixel pix_override[i] (the identity when None), and every
    stratified draw of the path is keyed on its surrogate samp_index[i]
    (pixel + occurrence * W*H) instead of its pixel. Adaptive refuses sort
    and compaction, and ReSTIR (the mapping is not lane-derivable)."""
    permute = cfg.sort_materials or cfg.compact
    if cfg.adaptive and permute:
        raise ValueError("adaptive sampling is incompatible with "
                         "sort_materials/compact (the path->pixel mapping "
                         "is no longer lane-derivable)")
    if reservoir is not None:
        if permute or first_hit is not None or cfg.adaptive:
            raise ValueError("restir requires the identity path order (no "
                             "adaptive/sort/compact/first-bounce cache): "
                             "the per-pixel reservoir is indexed by path "
                             "slot")
        if not (cfg.nee and cfg.nee_lights and not cfg.nee_env):
            raise ValueError("restir needs the area-light NEE mode "
                             "(nee_lights set, no env-map NEE)")
    if cfg.nee and permute:
        raise ValueError("nee is incompatible with sort_materials/compact "
                         "(the light sample is drawn lane-aligned before "
                         "the permutation)")
    strat = cfg.stratified and iteration is not None
    o, d, times, pix = wf.generate_rays_planar(
        cam, cfg.width, cfg.height, generator, antialias=cfg.antialias,
        dof=cfg.dof, motion=cfg.motion, stratified=strat,
        iteration=iteration, cam_u=cam_u, strat_impl=cfg.strat_impl,
        pixel_override=pix_override if cfg.adaptive else None,
        strat_index=samp_index if cfg.adaptive else None,
        frame_range=cfg.ray_range)
    pix_out = pix
    if cfg.adaptive and samp_index is not None:
        # the path state carries the surrogate: unique per path, so the
        # pixel-keyed stratified streams of co-located paths never collide
        pix = samp_index.to(device=pix.device, dtype=torch.int64)
    n = o.x.shape[0]
    dev = o.x.device
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    thr = V3(ones, ones, ones)
    rad = V3(zeros, zeros, zeros)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    nee = cfg.nee and (bool(cfg.nee_lights) or cfg.nee_env)
    mixed = bool(cfg.nee_lights) and cfg.nee_env
    ris = nee and (cfg.nee_ris >= 2 or cfg.restir)
    num_m = int(materials.color.shape[0])
    prev_pdf = zeros
    new_res = None
    if nee and light_gen is None and generator is not None:
        light_gen = light_generator(generator)
    remat = (cfg.remat and torch.is_grad_enabled() and not permute
             and not nee and first_hit is None)
    for depth in range(cfg.trace_depth):
        cached = depth == 0 and first_hit is not None
        last = depth >= cfg.trace_depth - 1
        if remat:
            # the bounce's draws first, outside the recomputed function,
            # which draws nothing: so no generator state is saved for the
            # recompute (`preserve_rng_state=False`; reading the default
            # CUDA generator's state is refused under a graph capture)
            if u is not None:
                uniforms = tuple(u[depth])
            elif strat:
                uniforms = wf.stratified_planes(iteration, depth, pix, 4,
                                                wf.SALT_BOUNCE,
                                                impl=cfg.strat_impl)
            else:
                uniforms = tuple(_draw(generator, 4, n, dev, cfg))
            out = torch.utils.checkpoint.checkpoint(
                _bounce, o, d, times, thr, alive, uniforms, last, geoms,
                materials, textures, cfg, packed_meshes, meshes,
                use_reentrant=False, preserve_rng_state=False)
            rad = rad + out.radiance
            thr, alive = out.throughput, out.alive
            o, d = out.origin, out.direction
            continue
        if cached:
            hit = first_hit
        else:
            hit = wf.intersect_planar(
                o, d, times, geoms, cfg.geom_types, packed_meshes,
                cfg.mesh_ids, alive=alive, meshes=meshes,
                differentiable_mesh=cfg.differentiable_mesh,
                sphere_batch=cfg.sphere_batch, tangents=cfg.nmap,
                sdf_kinds=cfg.sdf_kinds)
        if permute:
            ids, buckets = compaction.material_bucket_ids(
                alive, hit.t, hit.mat_id, num_m)
            perm = compaction.bucket_sort_permutation(ids, buckets)
            o, d, thr, pix, alive, times, hit = compaction.apply_permutation(
                (o, d, thr, pix, alive, times, hit), perm)
        if u is not None:
            uniforms = u[depth]
        elif strat:
            uniforms = wf.stratified_planes(iteration, depth, pix, 4,
                                            wf.SALT_BOUNCE,
                                            impl=cfg.strat_impl)
        else:
            uniforms = tuple(_draw(generator, 4, n, dev, cfg))
        if permute and not strat:
            uniforms = tuple(c[pix] for c in uniforms)
        nee_tuple = None
        if nee and not cached:
            res = reservoir if depth == 0 else None
            if ris:
                cdim = 5 if mixed else 3
                rows = cdim * max(cfg.nee_ris, 1) + (2 if res is not None
                                                     else 1)
                uf = (ris_u[depth] if ris_u is not None
                      else _draw(light_gen, rows, n, dev, cfg))
                if tuple(uf.shape) != (rows, n):
                    raise ValueError(f"RIS draws at depth {depth} must be "
                                     f"[{rows}, {n}], got "
                                     f"{tuple(uf.shape)}")
                wl, max_t, le, pdf, stored = _ris_sample(
                    cfg, materials, textures, hit, d, alive, uf, res)
                if res is not None:
                    new_res = stored
            else:
                ndim, salt = ((8, wf.SALT_NEE_MIXED) if mixed else
                              (4, wf.SALT_NEE_ENV) if cfg.nee_env else
                              (3, wf.SALT_NEE_AREA))
                us = (wf.stratified_planes(iteration, depth, pix, ndim, salt,
                                           impl=cfg.strat_impl)
                      if strat else tuple(_draw(light_gen, ndim, n, dev,
                                                cfg)))
                if mixed:
                    wl, ldist, le, pdf, take_area, _, _ = _mixed_sample(
                        cfg, materials, textures, hit.point, us[0], us[1:4],
                        us[4:8])
                    max_t = _shadow_max_t(ldist, take_area)
                elif cfg.nee_env:
                    wl, le, pdf = _env_sample(cfg, textures, us)
                    max_t = None
                else:
                    wl, ldist, le, pdf, _, _ = _area_sample(
                        cfg, materials, hit.point, us)
                    max_t = _shadow_max_t(ldist, None)
            if last:
                vis = torch.zeros((n,), dtype=torch.bool, device=dev)
            else:
                with torch.no_grad():  # only the visibility bit is used
                    sh = wf.intersect_planar(
                        hit.point, wl, times, geoms, cfg.geom_types,
                        packed_meshes, cfg.mesh_ids, alive=alive,
                        any_hit=True, max_t=max_t,
                        sphere_batch=cfg.sphere_batch,
                        sdf_kinds=cfg.sdf_kinds)
                vis = sh.t <= 0.0
            nee_tuple = (wl, vis, le, pdf, prev_pdf)
        out = wf.shade_planar(
            hit, d, thr, alive, materials, textures, uniforms,
            last_bounce=last,
            glossy=cfg.glossy, nee=nee_tuple,
            nee_area=cfg.nee_area if nee and cfg.nee_lights else 0.0,
            sky=cfg.sky,
            nee_env_c=cfg.nee_env_c if nee and cfg.nee_env else 0.0,
            nee_q=(cfg.nee_q if mixed else 1.0 if cfg.nee_lights else 0.0),
            bump=cfg.bump, nmap=cfg.nmap, bilinear=cfg.bilinear,
            bilinear_fast=cfg.bilinear_fast, dispersion=cfg.dispersion)
        if permute:
            rad = V3(*(r.index_add(0, pix, c)
                       for r, c in zip(rad, out.radiance)))
        else:
            rad = rad + out.radiance
        thr, alive = out.throughput, out.alive
        if cfg.russian_roulette and depth >= 2:
            thr, alive = _roulette(cfg, thr, alive, iteration, depth, pix,
                                   strat, generator, permute)
        o, d = out.origin, out.direction
        if nee:
            prev_pdf = out.nee_pdf if out.nee_pdf is not None else zeros
    if cfg.clamp > 0:
        # a CPU scalar: the kernel takes its value, nothing is copied
        c = torch.tensor(cfg.clamp, dtype=torch.float32)
        rad = V3(*(torch.minimum(r, c) for r in rad))
    if reservoir is not None:
        return rad, new_res
    if cfg.adaptive:
        return rad, pix_out
    return rad


def _bounce(o: V3, d: V3, times: torch.Tensor, thr: V3,
            alive: torch.Tensor, uniforms: tuple, last: bool,
            geoms: T.Geoms, materials: T.Materials, textures: T.Textures,
            cfg: TraceConfig, packed_meshes: tuple,
            meshes: Optional[T.MeshBundle]) -> wf.ShadeOutP:
    """One plain bounce (intersect, then shade) from its draws: the unit
    that `cfg.remat` recomputes in the backward pass."""
    hit = wf.intersect_planar(
        o, d, times, geoms, cfg.geom_types, packed_meshes, cfg.mesh_ids,
        alive=alive, meshes=meshes,
        differentiable_mesh=cfg.differentiable_mesh,
        sphere_batch=cfg.sphere_batch, tangents=cfg.nmap,
        sdf_kinds=cfg.sdf_kinds)
    return wf.shade_planar(
        hit, d, thr, alive, materials, textures, uniforms, last_bounce=last,
        glossy=cfg.glossy, sky=cfg.sky, bump=cfg.bump, nmap=cfg.nmap,
        bilinear=cfg.bilinear, bilinear_fast=cfg.bilinear_fast,
        dispersion=cfg.dispersion)


def _roulette(cfg: TraceConfig, thr: V3, alive: torch.Tensor, iteration,
              depth: int, pix: torch.Tensor, strat: bool, generator,
              permute: bool):
    """Russian roulette after a bounce at depth >= 2 (the JAX
    integrator.py:397-424): a path survives with q = clip(max(throughput),
    0.05, 0.95) and its throughput is divided by q. The draw is the
    stratified plane of salt SALT_RR, else one `generator` plane gathered
    by pixel under a permutation. Returns (throughput, alive)."""
    if strat:
        (u_rr,) = wf.stratified_planes(iteration, depth, pix, 1, wf.SALT_RR,
                                       impl=cfg.strat_impl)
    else:
        u_rr = _draw(generator, 1, pix.shape[0], pix.device, cfg)[0]
        if permute:
            u_rr = u_rr[pix]
    q = wf._clip(torch.maximum(thr.x, torch.maximum(thr.y, thr.z)), 0.05,
                 0.95)
    survive = u_rr < q
    boost = torch.where(survive & alive, 1.0 / q, torch.ones_like(q))
    return V3(thr.x * boost, thr.y * boost, thr.z * boost), alive & survive


def to_image(rad: V3, cfg: TraceConfig) -> torch.Tensor:
    """Planar radiance -> the [H,W,3] image; path i lands at pixel
    (i % W, i // W) (reference: src/pathtrace.cu:128,140). Under
    `cfg.ray_range` the image is the range's rows alone."""
    return torch.stack([c.reshape(-1, cfg.width) for c in rad], dim=-1)


def render_radiance(materials, cam, geoms, textures, cfg: TraceConfig,
                    generator=None, iteration=None,
                    packed_meshes: tuple = (),
                    meshes: Optional[T.MeshBundle] = None,
                    first_hit: Optional[wf.HitP] = None) -> torch.Tensor:
    """One iteration's radiance image [H,W,3]."""
    return to_image(trace_wavefront(
        materials, cam, geoms, textures, cfg, generator=generator,
        iteration=iteration, packed_meshes=packed_meshes, meshes=meshes,
        first_hit=first_hit), cfg)


def render_samples(scene: T.Scene, num_iterations: int,
                   seed: Optional[int] = None,
                   device: str = "cuda") -> np.ndarray:
    """Render `num_iterations` samples a pixel with a fresh Renderer on
    `device` and return the raw accumulation image [H,W,3] (not divided by
    the sample count), as a host array (the JAX `render_samples`)."""
    return Renderer(scene, device=device).render(
        num_iterations, seed=seed).cpu().numpy()


def _first_hit_of(cam: dict, geoms: T.Geoms, cfg: TraceConfig,
                  packed_meshes: tuple = (),
                  meshes: Optional[T.MeshBundle] = None) -> wf.HitP:
    """The depth-0 hits of the camera rays without AA, depth of field or
    motion blur, which are the same every iteration (the first-bounce
    cache; reference src/pathtrace.cu:150,240): one intersection, one K2
    launch a mesh on the card."""
    o, d, times, _ = wf.generate_rays_planar(
        cam, cfg.width, cfg.height, antialias=False, dof=False,
        motion=False, frame_range=cfg.ray_range)
    return wf.intersect_planar(o, d, times, geoms, cfg.geom_types,
                               packed_meshes, cfg.mesh_ids, meshes=meshes,
                               sphere_batch=cfg.sphere_batch,
                               tangents=cfg.nmap, sdf_kinds=cfg.sdf_kinds)


def render_chunk(renderer: "Renderer", n: int) -> None:
    """`n` iterations of a chunkable Renderer (`Renderer.chunkable`), the
    counterpart of the JAX `render_chunk` (which scans a chunk of
    iterations in one device program; `_restir_chunk` and the adaptive
    chunk are the same here, as the reservoir, the adaptive sums and the
    plan are buffers the iteration updates in place): each iteration is a
    replay of one captured CUDA graph of `Renderer._iterate`. Before a
    replay the host does only what changes between iterations
    (`_prepare`: the replan at an adaptive epoch boundary, so no replay
    crosses a replan, and the iteration index; `_draws`: the persistent
    generators reseeded). The result is bit for bit that of `n` step()
    calls.

    The first iteration a Renderer takes runs eagerly (`step()`, which
    builds every lazy table, launch plan and kernel library); the first
    call after it captures the next iteration and replays it, whatever
    its n: no iteration is spent on a warm-up. One iteration is captured,
    not a chunk: the generators' seeds are host hashes of (seed,
    iteration), so a graph of several iterations could not reseed between
    them. A capture or replay that fails raises; nothing falls back to the
    loop of steps."""
    r = renderer
    if r._graph is None and n > 0:
        if not r._warm:
            r.step()
            n -= 1
        if n > 0:
            r._capture()
    for _ in range(n):
        r._prepare()
        with span("render.draws"):
            r._draws()
        r._graph.replay()
        r.iteration += 1


def same_state(a: "Renderer", b: "Renderer") -> bool:
    """Whether two Renderers took as many iterations and hold the same
    `state()` bit for bit."""
    sa, sb = a.state(), b.state()
    return (a.iteration == b.iteration and set(sa) == set(sb)
            and all(torch.equal(sa[k], sb[k]) for k in sa))


def _megakernel_lacks(cfg: TraceConfig, settings: T.RenderSettings) -> bool:
    """Whether a requested knob has no counterpart in K1 (nor in the JAX
    megakernel): sort, compaction, Russian roulette, the Sobol sampler,
    the clamp, the first-bounce cache or adaptive sampling, each of which
    sends a render to the wavefront route. The display curves (gamma, ACES)
    act on the saved PNG alone and stay out."""
    return (cfg.sort_materials or cfg.compact or cfg.russian_roulette
            or cfg.strat_impl == "sobol" or cfg.clamp > 0
            or settings.first_bounce_cache or cfg.adaptive)


def to_device(tables, device: torch.device):
    """A dataclass or NamedTuple of tensors, moved to `device`."""
    if dataclasses.is_dataclass(tables):
        return dataclasses.replace(tables, **{
            f.name: getattr(tables, f.name).to(device)
            for f in dataclasses.fields(tables)
            if isinstance(getattr(tables, f.name), torch.Tensor)})
    return type(tables)(*(t.to(device).contiguous() for t in tables))


def announce_drops(drops: Sequence[str]) -> None:
    """One stderr line naming every requested feature that was dropped, with
    its reason (the JAX `announce_drops`), so that a render never narrows
    its flags silently."""
    if drops:
        print("features dropped: " + "; ".join(drops), file=sys.stderr)


def _flux_split(scene: T.Scene, faces: tuple, c: float) -> float:
    """The mixed mode's probability of sampling the area union: its share
    of the emitted power (pi * sum of area * lum(Le) against the env's 1 /
    C), clipped to [0.1, 0.9] so that neither strategy starves (the JAX
    `_wire_nee`)."""
    lum_w = np.array(nee_mod._LUM)
    col = scene.materials.color.detach().cpu().numpy()
    emit = scene.materials.emittance.detach().cpu().numpy()

    def face_area(f):  # the face record layout of ops/nee.py (FACE_LEN)
        if f[1] >= 0.5:  # a sphere: its radius at [15]
            return 4.0 * np.pi * f[15] * f[15]
        return float(np.linalg.norm(np.cross(np.array(f[5:8]),
                                             np.array(f[8:11]))))

    flux_a = float(sum(face_area(f) * float(col[int(f[14])] @ lum_w)
                       * float(emit[int(f[14])]) for f in faces)) * float(
        np.pi)
    flux_e = 1.0 / c
    return float(np.clip(flux_a / max(flux_a + flux_e, 1e-30), 0.1, 0.9))


def _wire_nee(scene: T.Scene, cfg: TraceConfig,
              drops: Optional[list] = None) -> TraceConfig:
    """Resolve a NEE request as the JAX `_wire_nee` does: area-light NEE
    when the scene has eligible emitters, env-map NEE when it has an
    enabled HDR env map and no procedural sky (the sky has no sampling
    table), and the mixed mode (`_flux_split`) when both apply. The env
    map's alias table goes into scene.textures. Otherwise, or under sort or
    compaction (the light sample is drawn lane-aligned), record the drop
    and stay plain."""
    drops = drops if drops is not None else []
    if cfg.sort_materials or cfg.compact:
        drops.append("nee (incompatible with sort/compact)")
        return cfg
    faces, area = nee_mod.build_light_table(scene)
    tx = scene.textures
    env_table = None
    if tx.has_env and not cfg.sky and float(tx.env_enabled) > 0:
        env_table = nee_mod.build_env_alias(tx.env.cpu().numpy())
    if env_table is not None:
        alias, prob, c = env_table
        scene.textures = dataclasses.replace(
            tx, env_alias=torch.from_numpy(alias),
            env_prob=torch.from_numpy(prob))
        if faces:
            return dataclasses.replace(
                cfg, nee=True, nee_lights=faces, nee_area=area,
                nee_env=True, nee_env_c=c,
                nee_q=_flux_split(scene, faces, c))
        return dataclasses.replace(cfg, nee=True, nee_env=True, nee_env_c=c,
                                   nee_q=0.0)
    if faces:
        return dataclasses.replace(cfg, nee=True, nee_lights=faces,
                                   nee_area=area)
    drops.append("nee (no eligible area lights and no importance-"
                 "sampleable env map)")
    return cfg


class Renderer:
    """Progressive renderer (reference: pathtraceInit/pathtrace,
    src/pathtrace.h:6-8). Owns the [H,W,3] float32 accumulator on `device`
    and the iteration counter. The scene and the settings decide the route
    (module docstring): `route` is "megakernel" (one
    `ops.megakernel.iteration` per step) or "wavefront" (`trace_wavefront`
    on `device`, its draws from torch.Generators seeded from the seed and
    the iteration, or from the stratified lattice). The scene tables are
    moved or packed once, here: a changed scene needs a new Renderer.

    Direct lighting follows the JAX Renderer: `settings.nee` (or RIS or
    ReSTIR) wires the area-light, env-map or mixed mode (`_wire_nee`);
    `settings.restir` M >= 1 turns on ReSTIR with nee_ris = max(M,
    nee_ris), and the Renderer carries the per-pixel reservoir across steps
    (`reset` clears it). A scene without eligible lights renders plain, and
    ReSTIR without the area-light mode is dropped; every drop is named on
    one stderr line (`announce_drops`, kept in `drops`). A NEE render
    always takes the wavefront route. The scene's textures go to the device
    once, with their fused atlas+env tables (`ops.texfetch.fuse`).

    Slice E: sort, compaction, Russian roulette, the Sobol sampler, the
    clamp and the first-bounce cache send a render to the wavefront route
    (`_megakernel_lacks`). Under sort or compaction NEE is dropped, and
    ReSTIR raises ValueError (the JAX Renderer's rules). With
    `settings.first_bounce_cache` and no AA, depth of field or motion blur
    the depth-0 hits are computed once (`_cached_first_hit`) and every
    step reuses them; otherwise the cache is None and steps trace as
    usual.

    Slice F, the render services. `settings.adaptive` takes the wavefront
    route (render/adaptive.py): the first `adaptive_epoch` iterations trace
    the identity mapping (bit for bit the uniform wavefront render), then
    every `adaptive_epoch` iterations the host replans the mapping from
    `adaptive.error_image` (Neyman-damped by `cost_proxy_image` on mesh
    scenes). It keeps `accum2` (sum of luminance^2) and the per-pixel
    `count` on the device; `image()` and `save()` divide each pixel by its
    own count. Adaptive refuses sort, compaction and ReSTIR (ValueError),
    and the first-bounce cache is off under it. `checkpoint_extras` /
    `restore_extras` carry the state beyond (accum, iteration) across a
    checkpoint (render/checkpoint.py): the adaptive sums, plan and replan
    schedule, or the ReSTIR reservoir. `denoised_accum` and
    `save(denoise=True)` filter the mean image with the à-trous denoiser
    (render/denoise.py) over the G-buffer of `denoise_gbuf.gbuffer`.

    `device` is "cuda" or "cpu" and is never chosen for the caller: "cuda"
    without a card raises. `route="wavefront"` sends a scene K1 would take
    down the wavefront route (the sharded renderer's route, and the
    single-process render it is held against); `drops` are drops the
    caller already made, announced on the same line.

    A new camera (the preview's orbit, app/orbit.py): change
    `scene.camera`, then call `reset()`, which repacks what caches the
    camera as well as zeroing the accumulation.

    Slice I: `step()` is one eager iteration; on the card `step_many` (and
    so `render`) replays one captured iteration of the wavefront route
    (`render_chunk`), whose iteration index (`_it_t`) and generators
    (`_gens`, reseeded each iteration) are persistent device state and
    whose buffers `reset`, `restore_extras` and the replans overwrite in
    place. `chunkable()` is the rule; `graph` the capture."""

    def __init__(self, scene: T.Scene,
                 settings: Optional[T.RenderSettings] = None,
                 device: str = "cuda", route: Optional[str] = None,
                 drops: Sequence[str] = ()):
        if route not in (None, "wavefront"):
            raise ValueError(f"route must be None or 'wavefront', got "
                             f"{route!r}")
        self.device = resolve_device(device)
        self.scene = scene
        self.settings = st = settings or scene.settings
        self.cfg = build_trace_config(scene, st)
        self.seed = st.seed
        self.drops = list(drops)
        if self.cfg.adaptive and (self.cfg.sort_materials
                                  or self.cfg.compact):
            raise ValueError("adaptive sampling is incompatible with "
                             "--sort/--compact (the path->pixel mapping is "
                             "no longer lane-derivable)")
        if st.restir >= 1:
            if (self.cfg.sort_materials or self.cfg.compact
                    or self.cfg.adaptive):
                raise ValueError("--restir is incompatible with --adaptive/"
                                 "--sort/--compact (identity path order "
                                 "required)")
            self.cfg = dataclasses.replace(
                self.cfg, restir=True, nee_ris=max(st.restir,
                                                   self.cfg.nee_ris),
                restir_cap=float(st.restir_cap))
        if st.nee or st.restir >= 1:
            self.cfg = _wire_nee(scene, self.cfg, self.drops)
        if self.cfg.restir and not (self.cfg.nee and self.cfg.nee_lights
                                    and not self.cfg.nee_env):
            self.drops.append("restir (needs the area-light NEE mode: "
                              "emissive area lights present, no env-map "
                              "NEE)")
            self.cfg = dataclasses.replace(self.cfg, restir=False)
        announce_drops(self.drops)
        self.tables = self.packed_meshes = self.meshes = None
        self._plan = None
        self._gens = {}
        self._graph = None
        self._warm = False  # an eager wavefront iteration has run
        # the iteration index a wavefront iteration reads (`_prepare`)
        self._it_t = torch.zeros((), dtype=torch.int64, device=self.device)
        if (route is None and mk.supports(scene) and not self.cfg.nee
                and not _megakernel_lacks(self.cfg, st)):
            self.route = "megakernel"
            self.sampler = "stratified" if self.cfg.stratified else "philox"
        else:
            self.route = "wavefront"
            self._load_tables()
        self.reset()

    def _load_tables(self) -> None:
        """The wavefront stages' tables on the device (the wavefront route's;
        the megakernel route's G-buffer loads them at its first use); the
        textures' upload and fusion under the span `render.textures`."""
        if self.tables is not None:
            return
        dev, scene = self.device, self.scene
        with span("render.textures"):
            tex = texfetch.fuse(to_device(scene.textures, dev))
        self.tables = (to_device(scene.materials, dev),
                       scene.camera.flat(dev),
                       to_device(scene.geoms, dev), tex)
        self.packed_meshes = tuple(to_device(p, dev)
                                   for p in scene.packed_meshes)
        # the normal map's mesh tangents read the triangle bundle
        self.meshes = (to_device(scene.meshes, dev) if self.cfg.nmap
                       else None)

    def reset(self) -> None:
        """Zero the accumulator (pathtraceInit, src/pathtrace.cu:85) and,
        under ReSTIR, empty the reservoir. The camera is read anew from
        `scene.camera` (any camera change resets accumulation, as in the
        reference, src/main.cpp:102-120): K1's scene table, the wavefront's
        camera tensors, the first-bounce cache and the cost proxy are
        rebuilt from it.

        The buffers an iteration reads and writes (the camera tensors, the
        accumulator, the reservoir, the adaptive sums, counts and plan) are
        overwritten in place, so a captured iteration (`render_chunk`)
        keeps reading them."""
        if self.route == "megakernel":
            self.table = mk.pack_scene(self.scene, self.device)
        if self.tables is not None:
            mats, cam, geoms, tex = self.tables
            new = self.scene.camera.flat(self.device)
            self.tables = (mats, {k: self._into(cam.get(k), v)
                                  for k, v in new.items()}, geoms, tex)
        self._cost = None
        h, w = self._accum_rows()
        dev, f32 = self.device, torch.float32
        self.accum = self._into(getattr(self, "accum", None),
                                torch.zeros((h, w, 3), dtype=f32, device=dev))
        self.iteration = 0
        if self.cfg.restir:
            old = getattr(self, "reservoir", None) or {}
            self.reservoir = {k: self._into(old.get(k), v) for k, v in
                              init_reservoir(w * h, dev).items()}
        else:
            self.reservoir = None
        self._first_hit = None
        if self.cfg.adaptive:
            self.accum2 = self._into(getattr(self, "accum2", None),
                                     torch.zeros((h, w), dtype=f32,
                                                 device=dev))
            self._count = self._into(getattr(self, "_count", None),
                                     torch.zeros((h, w), dtype=f32,
                                                 device=dev))
            self._identity_plan()
            self._next_replan = self.adaptive_epoch
        else:
            self.accum2 = self._count = self._plan = None

    def _accum_rows(self) -> Tuple[int, int]:
        """(rows, width) of this process's accumulator: the whole frame."""
        w, h = self.scene.camera.resolution
        return h, w

    def _identity_plan(self) -> None:
        """The adaptive warm-up mapping and the cost proxy."""
        from . import adaptive as A
        w, h = self.scene.camera.resolution
        self._set_plan(A.identity_plan(w, h))
        self._cost = A.cost_proxy_image(self.scene, w, h)

    def _into(self, old: Optional[torch.Tensor],
              new: torch.Tensor) -> torch.Tensor:
        """`new`'s values in the Renderer's buffer `old`, in place (a
        captured iteration keeps reading `old`), or a copy of `new` on the
        device where there is no buffer yet. A value of another shape or
        dtype raises: another frame size needs a new Renderer."""
        if old is None:
            return new.to(device=self.device, copy=True)
        if old.shape != new.shape or old.dtype != new.dtype:
            raise ValueError(f"a {tuple(new.shape)} {new.dtype} value for "
                             f"a {tuple(old.shape)} {old.dtype} buffer: "
                             "another frame size needs a new Renderer")
        return old.copy_(new)

    def _fixed_camera_rays(self) -> bool:
        """Whether the camera rays are the same every iteration (no AA,
        aperture, shutter or adaptive mapping): the cache's condition."""
        cam = self.scene.camera
        return not (self.cfg.antialias or cam.aperture > 0
                    or cam.shutter > 0 or self.cfg.adaptive)

    def _cache_active(self) -> bool:
        """Whether steps reuse the first-bounce cache: the setting on, no
        ReSTIR reservoir (it needs the identity path order) and fixed
        camera rays."""
        return bool(self.settings.first_bounce_cache
                    and self.reservoir is None and self._fixed_camera_rays())

    def _cached_first_hit(self) -> Optional[wf.HitP]:
        """The first-bounce cache (the JAX `_cached_first_hit`): the depth-0
        hits, built at the first step that asks, or None where the camera
        rays change between iterations (AA, an aperture, a shutter)."""
        if not self._fixed_camera_rays():
            return None
        if self._first_hit is None:
            _, cam_t, geoms, _ = self.tables
            self._first_hit = _first_hit_of(cam_t, geoms, self.cfg,
                                            self.packed_meshes, self.meshes)
        return self._first_hit

    def _seed_of(self, salt: int) -> int:
        """The seed of the current iteration's generator of `salt`."""
        return mk.seed32(self.seed ^ salt, self.iteration)

    def _generator(self, salt: int = 0) -> torch.Generator:
        """The Renderer's persistent generator of `salt` on its device,
        reseeded for the current iteration, so it draws what a fresh
        generator of that seed draws. A captured iteration, with which it
        is registered, reads its seed and offset at each replay."""
        gen = self._gens.get(salt)
        if gen is None:
            gen = self._gens[salt] = torch.Generator(device=self.device)
        gen.manual_seed(self._seed_of(salt))
        return gen

    def _draws(self) -> tuple:
        """The current iteration's generators, reseeded: (camera and BSDF
        draws, None when stratified; light draws, None without NEE)."""
        return (None if self.cfg.stratified else self._generator(),
                self._generator(LIGHT_SALT) if self.cfg.nee else None)

    def _prepare(self) -> None:
        """The host's part of a wavefront iteration: the replan at an
        adaptive epoch boundary, then the iteration index into the device
        tensor `_it_t` that the iteration reads (the span
        `render.prepare`)."""
        with span("render.prepare"):
            if self.cfg.adaptive and self.iteration >= self._next_replan:
                self._replan()
            self._it_t.fill_(self.iteration)

    def _iterate(self, generator: Optional[torch.Generator],
                 light_gen: Optional[torch.Generator]) -> None:
        """One wavefront iteration at the index in `_it_t`, drawn from the
        given generators, added into the accumulator (and the reservoir,
        or the adaptive sums and counts): the body that `step()` runs
        eagerly and `render_chunk` captures and replays. It reads and
        writes the Renderer's buffers in place and makes no host round
        trip."""
        if self.cfg.adaptive:
            self._iterate_adaptive(generator, light_gen)
            return
        out = trace_wavefront(
            *self.tables, self.cfg, generator=generator,
            iteration=self._it_t, packed_meshes=self.packed_meshes,
            meshes=self.meshes, light_gen=light_gen,
            reservoir=self.reservoir,
            first_hit=self._cached_first_hit() if self._cache_active()
            else None)
        if self.reservoir is not None:
            out, stored = out
            for k, v in stored.items():
                self.reservoir[k].copy_(v)
        self.accum.add_(to_image(out, self.cfg))

    def step(self) -> None:
        """One progressive iteration (one sample per pixel), eagerly; on the
        megakernel route one K1 launch, its host side under the span
        `render.k1`."""
        if self.route == "megakernel":
            with span("render.k1"):
                mk.iteration(self.accum, self.table, self.cfg,
                             self.iteration, self.seed, self.sampler)
        else:
            self._prepare()
            self._iterate(*self._draws())
            self._warm = True
        self.iteration += 1

    def chunkable(self) -> bool:
        """Whether `step_many` on the card replays a captured iteration
        (`render_chunk`): the wavefront route, unless the first-bounce
        cache is active (the JAX `chunkable` rule). The megakernel route
        stays a loop of steps: K1 is one launch an iteration, and its step
        already takes the kernel's time (PERF.md section 5)."""
        return self.route == "wavefront" and not self._cache_active()

    def step_many(self, n: int) -> None:
        """`n` iterations: on the card, replays of one captured iteration
        where `chunkable` (`render_chunk`), bit for bit `n` step() calls;
        else those calls (CPU tensors never capture)."""
        if self.device.type == "cuda" and self.chunkable():
            render_chunk(self, n)
        else:
            for _ in range(n):
                self.step()

    def _capture(self) -> None:
        """Capture `_iterate` with the persistent generators registered, as
        the graph "render"."""
        gens = self._draws()
        self._graph = capture_graph(
            lambda: self._iterate(*gens), self.device,
            generators=[g for g in gens if g is not None],
            counters=launch_counts, name="render")

    @property
    def graph(self) -> Optional[CapturedGraph]:
        """The captured iteration (its launches, capture and instantiate
        seconds, pool bytes and replays), or None."""
        return self._graph

    def state(self) -> dict:
        """What the iterations accumulated, by name: the accumulator, the
        ReSTIR reservoir's planes (`res_<plane>`), the adaptive sums and
        counts. A chunk leaves it bit for bit as the eager steps do
        (`same_state`)."""
        out = {"accum": self.accum}
        out.update({"res_" + k: v for k, v in (self.reservoir or {}).items()})
        if self.cfg.adaptive:
            out.update(accum2=self.accum2, count=self._count)
        return out

    @property
    def adaptive_epoch(self) -> int:
        return max(1, int(self.settings.adaptive_epoch))

    def _set_plan(self, plan) -> None:
        """Take a plan (pix, surrogates, count image) into the fixed-size
        buffers the iteration reads: W*H paths and an [H,W] count image,
        whatever the plan, so a captured iteration keeps reading them."""
        pix, surr, count_img = plan
        old = self._plan or (None, None, None)
        self._plan = (
            self._into(old[0], torch.as_tensor(pix, dtype=torch.int64)),
            self._into(old[1], torch.as_tensor(surr, dtype=torch.int64)),
            self._into(old[2], torch.as_tensor(count_img,
                                               dtype=torch.float32)))

    def _replan(self) -> None:
        """The next epoch's mapping from the device's error image (one [H,W]
        plane to the host), Neyman-damped by the cost proxy."""
        from . import adaptive as A
        err = A.error_image(self.accum, self.accum2, self._count)
        self._set_plan(A.plan_from_err(err.cpu().numpy(), cost=self._cost))
        self._next_replan = self.iteration + self.adaptive_epoch

    def _iterate_adaptive(self, generator, light_gen) -> None:
        """One adaptive iteration under the current plan: W*H paths
        (`adaptive.render_radiance_adaptive`), their radiance and
        luminance^2 images and the plan's counts added in place."""
        from . import adaptive as A
        pix, surr, count_img = self._plan
        img, lum2 = A.render_radiance_adaptive(
            *self.tables, self.cfg, generator=generator,
            iteration=self._it_t, packed_meshes=self.packed_meshes,
            meshes=self.meshes, light_gen=light_gen, pix_override=pix,
            samp_index=surr)
        self.accum.add_(img)
        self.accum2.add_(lum2)
        self._count.add_(count_img)

    @property
    def count(self) -> np.ndarray:
        """Per-pixel sample counts [H,W]: tracked on the device under
        adaptive sampling, `iteration` everywhere otherwise."""
        if not self.cfg.adaptive:
            w, h = self.scene.camera.resolution
            return np.full((h, w), float(self.iteration))
        return self._count.cpu().numpy()

    def checkpoint_extras(self) -> dict:
        """Renderer state beyond (accum, iteration) for
        render/checkpoint.py, so that a resumed render continues the
        uninterrupted one's stream: the ReSTIR reservoir's planes
        (`res_<key>`), or adaptive sampling's sums, counts, current plan and
        replan schedule. Empty otherwise."""
        if self.reservoir is not None:
            return {"res_" + k: v.cpu().numpy()
                    for k, v in self.reservoir.items()}
        if not self.cfg.adaptive:
            return {}
        pix, surr, cimg = self._plan
        return dict(accum2=self.accum2.cpu().numpy(), count=self.count,
                    plan_pix=pix.cpu().numpy(), plan_surr=surr.cpu().numpy(),
                    plan_cimg=cimg.cpu().numpy(),
                    next_replan=np.int64(self._next_replan))

    def restore_extras(self, extras: dict) -> None:
        """The inverse of `checkpoint_extras`, into the Renderer's buffers
        in place; raises ValueError when the checkpoint lacks the state
        this renderer's mode needs."""
        f32 = torch.float32
        if self.reservoir is not None:
            missing = [k for k in self.reservoir if "res_" + k not in extras]
            if missing:
                raise ValueError("checkpoint has no restir reservoir state; "
                                 "resume without --restir or re-render")
            self.reservoir = {
                k: self._into(v, torch.as_tensor(extras["res_" + k],
                                                 dtype=f32))
                for k, v in self.reservoir.items()}
            return
        if not self.cfg.adaptive:
            return
        if "accum2" not in extras:
            raise ValueError("checkpoint has no adaptive state; resume "
                             "without --adaptive or re-render")
        self.accum2 = self._into(self.accum2, torch.as_tensor(
            extras["accum2"], dtype=f32))
        self._count = self._into(self._count, torch.as_tensor(
            extras["count"], dtype=f32))
        self._set_plan((extras["plan_pix"], extras["plan_surr"],
                        extras["plan_cimg"]))
        self._next_replan = int(extras["next_replan"])

    def render(self, num_iterations: int, seed: Optional[int] = None):
        """Add `num_iterations` samples per pixel and wait for them."""
        if seed is not None:
            self.seed = seed
        self.step_many(num_iterations)
        synchronize(self.device)
        return self.accum

    def _mean(self) -> torch.Tensor:
        """The [H,W,3] mean image on the device (each pixel over its own
        count under adaptive sampling)."""
        if self.cfg.adaptive:
            return self.accum / torch.clamp(self._count, min=1.0)[..., None]
        return self.accum / max(self.iteration, 1)

    def image(self) -> np.ndarray:
        """Mean over samples, x-mirrored like saveImage (src/main.cpp:83-89);
        under adaptive sampling each pixel over its own count. The spans
        `readback.copy` (the device-to-host copy) and `readback.host` (the
        mirror and division on the host). The device runs no kernel here
        beyond adaptive sampling's division, only the copy. On a card both
        host buffers are page-locked blocks from torch's host cache, so the
        copy engine fills the first without a staging copy and no call
        faults in 50 MB of fresh pages at 2048²; the mirror moves whole
        pixels (one item of 3 floats), not single floats. Bit for bit the
        mirror of the accumulator's host copy divided by the count."""
        pin = self.device.type == "cuda"
        with span("readback.copy"):
            mean = self._mean() if self.cfg.adaptive else self.accum
            host = torch.empty(mean.shape, dtype=mean.dtype, pin_memory=pin)
            host.copy_(mean)
        with span("readback.host"):
            out = torch.empty(host.shape, dtype=host.dtype, pin_memory=pin)
            src, img = host.numpy(), out.numpy()
            h, w = src.shape[:2]
            pixel = np.dtype((np.void, src.shape[2] * src.itemsize))
            img.view(pixel).reshape(h, w)[...] = \
                src.view(pixel).reshape(h, w)[:, ::-1]
            if not self.cfg.adaptive:
                np.divide(img, max(self.iteration, 1), out=img)
            return img

    def denoised_accum(self) -> torch.Tensor:
        """The accumulator filtered by the à-trous denoiser
        (render/denoise.py), on the device, at the accumulator's scale and
        orientation: the mean image denoised over the G-buffer with albedo
        demodulation, times the iteration count. The mirror relay starts
        at 64 iterations: below that the relayed edge-stops block smoothing
        that still pays (the JAX package's measured crossover)."""
        from . import denoise as dn
        self._load_tables()
        normal, pos, alb = dn.gbuffer(self.scene, self.cfg,
                                      self.packed_meshes, albedo=True,
                                      relay=self.iteration >= 64,
                                      tables=self.tables)
        out = dn.atrous_denoise(self._mean(), normal, pos, albedo=alb)
        return out * max(self.iteration, 1)

    def save(self, path_base: Optional[str] = None, hdr: bool = False,
             denoise: bool = False, gamma: float = 0.0,
             aces: bool = False) -> str:
        """Write the mean image: `<base>.png` (with the optional display
        curves: ACES, then 1/gamma) or, with `hdr`, linear `<base>.hdr`;
        with `denoise`, the denoised image (`denoised_accum`)."""
        base = path_base or self.settings.image_name
        accum = self.denoised_accum() if denoise else self.accum
        if self.cfg.adaptive and not denoise:
            # save_render divides by the iteration count: pre-scale so that
            # each pixel lands on its own mean
            accum = self._mean() * max(self.iteration, 1)
        return img_io.save_render(base, accum.cpu().numpy(), self.iteration,
                                  hdr=hdr, gamma=gamma, aces=aces)
