"""Progressive path-tracing integrator: primitive and mesh scenes.

Counterpart of project3_cuda_path_tracer_tpu/render/integrator.py: one
iteration (one sample per pixel) traces the whole W*H wavefront through
`trace_wavefront` (ray generation, then depth x (intersect -> shade)) and
adds its radiance into the [H,W,3] accumulator (finalGather, reference
src/pathtrace.cu:269-278).

`Renderer` picks one of two routes from the scene:
  megakernel  every scene `ops.megakernel.supports` accepts (cubes and
              spheres, no glossy lobe): one `ops.megakernel.iteration` per
              iteration, the CUDA megakernel on the card;
  wavefront   the other scenes the torch stages cover (meshes, the glossy
              lobe): `trace_wavefront` on the Renderer's device, whose mesh
              hits go through the BVH traversal kernels (ops/bvh8.py,
              ops/pallas_bvh.py).
Only the plain estimator is ported: no sort or compaction, NEE, Russian
roulette, adaptive sampling, ReSTIR or first-bounce cache (ROADMAP.md
Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import megakernel as mk
from ..ops import wavefront as wf
from ..ops.vec import V3
from ..scene import types as T
from ..utils import image as img_io
from ..utils.device import resolve_device, synchronize


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
    # evaluate the procedural sky (not ported: must be False)
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


def build_trace_config(scene: T.Scene, settings=None) -> TraceConfig:
    """RenderSettings -> TraceConfig, as the JAX `build_trace_config`
    (integrator.py:992-1060) resolves the fields above."""
    settings = settings or scene.settings
    w, h = scene.camera.resolution
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
        mesh_ids=tuple(int(m) for m in scene.geoms.mesh_id.tolist()))


def trace_wavefront(materials: T.Materials, cam: dict, geoms: T.Geoms,
                    textures: T.Textures, cfg: TraceConfig,
                    generator: Optional[torch.Generator] = None,
                    iteration: Optional[int] = None,
                    cam_u: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None,
                    packed_meshes: tuple = (),
                    meshes: Optional[T.MeshBundle] = None) -> V3:
    """One iteration's per-pixel radiance as a planar V3 of [N] tensors,
    differentiable in `materials` and `cam` (ops/wavefront detaches the
    discrete decisions).

    Draws come from the injected `cam_u` [5,N] and `u` [depth,4,N] when
    given; else from the stratified lattice when `cfg.stratified` and
    `iteration` is given; else from `torch.rand` on `generator`. Mesh geoms
    traverse `packed_meshes` (Scene.packed_meshes on the same device);
    `cfg.differentiable_mesh` recomputes their hits from `meshes`."""
    if cfg.sky:
        raise NotImplementedError("the procedural sky is not ported "
                                  "(ROADMAP.md slice D)")
    strat = cfg.stratified and iteration is not None
    o, d, times, pix = wf.generate_rays_planar(
        cam, cfg.width, cfg.height, generator, antialias=cfg.antialias,
        dof=cfg.dof, motion=cfg.motion, stratified=strat,
        iteration=iteration, cam_u=cam_u)
    n = cfg.width * cfg.height
    dev = o.x.device
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    thr = V3(ones, ones, ones)
    rad = V3(zeros, zeros, zeros)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    for depth in range(cfg.trace_depth):
        hit = wf.intersect_planar(o, d, times, geoms, cfg.geom_types,
                                  packed_meshes, cfg.mesh_ids, alive=alive,
                                  meshes=meshes,
                                  differentiable_mesh=cfg.differentiable_mesh)
        if u is not None:
            uniforms = u[depth]
        elif strat:
            uniforms = wf.stratified_planes(iteration, depth, pix, 4,
                                            wf.SALT_BOUNCE)
        else:
            u4 = torch.rand((4 * n,), generator=generator,
                            dtype=torch.float32, device=dev)
            uniforms = tuple(u4[i * n:(i + 1) * n] for i in range(4))
        last = torch.full((n,), depth >= cfg.trace_depth - 1,
                          dtype=torch.bool, device=dev)
        out = wf.shade_planar(hit, d, thr, alive, materials, textures,
                              uniforms, last_bounce=last, glossy=cfg.glossy)
        rad = rad + out.radiance
        o, d, thr, alive = out.origin, out.direction, out.throughput, out.alive
    return rad


def render_radiance(materials, cam, geoms, textures, cfg: TraceConfig,
                    generator=None, iteration=None,
                    packed_meshes: tuple = (),
                    meshes: Optional[T.MeshBundle] = None) -> torch.Tensor:
    """One iteration's radiance image [H,W,3]; path i lands at pixel
    (i % W, i // W) (reference: src/pathtrace.cu:128,140)."""
    rad = trace_wavefront(materials, cam, geoms, textures, cfg,
                          generator=generator, iteration=iteration,
                          packed_meshes=packed_meshes, meshes=meshes)
    return torch.stack([c.reshape(cfg.height, cfg.width) for c in rad],
                       dim=-1)


def _wavefront_unsupported(scene: T.Scene) -> Optional[str]:
    """What in `scene` the torch stages of trace_wavefront do not cover yet,
    with the ROADMAP slice that brings it, or None."""
    tx, mt = scene.textures, scene.materials
    if (scene.geoms.type == T.SDF).any():
        return "SDF geoms (slice E)"
    if tx.atlas.shape[0] > 1 or tx.atlas.shape[1] > 1:
        return "a texture atlas (slice D)"
    if tx.env.shape[0] > 1 or tx.env.shape[1] > 1:
        return "an environment map (slice D)"
    if (tx.bump[:, 0] > 0).any() or (tx.nrm_id >= 0).any():
        return "bump or normal maps (slice D)"
    if float(tx.sky[0]) > 0:
        return "the procedural sky (slice D)"
    if mt.dispersion is not None and (mt.dispersion > 0).any():
        return "spectral dispersion (slice E)"
    return None


def require_wavefront(scene: T.Scene) -> None:
    """Raise NotImplementedError, naming the ROADMAP slice, when `scene`
    has a feature the torch stages of trace_wavefront do not cover yet."""
    why = _wavefront_unsupported(scene)
    if why is not None:
        raise NotImplementedError(
            f"scene not renderable by the torch port yet: it has {why}; "
            "ROADMAP.md Queue 1 lists the slices")


def to_device(tables, device: torch.device):
    """A dataclass or NamedTuple of tensors, moved to `device`."""
    if dataclasses.is_dataclass(tables):
        return dataclasses.replace(tables, **{
            f.name: getattr(tables, f.name).to(device)
            for f in dataclasses.fields(tables)
            if isinstance(getattr(tables, f.name), torch.Tensor)})
    return type(tables)(*(t.to(device).contiguous() for t in tables))


class Renderer:
    """Progressive renderer (reference: pathtraceInit/pathtrace,
    src/pathtrace.h:6-8). Owns the [H,W,3] float32 accumulator on `device`
    and the iteration counter. The scene decides the route (module
    docstring): `route` is "megakernel" (one `ops.megakernel.iteration`
    per step) or "wavefront" (`render_radiance` on `device`, its draws
    from a torch.Generator seeded from the seed and the iteration, or from
    the stratified lattice). The scene tables are moved or packed once,
    here: a changed scene needs a new Renderer.

    `device` is "cuda" or "cpu" and is never chosen for the caller: "cuda"
    without a card raises. Scenes with features the port's stages lack
    raise NotImplementedError naming the ROADMAP slice."""

    def __init__(self, scene: T.Scene,
                 settings: Optional[T.RenderSettings] = None,
                 device: str = "cuda"):
        self.device = resolve_device(device)
        self.scene = scene
        self.settings = settings or scene.settings
        self.cfg = build_trace_config(scene, self.settings)
        self.seed = self.settings.seed
        if mk.supports(scene):
            self.route = "megakernel"
            self.table = mk.pack_scene(scene, self.device)
            self.sampler = "stratified" if self.cfg.stratified else "philox"
        else:
            require_wavefront(scene)
            self.route = "wavefront"
            dev = self.device
            self.tables = (to_device(scene.materials, dev),
                           scene.camera.flat(dev),
                           to_device(scene.geoms, dev),
                           to_device(scene.textures, dev))
            self.packed_meshes = tuple(to_device(p, dev)
                                       for p in scene.packed_meshes)
        self.reset()

    def reset(self) -> None:
        """Zero the accumulator (pathtraceInit, src/pathtrace.cu:85)."""
        w, h = self.scene.camera.resolution
        self.accum = torch.zeros((h, w, 3), dtype=torch.float32,
                                 device=self.device)
        self.iteration = 0

    def step(self) -> None:
        """One progressive iteration (one sample per pixel)."""
        if self.route == "megakernel":
            mk.iteration(self.accum, self.table, self.cfg, self.iteration,
                         self.seed, self.sampler)
        else:
            gen = None
            if not self.cfg.stratified:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(mk.seed32(self.seed, self.iteration))
            self.accum.add_(render_radiance(
                *self.tables, self.cfg, generator=gen,
                iteration=self.iteration, packed_meshes=self.packed_meshes))
        self.iteration += 1
    def step_many(self, n: int) -> None:
        for _ in range(n):
            self.step()

    def render(self, num_iterations: int, seed: Optional[int] = None):
        """Add `num_iterations` samples per pixel and wait for them."""
        if seed is not None:
            self.seed = seed
        self.step_many(num_iterations)
        synchronize(self.device)
        return self.accum

    def image(self) -> np.ndarray:
        """Mean over samples, x-mirrored like saveImage (src/main.cpp:83-89)."""
        return self.accum.cpu().numpy()[:, ::-1, :] / max(self.iteration, 1)

    def save(self, path_base: Optional[str] = None, hdr: bool = False) -> str:
        base = path_base or self.settings.image_name
        return img_io.save_render(base, self.accum.cpu().numpy(),
                                  self.iteration, hdr=hdr)
