"""Progressive path-tracing integrator, primitive slice.

Counterpart of project3_cuda_path_tracer_tpu/render/integrator.py: one
iteration (one sample per pixel) traces the whole W*H wavefront through
`trace_wavefront` (ray generation, then depth x (intersect -> shade)) and
adds its radiance into the [H,W,3] accumulator (finalGather, reference
src/pathtrace.cu:269-278).

`Renderer` runs every iteration through `ops.megakernel.iteration`: on the
card that is the CUDA megakernel, on the CPU its plain version, which is
`trace_wavefront` below. Only the plain estimator is ported: no sort or
compaction, NEE, Russian roulette, adaptive sampling, ReSTIR or
first-bounce cache (ROADMAP.md Queue 1).
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
        stratified=settings.stratified)


def trace_wavefront(materials: T.Materials, cam: dict, geoms: T.Geoms,
                    textures: T.Textures, cfg: TraceConfig,
                    generator: Optional[torch.Generator] = None,
                    iteration: Optional[int] = None,
                    cam_u: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None) -> V3:
    """One iteration's per-pixel radiance as a planar V3 of [N] tensors.

    Draws come from the injected `cam_u` [5,N] and `u` [depth,4,N] when
    given; else from the stratified lattice when `cfg.stratified` and
    `iteration` is given; else from `torch.rand` on `generator`."""
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
        hit = wf.intersect_planar(o, d, times, geoms, cfg.geom_types)
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
                    generator=None, iteration=None) -> torch.Tensor:
    """One iteration's radiance image [H,W,3]; path i lands at pixel
    (i % W, i // W) (reference: src/pathtrace.cu:128,140)."""
    rad = trace_wavefront(materials, cam, geoms, textures, cfg,
                          generator=generator, iteration=iteration)
    return torch.stack([c.reshape(cfg.height, cfg.width) for c in rad],
                       dim=-1)


class Renderer:
    """Progressive renderer (reference: pathtraceInit/pathtrace,
    src/pathtrace.h:6-8). Owns the [H,W,3] float32 accumulator on `device`
    and the iteration counter; every `step()` is one launch of
    `ops.megakernel.iteration`. The scene table is packed once, here: a
    changed scene needs a new Renderer.

    `device` is "cuda" or "cpu" and is never chosen for the caller: "cuda"
    without a card raises. Scenes outside `ops.megakernel.supports` raise
    NotImplementedError."""

    def __init__(self, scene: T.Scene,
                 settings: Optional[T.RenderSettings] = None,
                 device: str = "cuda"):
        self.device = resolve_device(device)
        mk.require_supported(scene)
        self.scene = scene
        self.settings = settings or scene.settings
        self.cfg = build_trace_config(scene, self.settings)
        self.table = mk.pack_scene(scene, self.device)
        self.sampler = "stratified" if self.cfg.stratified else "philox"
        self.seed = self.settings.seed
        self.reset()

    def reset(self) -> None:
        """Zero the accumulator (pathtraceInit, src/pathtrace.cu:85)."""
        w, h = self.scene.camera.resolution
        self.accum = torch.zeros((h, w, 3), dtype=torch.float32,
                                 device=self.device)
        self.iteration = 0

    def step(self) -> None:
        """One progressive iteration (one sample per pixel)."""
        mk.iteration(self.accum, self.table, self.cfg, self.iteration,
                     self.seed, self.sampler)
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
