"""Render diagnostics: the per-depth live-path histogram and the
compaction ratios (how much work stream compaction could save per bounce,
reference src/pathtrace.cu:313-317).

Counterpart of project3_cuda_path_tracer_tpu/render/diagnostics.py through
the port's stages: one iteration of generate_rays_planar -> depth x
(intersect_planar -> shade_planar) without direct lighting, its draws from
a torch generator seeded with `seed` (the JAX module draws from
jax.random, so the two agree in distribution, not lane for lane).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import texfetch
from ..ops import wavefront as wf
from ..ops.vec import V3
from ..scene import types as T
from ..utils.device import resolve_device
from . import integrator as integ


def live_path_histogram(scene: T.Scene,
                        cfg: Optional[integ.TraceConfig] = None,
                        seed: int = 0, device: str = "cuda") -> np.ndarray:
    """[trace_depth+1] live-path counts before each bounce (index 0 = all
    paths) for one iteration on `device`."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = integ.build_trace_config(scene, scene.settings)
    mats, cam, geoms, tex = (integ.to_device(scene.materials, dev),
                             scene.camera.flat(dev),
                             integ.to_device(scene.geoms, dev),
                             texfetch.fuse(integ.to_device(scene.textures,
                                                           dev)))
    packed = tuple(integ.to_device(p, dev) for p in scene.packed_meshes)
    meshes = integ.to_device(scene.meshes, dev) if cfg.nmap else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    o, d, times, _ = wf.generate_rays_planar(
        cam, cfg.width, cfg.height, gen, antialias=cfg.antialias,
        dof=cfg.dof, motion=cfg.motion)
    n = o.x.shape[0]
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    thr = V3(ones, ones, ones)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    counts = [alive.sum()]
    for depth in range(cfg.trace_depth):
        hit = wf.intersect_planar(o, d, times, geoms, cfg.geom_types, packed,
                                  cfg.mesh_ids, alive=alive, meshes=meshes,
                                  sphere_batch=cfg.sphere_batch,
                                  tangents=cfg.nmap, sdf_kinds=cfg.sdf_kinds)
        u4 = torch.rand((4 * n,), generator=gen, dtype=torch.float32,
                        device=dev)
        out = wf.shade_planar(
            hit, d, thr, alive, mats, tex,
            tuple(u4[i * n:(i + 1) * n] for i in range(4)),
            last_bounce=depth >= cfg.trace_depth - 1,
            glossy=cfg.glossy, sky=cfg.sky, bump=cfg.bump, nmap=cfg.nmap,
            bilinear=cfg.bilinear, bilinear_fast=cfg.bilinear_fast,
            dispersion=cfg.dispersion)
        o, d, thr, alive = out.origin, out.direction, out.throughput, \
            out.alive
        counts.append(alive.sum())
    return torch.stack(counts).cpu().numpy()


def compaction_ratios(scene: T.Scene, seed: int = 0,
                      device: str = "cuda") -> np.ndarray:
    """Fraction of the wavefront still alive entering each bounce: the
    upper bound on what compaction can save."""
    h = live_path_histogram(scene, seed=seed,
                            device=device).astype(np.float64)
    return h / h[0]
