"""One whole progressive iteration as one CUDA kernel (csrc/megakernel.cu).

Counterpart of project3_cuda_path_tracer_tpu/ops/megakernel.py. The Pallas
kernel there (`_make_kernel`) bakes the scene into its instruction stream;
here the scene is packed into one small float32 device table
(`pack_scene`) that each thread block copies to shared memory, so one build
serves every scene and camera.

`iteration()` is the wrapper the renderer calls: it checks its inputs, then
runs `iteration_plain` (the torch-op wavefront chain, render/integrator.
trace_wavefront) for CPU tensors and launches the kernel for CUDA tensors,
always in its persistent schedule (warps that refill dead lanes from a
pixel counter). `_iteration_grid` launches the same kernel in the first
port's one-thread-per-pixel schedule; only the A/B and the bitwise check
(chip_smoke.py, the `cuda` test) call it. Every launch of either schedule
counts under `k1` (utils/launches.py), and a grid one under `k1_grid`
too, and adds its busy and total lane slots (the busy ones are the live
segments it traced) to the device tally's `k1_segments` and `k1_slots`.

On the card the kernel rounds as the plain version does, op for op, so
the two agree bit for bit on the "stratified" and "uniforms" samplers
(scenes of fewer than `integrator.SPHERE_BATCH_MIN` eligible spheres: the
plain version tests more in one batched pass of other arithmetic).

Samplers (the `sampler` argument):
  "philox"     the kernel draws Philox4x32-10 keyed on the seed, counter
               (pixel, iteration, bounce, draw); the plain version draws the
               same number of uniforms from a torch.Generator seeded alike,
               so the two agree in distribution, not lane by lane.
  "stratified" the CP-rotated lattice of ops/wavefront.stratified_planes,
               bit for bit in both versions.
  "uniforms"   injected tensors: cam_u [5, N] (AA x, AA y, lens r, lens
               phi, shutter time) and u [depth, 4, N] (u_lobe, u1, u2,
               u_fresnel per bounce); tests feed both versions the same.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..scene import types as T
from ..utils import cuda_build
from ..utils.device import stream_counter
from ..utils.launches import count, tally_address

MAX_GEOMS = 32
SAMPLERS = {"philox": 0, "stratified": 1, "uniforms": 2}
CAM_DIMS = 5
F32 = torch.float32

# Table layout (floats), mirrored by csrc/megakernel.cu:
#   header  [0] G, [1] M, [2:5] position, [5:8] view, [8:11] up,
#           [11:14] right, [14:16] pixel_length, [16] aperture,
#           [17] focal_distance, [18] shutter, [19] unused
#   geom g  at HEADER + g*GEOM_STRIDE: inverse rows 0-2 (12),
#           transform rows 0-2 (12), inverse-transpose 3x3 (9),
#           velocity (3), type, material id, 2 unused
#   mat m   at HEADER + G*GEOM_STRIDE + m*MAT_STRIDE: color (3),
#           specular color (3), emittance, has_reflective, has_refractive,
#           ior, p_refr, p_spec, p_diff, 3 unused
HEADER = 20
GEOM_STRIDE = 40
MAT_STRIDE = 16
MAX_TABLE_BYTES = 48 * 1024  # default dynamic shared memory of a block
SCHEDULES = {"persistent": 0, "grid": 1}


def _unsupported(scene: T.Scene) -> Optional[str]:
    """Why the kernel cannot render `scene` (the renderer then takes the
    wavefront route), or None. The JAX `supports()` (megakernel.py:58-79)
    plus four checks the Pallas kernel lacks: it never reads SPECEX, the
    procedural checker, the procedural sky or a constant environment, and
    renders such scenes without them."""
    types = scene.geoms.type.cpu().numpy()
    if types.shape[0] > MAX_GEOMS:
        return f"{types.shape[0]} geoms (at most {MAX_GEOMS})"
    if np.isin(types, (T.MESH, T.SDF)).any():
        return "mesh or SDF geoms"
    tx = scene.textures
    if tx.has_atlas:
        return "a texture atlas"
    if tx.has_env:
        return "an environment map"
    if (tx.bump[:, 0] > 0).any() or (tx.nrm_id >= 0).any():
        return "bump or normal maps"
    if (tx.checker_scale > 0).any():
        return "a procedural checker"
    mt = scene.materials
    if mt.dispersion is not None and (mt.dispersion > 0).any():
        return "spectral dispersion"
    if (mt.specular_exponent > 0).any():
        return "a glossy material (SPECEX > 0)"
    if float(tx.sky[0]) > 0:
        return "the procedural sky"
    if (tx.env[0, 0] * tx.env_enabled != 0).any():
        return "a non-zero constant environment"
    return None


def supports(scene: T.Scene) -> bool:
    """Primitive (cube/sphere) scenes of at most 32 geoms, untextured and
    unchecked, with no environment, sky, glossy lobe, dispersion, bump or
    normal map."""
    return _unsupported(scene) is None


def require_supported(scene: T.Scene) -> None:
    why = _unsupported(scene)
    if why is not None:
        raise NotImplementedError(
            f"scene not renderable by the megakernel (K1): it has {why} "
            "(render.integrator.Renderer sends such scenes down the "
            "wavefront route)")


# ---------------------------------------------------------------------------
# The scene table
# ---------------------------------------------------------------------------

def pack_scene(scene: T.Scene, device) -> torch.Tensor:
    """The scene as one contiguous float32 table on `device` (layout above).
    Built from torch ops, so gradients would flow into it."""
    g, mt = scene.geoms, scene.materials
    cam = scene.camera.flat()
    G, M = scene.num_geoms, scene.num_materials
    if G and not (0 <= int(g.material_id.min())
                  and int(g.material_id.max()) < M):
        raise ValueError(f"geom material ids must lie in [0, {M})")
    header = torch.cat([
        torch.tensor([G, M], dtype=F32), cam["position"], cam["view"],
        cam["up"], cam["right"], cam["pixel_length"],
        cam["aperture"].reshape(1), cam["focal_distance"].reshape(1),
        cam["shutter"].reshape(1), torch.zeros(1, dtype=F32)])
    geoms = torch.cat([
        g.inverse_transform[:, :3, :].reshape(G, 12),
        g.transform[:, :3, :].reshape(G, 12),
        g.inverse_transpose[:, :3, :3].reshape(G, 9),
        g.velocity.reshape(G, 3),
        g.type.to(F32).reshape(G, 1), g.material_id.to(F32).reshape(G, 1),
        torch.zeros((G, 2), dtype=F32)], dim=1)
    p_refr = torch.clamp(mt.has_refractive, 0.0, 1.0)
    p_spec = torch.clamp(mt.has_reflective, 0.0, 1.0) * (1.0 - p_refr)
    p_diff = torch.clamp(1.0 - p_refr - p_spec, min=0.0)
    cols = [mt.emittance, mt.has_reflective, mt.has_refractive, mt.ior,
            p_refr, p_spec, p_diff]
    mats = torch.cat([mt.color, mt.specular_color]
                     + [c.reshape(M, 1) for c in cols]
                     + [torch.zeros((M, 3), dtype=F32)], dim=1)
    table = torch.cat([header, geoms.reshape(-1), mats.reshape(-1)])
    return table.to(device).contiguous()


def unpack_scene(table: torch.Tensor, num_geoms: int
                 ) -> Tuple[T.Materials, dict, T.Geoms]:
    """(materials, camera dict, geoms) as views of a packed table."""
    G = num_geoms
    h = table[:HEADER]
    cam = dict(position=h[2:5], view=h[5:8], up=h[8:11], right=h[11:14],
               pixel_length=h[14:16], aperture=h[16], focal_distance=h[17],
               shutter=h[18])
    geo = table[HEADER:HEADER + G * GEOM_STRIDE].reshape(G, GEOM_STRIDE)
    last_row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=F32,
                            device=table.device).expand(G, 1, 4)

    def affine(rows):
        return torch.cat([rows.reshape(G, 3, 4), last_row], dim=1)

    invt = torch.zeros((G, 4, 4), dtype=F32, device=table.device)
    invt[:, :3, :3] = geo[:, 24:33].reshape(G, 3, 3)
    geoms = T.Geoms(
        type=geo[:, 36].to(torch.int32), material_id=geo[:, 37].to(torch.int32),
        transform=affine(geo[:, 12:24]), inverse_transform=affine(geo[:, 0:12]),
        inverse_transpose=invt, velocity=geo[:, 33:36],
        mesh_id=torch.full((G,), -1, dtype=torch.int32, device=table.device))
    mat = table[HEADER + G * GEOM_STRIDE:].reshape(-1, MAT_STRIDE)
    materials = T.Materials(
        color=mat[:, 0:3], specular_exponent=torch.zeros_like(mat[:, 6]),
        specular_color=mat[:, 3:6], emittance=mat[:, 6],
        has_reflective=mat[:, 7], has_refractive=mat[:, 8], ior=mat[:, 9],
        dispersion=torch.zeros_like(mat[:, 6]))
    return materials, cam, geoms


def seed32(seed: int, iteration: int) -> int:
    """The per-iteration seed of the JAX MegakernelRenderer.step
    (megakernel.py:603)."""
    return (seed * 2654435761 + iteration) & 0x7FFFFFFF


# ---------------------------------------------------------------------------
# Plain version and kernel wrapper
# ---------------------------------------------------------------------------

def iteration_plain(accum: torch.Tensor, scene_table: torch.Tensor, cfg,
                    iteration: int, seed: int, sampler: str,
                    cam_u: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """accum += one iteration's radiance, in torch ops (in place)."""
    # the integrator imports this module for Renderer
    from ..render.integrator import to_device, trace_wavefront
    G = len(cfg.geom_types)
    materials, cam, geoms = unpack_scene(scene_table, G)
    textures = to_device(T.Textures.none(int(materials.color.shape[0])),
                         scene_table.device)
    gen = None
    if sampler == "philox":
        gen = torch.Generator(device=scene_table.device)
        gen.manual_seed(seed32(seed, iteration))
    cfg = dataclasses.replace(cfg, stratified=(sampler == "stratified"))
    rad = trace_wavefront(materials, cam, geoms, textures, cfg,
                          generator=gen, iteration=iteration,
                          cam_u=cam_u, u=u)
    img = torch.stack([rad.x, rad.y, rad.z], dim=-1)
    return accum.add_(img.reshape(cfg.height, cfg.width, 3))


def _check_tensor(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != F32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_args(accum, scene_table, cfg, iteration, sampler, cam_u, u):
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler must be one of {tuple(SAMPLERS)}, "
                         f"got {sampler!r}")
    if cfg.glossy or cfg.sky:
        raise NotImplementedError("the glossy lobe and the procedural sky "
                                  "are outside the kernel (supports())")
    if not 0 < len(cfg.geom_types) <= MAX_GEOMS:
        raise ValueError(f"1..{MAX_GEOMS} geoms, got {len(cfg.geom_types)}")
    if any(t not in (T.CUBE, T.SPHERE) for t in cfg.geom_types):
        raise NotImplementedError("only cube and sphere geoms")
    if iteration < 0 or cfg.trace_depth < 1:
        raise ValueError("iteration must be >= 0 and trace_depth >= 1")
    dev = accum.device
    _check_tensor("accum", accum, (cfg.height, cfg.width, 3), dev)
    _check_tensor("scene_table", scene_table, None, dev)
    rest = (scene_table.numel() - HEADER
            - len(cfg.geom_types) * GEOM_STRIDE)
    if scene_table.ndim != 1 or rest <= 0 or rest % MAT_STRIDE:
        raise ValueError("scene_table is not a packed table of "
                         f"{len(cfg.geom_types)} geoms (pack_scene)")
    if scene_table.numel() * 4 > MAX_TABLE_BYTES:
        raise ValueError(f"scene table of {scene_table.numel() * 4} bytes "
                         f"exceeds {MAX_TABLE_BYTES} bytes of shared memory")
    n = cfg.width * cfg.height
    if sampler == "uniforms":
        _check_tensor("cam_u", cam_u, (CAM_DIMS, n), dev)
        _check_tensor("u", u, (cfg.trace_depth, 4, n), dev)
    elif cam_u is not None or u is not None:
        raise ValueError("cam_u/u are only read by sampler='uniforms'")


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load("megakernel")
    head = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_int] * 7 + [ctypes.c_uint32, ctypes.c_uint32]
            + [ctypes.c_void_p] * 2)
    lib.megakernel_iteration.argtypes = head + [ctypes.c_int] + [
        ctypes.c_void_p] * 3
    lib.megakernel_iteration_grid.argtypes = head + [ctypes.c_void_p] * 2
    lib.megakernel_attributes.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.megakernel_iteration, lib.megakernel_iteration_grid,
               lib.megakernel_attributes):
        fn.restype = ctypes.c_int
    lib.megakernel_error_string.restype = ctypes.c_char_p
    lib.megakernel_error_string.argtypes = [ctypes.c_int]
    return lib


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"megakernel {what} failed: "
                           + lib.megakernel_error_string(rc).decode())


def _attributes(schedule: int, sampler: int, motion: int,
                smem_bytes: int) -> tuple:
    """(registers, local bytes, max threads per block, resident blocks per
    SM, static shared bytes) of one instance on the current device."""
    lib = _kernel_lib()
    out = (ctypes.c_int * 5)()
    _raise_on(lib.megakernel_attributes(schedule, sampler, motion,
                                        smem_bytes, out), lib, "attributes")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _persistent_blocks(device_index: int, sampler: int, motion: int,
                       smem_bytes: int) -> int:
    """The persistent grid that fills the card: SMs x the instance's
    resident blocks, worked out once per device, instance and table size."""
    with torch.cuda.device(device_index):
        per_sm = _attributes(SCHEDULES["persistent"], sampler, motion,
                             smem_bytes)[3]
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * per_sm


def _launch(schedule: str, accum, scene_table, cfg, iteration: int,
            seed: int, sampler: str, cam_u=None, u=None, *,
            stats: Optional[torch.Tensor] = None):
    """Check the inputs and launch one schedule of the kernel on the current
    stream (CUDA tensors only); count it. The busy and the total lane slots
    of its bounce steps are added to `stats`, an int64 [2] tensor on the
    card, when given, and else to the device tally's `k1_segments` and
    `k1_slots`."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {tuple(SCHEDULES)}")
    _check_args(accum, scene_table, cfg, iteration, sampler, cam_u, u)
    if accum.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {accum.device}")
    if stats is not None:
        if stats.dtype != torch.int64 or tuple(stats.shape) != (2,) \
                or stats.device != accum.device or not stats.is_contiguous():
            raise ValueError("stats must be a contiguous int64 [2] tensor "
                             "on the accumulator's device")
    lib = _kernel_lib()
    with torch.cuda.device(accum.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (accum.data_ptr(), scene_table.data_ptr(), scene_table.numel(),
                cfg.width, cfg.height, cfg.trace_depth, int(cfg.antialias),
                int(cfg.dof), int(cfg.motion), SAMPLERS[sampler],
                iteration & 0xFFFFFFFF, seed32(seed, iteration),
                cam_u.data_ptr() if cam_u is not None else None,
                u.data_ptr() if u is not None else None)
        st = (stats.data_ptr() if stats is not None
              else tally_address(accum.device, "k1_segments"))
        if schedule == "persistent":
            blocks = _persistent_blocks(
                accum.device.index, SAMPLERS[sampler], int(cfg.motion),
                4 * scene_table.numel())
            counter = stream_counter(accum.device, stream)
            rc = lib.megakernel_iteration(*args, blocks, counter.data_ptr(),
                                          st, stream)
        else:
            rc = lib.megakernel_iteration_grid(*args, st, stream)
    _raise_on(rc, lib, "launch")
    count("k1")
    if schedule == "grid":
        count("k1_grid")
    return accum


def _iteration_grid(accum, scene_table, cfg, iteration: int, seed: int,
                    sampler: str, cam_u=None, u=None, *,
                    stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`iteration` in the first port's schedule, one thread per pixel (CUDA
    tensors only): the A/B and the bitwise check of the two schedules."""
    return _launch("grid", accum, scene_table, cfg, iteration, seed, sampler,
                   cam_u, u, stats=stats)


def kernel_attributes(device, smem_bytes: int) -> list:
    """Registers, local memory bytes (stack frame and spills), max threads
    per block and resident blocks per SM (with `smem_bytes` of scene table)
    of every kernel instance, as the CUDA runtime reports them for
    `device`."""
    recs = []
    with torch.cuda.device(device):
        for schedule, sid in SCHEDULES.items():
            for sampler, smp in SAMPLERS.items():
                for motion in (False, True):
                    out = _attributes(sid, smp, int(motion), smem_bytes)
                    recs.append(dict(schedule=schedule, sampler=sampler,
                                     motion=motion, registers=out[0],
                                     local_bytes=out[1],
                                     max_threads_per_block=out[2],
                                     blocks_per_sm=out[3],
                                     static_smem_bytes=out[4]))
    return recs


def iteration(accum: torch.Tensor, scene_table: torch.Tensor, cfg,
              iteration: int, seed: int, sampler: str,
              cam_u: Optional[torch.Tensor] = None,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """accum [H,W,3] += one progressive iteration (in place); returns accum.

    CPU tensors take `iteration_plain`; CUDA tensors launch the kernel's
    persistent schedule on the current stream (no synchronisation), count
    it under `k1` and add its live segments to the `k1_segments` tally."""
    if accum.device.type == "cpu":
        _check_args(accum, scene_table, cfg, iteration, sampler, cam_u, u)
        return iteration_plain(accum, scene_table, cfg, iteration, seed,
                               sampler, cam_u, u)
    return _launch("persistent", accum, scene_table, cfg, iteration, seed,
                   sampler, cam_u, u)
