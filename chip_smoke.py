#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--outdir DIR]

(`--shard-worker INIT RANK WORLD OUT` runs one rank of the two-rank phase;
the script starts those processes itself.)

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA kernels from csrc/ (one nvcc per source, all at
once) and drives these paths:
  - cornell, 800x800, depth 8, through `Renderer` and the CLI: the
    megakernel (K1), held against its plain torch version at the path's
    shapes; its two schedules (persistent warps refilling dead lanes, the
    renderer's; one thread per pixel, `grid`) held equal bit for bit and
    timed in turns, with each schedule's busy lane share, each instance's
    registers and spills, and its shared-memory loads in the SASS;
  - scenes/mesh.txt, 1024x1024, depth 8, the 81,920-triangle blob, through
    `Renderer` and the CLI: the wavefront route, whose BVH traversals are
    K2 (8-wide tree) or, with the binary packing (`pack_all`), K3 and K4;
    each is held against its plain version on aimed rays, the primary rays
    and one diffuse bounce of the blob; K2's two schedules (persistent warps
    refilling finished lanes, the renderer's; one thread per ray, `grid`)
    and its tiny-stack instance held equal bit for bit, and the schedules
    timed in turns with each one's busy lane share, deepest stack,
    registers, spills and global loads in the SASS; K3 (one thread per
    ray, `grid`) and K4 (warp packets of live rays) held equal to the
    plain version bit for bit, step counts included, and timed in turns on
    both wavefronts and on each bounce of one `pack_all` iteration;
  - mesh.txt with --nee: the shadow rays through K2's any-hit mode, held
    bit for bit against its plain version on the bounce-0 and bounce-1
    shadow wavefronts, timed beside its bound, launches counted;
  - the train step (models/inverse.py): gradients on the card against the
    CPU's at 64x64 depth 8; InverseRenderer fitting an albedo back; and the
    mesh scene through the differentiable recompute (K2 inside);
  - the train step as one captured CUDA graph (slice J): make_train_scan
    and InverseRenderer replaying one graph of a whole step (render, loss,
    autograd.grad, Adam, the history update) against the loop of eager
    make_train_step calls from one state, bit for bit where two eager runs
    of a step agree bit for bit: cornell 800x800 depth 8 in bench.py's
    history form (ms a step both ways, fwd+bwd path segments/s, capture
    and instantiate seconds, pool bytes, peak memory, a profiled replay
    and eager step), a second call replaying with no new capture, three
    two-render polish steps; the two-render form at 256x256; textured_env
    at 512x512 under remat with K2 and P1 inside the graph (16 each a step
    by their device tallies); InverseRenderer's history and polish graphs
    in one pool;
  - direct lighting through `Renderer` (the wavefront route): cornell and
    scenes/lights.txt at 800x800 depth 8 with --nee, their means against
    K1's plain render, ms and kernels per iteration, the RMSE against
    plain sampling, the card against the CPU; scenes/manylights.txt with
    --nee-ris 8 and --restir 8 against --nee, the reservoir reaching its
    cap; scenes/manylights256.txt with --nee-ris 8 through the batched
    sphere pass; the CLI with --nee;
  - textures and environment lighting (slice D) through `Renderer`:
    scenes/textured_env.txt (a textured ground and torus, mirror and glass
    spheres, the sky.hdr env map) and its procedural twin at their own
    2048x2048 depth 8 on the wavefront route, one K2 launch a bounce on the
    torus and, on textured_env, one P1 launch a bounce: the fused atlas+env
    texel fetch (ops/texfetch.py); P1 held bit for bit against its plain
    version on that path's bounce-0 and bounce-1 indices and timed warm and
    cold beside torch.take; K2 bit for bit on the torus's bounce-0/1 rays
    (nearest) and on env NEE's shadow rays (any hit); --bilinear and
    --bilinear-fast against nearest; env-map and mixed NEE at 512x512
    against the plain render; the card against the CPU at 64x64;
  - the integrator features (slice E) through `Renderer`: mesh.txt with
    --stratified --sort --compact (8 K2 launches an iteration, the image
    bit for bit the identity order's; K2 held bit for bit against its
    plain version on the compacted bounce-1 wavefront and timed beside the
    same rays in the identity order), with --russian-roulette, and with
    the first-bounce cache (8 K2 launches, then 7 an iteration, within
    1e-5 of the uncached render); cornell_dof with --sort (bit for bit);
    scenes/sdf.txt and scenes/dispersion.txt at 800x800 depth 8 (ms,
    kernels, busy share, the card against the CPU, dispersion's split
    bands); Russian roulette against K1's plain render; the Sobol
    sampler's RMSE beside the lattice's; the CLI with --clamp, --gamma and
    --aces;
  - the render services (slice F) through `Renderer` and the CLI: cornell
    800x800 depth 8 with --adaptive --adaptive-epoch 8 --stratified (the
    wavefront route, no kernel; exact counts spread by the replans; the
    image's mean within 3% of K1's plain render (the adaptive estimator
    reads ~2% low at 32 spp); RMSE against a 1,024-spp
    K1 reference beside the uniform wavefront's; the replans' host ms;
    ms an iteration in turns with the uniform wavefront); mesh.txt with
    --adaptive and the cost proxy (8 K2 launches an iteration; K2 bit for
    bit against its plain version on a replanned bounce-0 and bounce-1
    wavefront, held beside the identity order's); the card against the CPU
    under one fixed plan; the denoiser (denoised RMSE below raw at 4 spp,
    the G-buffer with and without the mirror relay and the filter timed
    apart, mesh.txt's G-buffer through K2); compaction_ratios on mesh.txt;
    --checkpoint-every and --resume through the CLI (uniform bit for bit,
    --adaptive resumed mid-epoch with exact counts and within 2e-5,
    lights.txt --restir 8 within 2e-5);
  - the train step through every scene: textured_env at its own 2048x2048
    depth 8 (each bounce checkpointed, the JAX remat rule; 16 K2 and 16 P1
    launches a step, K2 and P1 held bit for bit against their plain
    versions on the step's own bounce-0/1 inputs), sdf.txt and
    dispersion.txt at 800x800 depth 8, under the memory schedule of the
    rule, with ms and peak memory a step; the card against the CPU at
    64x64 depth 8 on all three;
  - sharding (slice G): mesh.txt 1024x1024 depth 8 through ShardedRenderer
    in a world of one over NCCL against the single-process render (1e-5),
    ms an iteration in turns, the sharded train step's gradients; two
    ranks on the one card over gloo with CUDA tensors (this script again,
    `--shard-worker`), their gathered cornell image and summed gradients
    against one process;
  - the app (slice H): the HTTP preview on an ephemeral port over cornell
    800x800 depth 8, POST /orbit, then four K1 launches whose frame equals
    a fresh Renderer's at the new camera bit for bit;
  - the chunked render (slice I): `Renderer.step_many` on the wavefront
    route replays one captured CUDA graph of an iteration; mesh.txt
    1024x1024 depth 8 (plain and --sort --compact), textured_env 2048x2048
    depth 8, cornell --nee, manylights --restir 8, sdf.txt, cornell
    --adaptive across two epochs, ShardedRenderer in a world of one and a
    wavefront preview after POST /orbit (timed, as is a frame, while the
    preview's loop runs) each run n eager step() calls against
    step_many(n) from the same start, bit for bit (accumulation,
    reservoir, adaptive sums and counts), then ms an iteration of both
    forms in turns, the kernels and device busy share of a replay (an
    eager step's are the earlier paths'), K2/K3/P1/I1/S1 launches a replay (the
    capture's count, held against the kernels' device tallies over the
    chunk and over one replay, beside the replay's kernels by name in
    torch.profiler's records), capture and instantiate seconds and the
    graph pool's bytes;
  - I1, the analytic primitives' nearest hit (csrc/prim_hit.cu via
    ops/primhit.py), on the bounce-0 and bounce-1 wavefronts of the three
    render cells (mesh.txt 1024x1024, cornell 800x800 with NEE and its
    shadow queries, textured_env 2048x2048 under the thin lens): bit for
    bit against its plain chain on the card on every hit field, timed held
    and cold beside its bytes bound and the plain chain, and its launches
    over four iterations of each (one eager, then the captured graph's
    replays), read from its device tally;
  - S1, the no-grad shading step (csrc/shade.cu via ops/shade.py), on the
    bounce-0 and bounce-1 wavefronts of the three render cells (mesh.txt
    1024x1024, cornell 800x800 with NEE, textured_env 2048x2048 through
    the fused texel: its index entry point, P1, its shade entry point):
    bit for bit against the torch chain on the card on every output plane
    and the fused index, timed held and cold beside its bytes bound and the
    chain, and its launches over four iterations of each (one eager, then
    the captured graph's replays), read from its device tally;
  - the probes' entry points (tools/exp_gather.py, P1, csrc/gather.cu, and
    tools/exp_extract_cost.py, P2, csrc/extract_cost.cu), each kernel held
    bit for bit against its plain version first: every P1 instance that
    holds the table (in one block's shared memory, or read through L2) at
    the 64 KB, 256 KB and 512 KB tables, timed in
    turns warm and cold beside torch.take; every P2 kind at 256 steps and,
    against the first port's kernel, at 4,096, with the chain floor's terms
    (a dependent row load, FP32 operation and shuffle) measured alone.
Where a path runs through `Renderer.step_many`, which replays a captured
CUDA graph on the wavefront route, its launches are the ones the kernels
count themselves in device memory as they run (`measured_launches`): a
wrapper counts a launch where it enqueues one, which a replay does not do.
Kernel and plain version are timed in turns. Every phase raises on failure,
so any failure exits non-zero. Without a card, or without the rest of the
repository beside it, it exits non-zero before printing any result.

Output, on stdout: progress lines, one JSON line per timing, the card's
name and power limit as nvidia-smi reports them, a `{"kernels": [...]}`
line (each kernel's time beside its bound: bytes over the HBM rate or FP32
operations over the FP32 rate, from this run's inputs), and last
`{"ok": true, "device": {...}}`. The PNGs go to --outdir.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "project3_cuda_path_tracer_tpu_torch"
SCENE = os.path.join(ROOT, "scenes", "cornell.txt")
GLASS = os.path.join(ROOT, "scenes", "cornell_glass.txt")
GOLDEN = os.path.join(ROOT, "tests", "golden_cornell_64x64_8spp_seed123.npz")
MESH = os.path.join(ROOT, "scenes", "mesh.txt")
LIGHTS = os.path.join(ROOT, "scenes", "lights.txt")
MANY = os.path.join(ROOT, "scenes", "manylights.txt")
MANY256 = os.path.join(ROOT, "scenes", "manylights256.txt")
TEXTURED = os.path.join(ROOT, "scenes", "textured_env.txt")
TEXTURED_PROC = os.path.join(ROOT, "scenes", "textured_env_proc.txt")
MESH_GEOM = 3  # the blob's geom index in scenes/mesh.txt

# Lane contract of tests/test_megakernel.py: kernel and plain version are
# separately compiled programs. nvcc contracts multiply-adds into FMAs and
# its rsqrtf differs from torch's rsqrt by ulps; near a decision threshold
# (nearest-hit ties, the SQRT_OF_ONE_THIRD frame pick, the Fresnel test)
# such an ulp flips a binary choice and the whole lane diverges. So: lanes
# agree to ATOL, at most FRAC of them diverge, image means within MEAN_TOL.
ATOL, FRAC, MEAN_TOL = 1e-4, 0.01, 0.05
# The glass sphere adds the transmitted path, with more thresholds.
GLASS_ATOL, GLASS_FRAC = 2e-4, 0.02

# An H100 SXM's published peaks at its 700 W limit (NVIDIA's data sheet,
# dense rates): HBM bytes/s, and FP32 FLOP/s outside the tensor cores.
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12
# K1's FP32 operations, counted by hand from csrc/megakernel.cu (add, mul,
# min, max, compare, select, abs, division, sqrt, rsqrt, sin, cos: 1 each;
# FMA: 2): one cube or sphere test up to its world distance; the velocity
# shift of one test; the shading of a segment that goes on (the winner's
# normal, the draws' conversion, the diffuse lobe, the throughput); one
# camera ray. Philox and the lattice hash are integer work, not counted.
K1_OPS_CUBE, K1_OPS_SPHERE, K1_OPS_MOTION = 130, 107, 12
K1_OPS_SHADE, K1_OPS_CAMERA = 158, 35
# The traversals (csrc/bvh_common.cuh): a slab test (box_hit) is 32 FP32
# operations, a Moller-Trumbore test (leaf) 54; K2 tests 8 child slabs per
# interior node it pops. The bytes a kernel reads of each row: an 8-wide
# node its 48 box floats, 8 encodings, axis and threshold; a binary node
# its 6 box floats and 2 ints; a tested triangle v0, e1, e2; a triangle a
# ray hits also its 3 normals and 3 uvs.
BOX_OPS, TRI_OPS = 32, 54
NODE8_BYTES, NODE2_BYTES = 58 * 4, 8 * 4
TRI_TEST_BYTES, TRI_HIT_BYTES = 9 * 4, 15 * 4


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the FP32 operations over the FP32 rate."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_flops=flops)


def k1_bound(cfg, table: torch.Tensor, segments: int) -> dict:
    """K1's bound for one iteration at `cfg` whose paths traced `segments`
    live segments: every segment tests every geom; at least segments - N
    of them shade and go on; each of the N pixels casts one camera ray and
    reads and writes its 12 accumulator bytes; the table is read once."""
    from project3_cuda_path_tracer_tpu_torch.scene import types as T
    n = cfg.width * cfg.height
    per_seg = sum(K1_OPS_CUBE if t == T.CUBE else K1_OPS_SPHERE
                  for t in cfg.geom_types)
    if cfg.motion:
        per_seg += K1_OPS_MOTION * len(cfg.geom_types)
    flops = (segments * per_seg + max(segments - n, 0) * K1_OPS_SHADE
             + n * K1_OPS_CAMERA)
    return bound(24 * n + 4 * table.numel(), flops)


class RowLog:
    """A node table handed to a plain traversal in place of the tensor: it
    marks the rows the traversal reads and counts the reads."""

    def __init__(self, table: torch.Tensor):
        self.table, self.shape = table, table.shape
        self.read = torch.zeros(table.shape[0], dtype=torch.bool,
                                device=table.device)
        self.reads = 0

    def __getitem__(self, rows: torch.Tensor) -> torch.Tensor:
        self.read[rows] = True
        self.reads += int(rows.numel())
        return self.table[rows]


def tree_reads(plain, packed, node_table: str) -> dict:
    """What one run of `plain(packed)`, a plain traversal, reads of the
    tree: the distinct node rows and the node visits (its table
    `node_table` under a RowLog), the distinct triangle rows and the
    triangle tests (each leaf's rows start..start+count-1, as the kernels
    read them; the plain version also reads past `count`)."""
    from project3_cuda_path_tracer_tpu_torch.ops import pallas_bvh as PB
    log_nodes = RowLog(getattr(packed, node_table))
    tri_read = torch.zeros(packed.tris.shape[0], dtype=torch.bool,
                           device=packed.tris.device)
    tests = 0
    leaf_phase = PB.leaf_phase

    def marking(rows, start, count, *args, **kwargs):
        nonlocal tests
        k = torch.arange(int(count.max()), device=start.device)
        tri_read[(start[:, None] + k)[k < count[:, None]]] = True
        tests += int(count.sum())
        return leaf_phase(rows, start, count, *args, **kwargs)

    PB.leaf_phase = marking
    try:
        out = plain(packed._replace(**{node_table: log_nodes}))
    finally:
        PB.leaf_phase = leaf_phase
    return dict(node_rows=int(log_nodes.read.sum()),
                node_visits=log_nodes.reads,
                tri_rows=int(tri_read.sum()), tri_tests=tests,
                hit_tris=int(torch.unique(out[4][out[4] >= 0]).numel()))


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sized(path: str, res: int, depth: int):
    from project3_cuda_path_tracer_tpu_torch import load_scene
    scene = load_scene(path)
    scene.camera.resolution = (res, res)
    scene.camera.derive()
    scene.settings.trace_depth = depth
    return scene


def compare_lanes(tag: str, got: torch.Tensor, want: torch.Tensor,
                  atol: float, frac: float,
                  exclude: torch.Tensor = None) -> dict:
    """The lane contract between two [.., 3] images. `exclude` ([N] bool)
    marks lanes left out of the divergent share (reported beside it)."""
    g = got.reshape(-1, 3).double().cpu().numpy()
    w = want.reshape(-1, 3).double().cpu().numpy()
    if not (np.isfinite(g).all() and np.isfinite(w).all()):
        raise AssertionError(f"{tag}: non-finite values")
    err = np.abs(g - w)
    bad = (err > atol).any(axis=1)
    keep = (np.ones_like(bad) if exclude is None
            else ~exclude.reshape(-1).cpu().numpy())
    diverged = float((bad & keep).sum() / max(keep.sum(), 1))
    mean_gap = float(np.abs(g.mean(0) - w.mean(0)).max())
    rec = dict(check=tag, lanes=int(g.shape[0]), atol=atol,
               diverged_frac=diverged, max_abs_err=float(err.max()),
               p99_abs_err=float(np.percentile(err.max(axis=1), 99)),
               mean_gap=mean_gap)
    if exclude is not None:
        rec.update(excluded_frac=float(1 - keep.mean()),
                   diverged_frac_all_lanes=float(bad.mean()))
    log(json.dumps(rec))
    if diverged > frac:
        raise AssertionError(f"{tag}: {diverged:.4f} of lanes diverge "
                             f"(limit {frac})")
    if mean_gap >= MEAN_TOL:
        raise AssertionError(f"{tag}: channel means differ by {mean_gap}")
    return rec


def kernel_vs_plain(scene, sampler: str, iteration: int, atol: float,
                    frac: float, tag: str, seed_np: int = 0) -> dict:
    """One iteration through the wrapper (kernel) and iteration_plain on the
    same inputs, on the card."""
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.render.integrator import \
        build_trace_config
    cfg = build_trace_config(scene)
    dev = torch.device("cuda")
    table = mk.pack_scene(scene, dev)
    cam_u = u = None
    if sampler == "uniforms":
        n = cfg.width * cfg.height
        rng = np.random.default_rng(seed_np)
        cam_u = torch.from_numpy(rng.random((mk.CAM_DIMS, n),
                                            dtype=np.float32)).to(dev)
        u = torch.from_numpy(rng.random((cfg.trace_depth, 4, n),
                                        dtype=np.float32)).to(dev)
    shape = (cfg.height, cfg.width, 3)
    got = mk.iteration(torch.zeros(shape, device=dev), table, cfg, iteration,
                       0, sampler, cam_u, u)
    want = mk.iteration_plain(torch.zeros(shape, device=dev), table, cfg,
                              iteration, 0, sampler, cam_u, u)
    torch.cuda.synchronize()
    return compare_lanes(tag, got, want, atol, frac)


def time_ms(fn, iters: int, warm: int = 3) -> float:
    """Mean ms per call over `iters` calls, by CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def traversal_check(tag: str, got, want, pops=None) -> dict:
    """A traversal kernel's (t, normal, u, v, tri) against a plain version's
    on the same rays: tri equal on >= 1-FRAC of the lanes; t, normal and uv
    to ATOL on the lanes that agree and hit; per-ray pop counts (`pops` =
    (kernel, plain)) equal on >= 1-FRAC."""
    g = torch.stack([got[0], *got[1], got[2], got[3]])
    w = torch.stack([want[0], *want[1], want[2], want[3]])
    agree = got[4] == want[4]
    hit = agree & (got[4] >= 0)
    err = float((g - w)[:, hit].abs().max()) if bool(hit.any()) else 0.0
    rec = dict(check=tag, lanes=int(agree.numel()), hits=int(hit.sum()),
               tri_agree=float(agree.float().mean()), atol=ATOL,
               max_abs_err=err)
    if pops is not None:
        rec["pops_agree"] = float((pops[0] == pops[1]).float().mean())
        rec["mean_pops"] = float(pops[0].float().mean())
    log(json.dumps(rec))
    if rec["tri_agree"] < 1 - FRAC or rec.get("pops_agree", 1.0) < 1 - FRAC:
        raise AssertionError(f"{tag}: lanes disagree ({rec})")
    if err > ATOL:
        raise AssertionError(f"{tag}: hit attributes differ by {err}")
    return rec


def aimed_rays(n: int, dev, seed: int = 0):
    """Object-space rays from random origins on a radius-3 sphere aimed
    near the blob's centre (the generator of tests/test_bvh8.py), and an
    unbounded t_bound."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n)).astype(np.float32)
    o /= np.linalg.norm(o, axis=0, keepdims=True)
    o *= 3.0
    d = rng.uniform(-0.4, 0.4, size=(3, n)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    planes = [torch.from_numpy(np.ascontiguousarray(c)).to(dev)
              for c in (*o, *d)]
    return (tuple(planes[:3]), tuple(planes[3:]),
            torch.full((n,), 1e30, device=dev))


def mesh_wavefronts(r):
    """The blob's traversal inputs (qo, qd, t_bound) for the 1024x1024
    primary rays of mesh.txt (stratified draws, iteration 0) and for one
    diffuse bounce of them (dead lanes bounded by -1), on the card."""
    from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
    from project3_cuda_path_tracer_tpu_torch.ops.vec import V3
    materials, cam, geoms, textures = r.tables
    cfg = r.cfg
    o, d, times, pix = wf.generate_rays_planar(
        cam, cfg.width, cfg.height, antialias=cfg.antialias, dof=cfg.dof,
        motion=cfg.motion, stratified=True, iteration=0)
    bounce0 = wf.mesh_query(o, d, times, geoms, MESH_GEOM)
    hit = wf.intersect_planar(o, d, times, geoms, cfg.geom_types,
                              r.packed_meshes, cfg.mesh_ids)
    n = cfg.width * cfg.height
    one = torch.ones((n,), device=o.x.device)
    out = wf.shade_planar(
        hit, d, V3(one, one, one), torch.ones_like(one, dtype=torch.bool),
        materials, textures, wf.stratified_planes(0, 0, pix, 4,
                                                  wf.SALT_BOUNCE),
        last_bounce=False, glossy=cfg.glossy)
    bounce1 = wf.mesh_query(out.origin, out.direction, times, geoms,
                            MESH_GEOM, alive=out.alive)
    return bounce0, bounce1


def device_share(r, name: str) -> dict:
    """One iteration of `r` under torch.profiler: the device time of the
    kernels whose name holds `name` against all device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r.step()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    total = part = 0.0
    kernels = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        total += t
        kernels += ev.count
        if name in ev.key:
            part += t
    if total == 0:
        return dict(profile="not measured: no device events")
    return dict(device_us=total, traversal_us=part,
                traversal_share=part / total, kernels_launched=kernels,
                window_wall_us=wall_us)


def schedules_equal() -> None:
    """K1's persistent schedule (the renderer's) against its grid schedule
    on the same inputs: the accumulators must be equal bit for bit."""
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.render.integrator import \
        build_trace_config
    dev = torch.device("cuda")
    for path, res, depth, sampler in ((SCENE, 800, 8, "philox"),
                                      (SCENE, 800, 8, "stratified"),
                                      (GLASS, 64, 4, "uniforms")):
        scene = sized(path, res, depth)
        cfg = build_trace_config(scene)
        table = mk.pack_scene(scene, dev)
        n = res * res
        cam_u = u = None
        if sampler == "uniforms":
            rng = np.random.default_rng(5)
            cam_u = torch.from_numpy(rng.random((mk.CAM_DIMS, n),
                                                dtype=np.float32)).to(dev)
            u = torch.from_numpy(rng.random((depth, 4, n),
                                            dtype=np.float32)).to(dev)
        args = (table, cfg, 3, 11, sampler, cam_u, u)
        pers = mk.iteration(torch.zeros((res, res, 3), device=dev), *args)
        grid = mk._iteration_grid(torch.zeros((res, res, 3), device=dev),
                                  *args)
        torch.cuda.synchronize()
        equal = torch.equal(pers, grid)
        tag = f"K1 persistent vs grid {os.path.basename(path)} {res}x{res} " \
              f"d{depth} {sampler}"
        log(json.dumps(dict(check=tag, bitwise=equal,
                            max_abs_diff=float((pers - grid).abs().max()),
                            mean=float(pers.mean()))))
        if not equal or not bool(torch.isfinite(pers).all()):
            raise AssertionError(f"{tag}: accumulators differ")


# A K1 instance's mangled name: megakernel<SCHED, SAMPLER, MOTION>.
K1_MANGLED = re.compile(r"megakernelILi(\d)ELi(\d)ELb(\d)E")
# A K2 instance's: traverse8_kernel<SCHED, ANY_HIT, S> (SCHED 0 persistent,
# 1 grid; the tiny instance's shared stack holds 2 entries, the others' 24).
K2_MANGLED = re.compile(r"traverse8_kernelILi(\d)ELb(\d)ELi(\d+)E")


def k1_instance(m: re.Match) -> tuple:
    """(schedule, sampler, motion) of a K1_MANGLED match."""
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    schedule = {v: k for k, v in mk.SCHEDULES.items()}[int(m.group(1))]
    sampler = {v: k for k, v in mk.SAMPLERS.items()}[int(m.group(2))]
    return schedule, sampler, m.group(3) == "1"


def k2_instance(m: re.Match) -> tuple:
    """(instance, any_hit) of a K2_MANGLED match, instance as
    `bvh8.INSTANCES` names it."""
    instance = ("grid" if m.group(1) == "1" else
                "tiny" if int(m.group(3)) < 8 else "persistent")
    return instance, m.group(2) == "1"


def ptxas_report(log_path: str, mangled: re.Pattern, key) -> dict:
    """key(match) -> registers, spill bytes and stack frame of each kernel
    instance whose name `mangled` matches, from nvcc's -Xptxas -v report
    of the build."""
    with open(log_path) as f:
        lines = f.read().splitlines()
    out, k = {}, None
    for line in lines:
        m = mangled.search(line)
        if m and "Compiling entry" in line:
            k = key(m)
            out[k] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and k:
            out[k].update(stack_bytes=int(m.group(1)),
                          spill_store_bytes=int(m.group(2)),
                          spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and k:
            out[k]["ptxas_registers"] = int(m.group(1))
    return out


def sass_counts(lib_path: str, mangled: re.Pattern, key,
                opcodes: str) -> dict:
    """key(match) -> count of each opcode matching `opcodes` (a regex of
    opcode stems, e.g. "LDS" or "LDG|LDL|STL") with its suffixes (LDS.128,
    LDG.E.128.CONSTANT) in each instance's SASS, by cuobjdump; empty when
    the toolkit has no cuobjdump."""
    from project3_cuda_path_tracer_tpu_torch.utils import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    op = re.compile(rf"\b((?:{opcodes})(?:\.[A-Z0-9_]+)*) ")
    out, k = {}, None
    for line in sass.splitlines():
        m = mangled.search(line)
        if m and "Function :" in line:
            k = key(m)
            out[k] = {}
            continue
        m = op.search(line)
        if m and k:
            out[k][m.group(1)] = out[k].get(m.group(1), 0) + 1
    return out


def k1_timing(gpu: str, table: torch.Tensor, cfg) -> dict:
    """Phase 7 on cornell 800x800 d8, Philox: each schedule's busy lane
    share (one counted launch each), then plain, persistent, grid, grid,
    persistent, plain, each schedule's turn timed twice: by its kernels
    (the stream held while the host enqueues) and with its host side (no
    hold, as `Renderer.step` is timed too); every instance's registers,
    spills and shared loads; K1's bound. Returns the numbers the `kernels`
    line takes."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.utils import cuda_build
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        time_ms as device_ms
    dev = torch.device("cuda")
    renderer = Renderer(load_scene(SCENE), device="cuda")
    acc = torch.zeros((cfg.height, cfg.width, 3), device=dev)

    def launch(schedule, stats=None):
        return lambda: mk._launch(schedule, acc, table, cfg, 0, 0, "philox",
                                  stats=stats)

    lanes = {}
    for sched in mk.SCHEDULES:
        st = torch.zeros((2,), dtype=torch.int64, device=dev)
        launch(sched, stats=st)()
        torch.cuda.synchronize()
        lanes[sched] = [int(v) for v in st.cpu()]
    if lanes["persistent"][0] != lanes["grid"][0]:
        raise AssertionError(f"the schedules traced different segment "
                             f"counts: {lanes}")
    segments = lanes["persistent"][0]

    def plain_step():
        mk.iteration_plain(acc, table, cfg, 0, 0, "philox")

    plain_ms = [time_ms(plain_step, 20)]
    runs = {"persistent": [], "grid": []}
    unheld = {"persistent": [], "grid": []}
    for sched in ("persistent", "grid", "grid", "persistent"):
        runs[sched].append(device_ms(launch(sched), 100, warm=3))
        unheld[sched].append(time_ms(launch(sched), 100))
    plain_ms.append(time_ms(plain_step, 20))
    step_ms = [time_ms(renderer.step, 100), time_ms(renderer.step, 100)]
    lib = cuda_build.library_path("megakernel")
    spills = ptxas_report(lib + ".log", K1_MANGLED, k1_instance)
    loads = sass_counts(lib, K1_MANGLED, k1_instance, "LDS")
    instances = []
    for rec in mk.kernel_attributes(dev, 4 * table.numel()):
        key = (rec["schedule"], rec["sampler"], rec["motion"])
        instances.append(dict(rec, **spills.get(key, {}),
                              shared_loads=loads.get(key, "not measured")))
    log(json.dumps(dict(k1_instances=instances)))
    if any(r.get("spill_store_bytes", 1) or r.get("spill_load_bytes", 1)
           for r in instances):
        raise AssertionError("a K1 instance spills (or ptxas gave no report)")
    k1 = k1_bound(cfg, table, segments)
    n_whd = cfg.width * cfg.height * cfg.trace_depth
    ms = {k: float(np.mean(v)) for k, v in runs.items()}
    ms_unheld = {k: float(np.mean(v)) for k, v in unheld.items()}
    p_ms = float(np.mean(plain_ms))
    philox = {r["schedule"]: r for r in instances
              if r["sampler"] == "philox" and not r["motion"]}
    for sched in ("persistent", "grid"):
        log(json.dumps(dict(
            metric=("kernel" if sched == "persistent" else "grid")
            + "_ms_per_iteration", schedule=sched, value=ms[sched],
            runs=runs[sched], unheld_ms=ms_unheld[sched],
            unheld_runs=unheld[sched],
            path_segments_per_s=n_whd / (ms[sched] / 1e3),
            live_segments=segments,
            live_segments_per_s=segments / (ms[sched] / 1e3),
            busy_lane_slots=lanes[sched][0], lane_slots=lanes[sched][1],
            busy_lane_share=lanes[sched][0] / lanes[sched][1],
            registers=philox[sched]["registers"],
            spill_store_bytes=philox[sched]["spill_store_bytes"],
            share_of_bound=k1["bound_ms"] / ms[sched],
            config="cornell 800x800 depth 8, philox", gpu=gpu)))
    log(json.dumps(dict(metric="plain_ms_per_iteration", value=p_ms,
                        runs=plain_ms,
                        path_segments_per_s=n_whd / (p_ms / 1e3),
                        config="cornell 800x800 depth 8, philox", gpu=gpu)))
    log(json.dumps(dict(metric="renderer_step_ms", value=float(
        np.mean(step_ms)), runs=step_ms, sampler=renderer.sampler,
        config="cornell 800x800 depth 8, Renderer.step, no hold", gpu=gpu)))
    log(json.dumps(dict(metric="k1_bound", **k1, live_segments=segments,
                        gpu=gpu)))
    return dict(ms=ms["persistent"], grid_ms=ms["grid"],
                unheld_ms=ms_unheld["persistent"], plain_ms=p_ms,
                bound_ms=k1["bound_ms"], bound_by=k1["bound_by"])


def same_bits(a, b) -> bool:
    """Two traversal results (t, normal, u, v, tri, and K2's pops or K3's
    and K4's steps) equal bit for bit."""
    fa = torch.stack([a[0], *a[1], a[2], a[3]]).view(torch.int32)
    fb = torch.stack([b[0], *b[1], b[2], b[3]]).view(torch.int32)
    return (torch.equal(fa, fb) and torch.equal(a[4], b[4])
            and torch.equal(a[5], b[5]))


# (name, instance) of every K3/K4 instance that the checks and the A/B
# run, the route's (K3 grid) first.
K34_INSTANCES = [("K3 grid", "grid"), ("K4", "packet")]


def lane_utilisation(pops: torch.Tensor) -> float:
    """The busy lane share one thread per ray can reach on these rays: a
    warp of 32 consecutive rays runs as many pop steps as its longest ray,
    so Σ pops / Σ (32 × the max pops of each 32 consecutive rays)."""
    p = pops.double()
    w = torch.nn.functional.pad(p, (0, (-p.numel()) % 32)).reshape(-1, 32)
    return float(w.sum() / (32 * w.max(dim=1).values).sum())


def mesh_phases(outdir: str, gpu: str):
    """Every mesh-path phase; returns the `kernels` entries of K2-K4 and the
    loaded mesh.txt scene (its SAH build is paid once)."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
    from project3_cuda_path_tracer_tpu_torch.ops import pallas_bvh as PB
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    scene = load_scene(MESH)  # the Python SAH build: once per process
    w, h = scene.camera.resolution
    depth = scene.settings.trace_depth
    log(json.dumps(dict(phase="mesh load", seconds=time.perf_counter() - t0,
                        triangles=int(scene.meshes.tri_v0.shape[0]),
                        nodes8=int(scene.packed_meshes[0].nodes.shape[0]))))
    if (w, h, depth) != (1024, 1024, 8):
        raise AssertionError(f"mesh.txt is {w}x{h} depth {depth}")

    # ---- 8a. K2, K3, K4 against their plain versions -----------------------
    # K2's persistent instance (traverse8, the renderer's) also against its
    # grid instance (the first port's schedule) bit for bit in both modes,
    # and, on the aimed rays, against the tiny-stack instance (the local
    # overflow).
    probe = Renderer(scene, device="cuda")
    p8 = probe.packed_meshes[0]
    pb = PB.PackedMesh(*(t.to(dev) for t in PB.pack_mesh(scene.meshes)))
    bounce0, bounce1 = mesh_wavefronts(probe)
    waves = {"bounce-0": bounce0, "bounce-1": bounce1}
    errs = dict(K2=0.0, K3=0.0, K4=0.0)
    mean_pops, util = {}, {}
    for tag, (qo, qd, tb) in (("aimed 65536", aimed_rays(65536, dev)),
                              ("bounce-0 1024x1024", bounce0),
                              ("bounce-1 1024x1024", bounce1)):
        k = P8.traverse8(qo, qd, p8, t_bound=tb, return_pops=True)
        p = P8.traverse8_plain(qo, qd, p8, t_bound=tb)
        torch.cuda.synchronize()
        rec = traversal_check(f"K2 {tag}", k[:5], p[:5], pops=(k[5], p[5]))
        errs["K2"] = max(errs["K2"], rec["max_abs_err"])
        mean_pops[tag.split()[0]] = rec["mean_pops"]
        util[tag.split()[0]] = lane_utilisation(p[5])
        hit = k[4] >= 0
        half = P8.traverse8(qo, qd, p8, t_bound=torch.where(hit, 0.5 * k[0],
                                                            tb))
        occl = P8.traverse8(qo, qd, p8, t_bound=tb, any_hit=True,
                            return_pops=True)
        torch.cuda.synchronize()
        pruned = not bool((half[4][hit] >= 0).any())
        same_mask = torch.equal(occl[4] >= 0, hit)
        log(json.dumps(dict(check=f"K2 bound and any_hit {tag}",
                            hits=int(hit.sum()), half_bound_all_miss=pruned,
                            any_hit_mask_equal=same_mask,
                            one_thread_per_ray_utilisation=util[
                                tag.split()[0]])))
        if not (pruned and same_mask):
            raise AssertionError(f"K2 {tag}: occlusion bound or any_hit")
        for mode, pers in (("nearest", k), ("any_hit", occl)):
            args = (qo, qd, p8, tb, mode == "any_hit", True)
            others = {"grid": P8._traverse8_grid(*args)}
            if tag.startswith("aimed"):
                others["tiny stack"] = P8._traverse8_tiny(*args)
            torch.cuda.synchronize()
            for name, other in others.items():
                equal = same_bits(pers, other)
                check = f"K2 persistent vs {name} {tag} {mode}"
                log(json.dumps(dict(check=check, bitwise=equal,
                                    hits=int((pers[4] >= 0).sum()),
                                    pops=int(pers[5].sum()))))
                if not equal:
                    raise AssertionError(f"{check}: results differ")
        # K3 and K4 against the plain version, bit for bit, step counts
        # included.
        plain_b = PB.traverse_binary_plain(qo, qd, pb, t_bound=tb)
        binary = {name: PB._launch(inst, qo, qd, pb, tb, True)
                  for name, inst in K34_INSTANCES}
        torch.cuda.synchronize()
        for name, res in binary.items():
            equal = same_bits(res, plain_b)
            err = float((torch.stack([res[0], *res[1], res[2], res[3]])
                         - torch.stack([plain_b[0], *plain_b[1], plain_b[2],
                                        plain_b[3]])).abs().nan_to_num()
                        .max())
            kid = name[:2]
            errs[kid] = max(errs[kid], err)
            log(json.dumps(dict(check=f"{name} vs plain {tag}",
                                bitwise=equal, max_abs_err=err,
                                hits=int((res[4] >= 0).sum()),
                                steps=int(res[5].sum()))))
            if not equal:
                raise AssertionError(f"{name} {tag}: differs from plain")
        agree = float((binary["K3 grid"][4] == k[4]).float().mean())
        log(json.dumps(dict(check=f"K2 tri vs K3 tri {tag}", agree=agree)))
        if agree < 1 - FRAC:
            raise AssertionError(f"K2 and K3 disagree on {tag}: {agree}")

    # ---- 8b. the mesh path: Renderer on mesh.txt ---------------------------
    # one eager iteration, the capture, seven replays: the launches are the
    # kernels' device tallies (`measured_launches`)
    r = Renderer(scene, device="cuda")
    ran = measured_launches(lambda: r.step_many(8))
    k2_launches, wrappers = ran["k2"], ran["wrappers"]
    others = (ran["k1"], wrappers["k2_other"], ran["k3_k4"])
    if (r.route != "wavefront" or k2_launches != 8 * 8
            or not wrappers["k2"] or any(others)):
        raise AssertionError(f"mesh path: route {r.route}, K2 launched "
                             f"{k2_launches} times (want 64), its wrapper "
                             f"counted {wrappers['k2']} (want > 0), K1 / "
                             f"K2 grid and tiny (wrapper) / K3 and K4 "
                             f"{others} (want none)")
    img = r.accum.cpu().numpy()
    if img.shape != (1024, 1024, 3) or not np.isfinite(img).all() \
            or (img < 0).any():
        raise AssertionError("mesh image is not finite and >= 0")
    png = r.save(os.path.join(outdir, "mesh_1024x1024_8spp"))
    log(json.dumps(dict(phase="mesh main path", scene="scenes/mesh.txt",
                        resolution=[w, h], depth=depth,
                        iterations=r.iteration, launches=k2_launches,
                        wrapper_counts=wrappers,
                        graph_replays=r.graph.replays,
                        graph_launches_per_replay=r.graph.launches,
                        grid_launches=others[1],
                        megakernel_launches=others[0],
                        mean=float(img.mean() / r.iteration), png=png)))

    # The same path on the binary tree (pack_all): K3, two iterations, held
    # against the 8-wide tree's image on the same draws.
    rb = Renderer(dataclasses.replace(
        scene, packed_meshes=PB.pack_all(scene.meshes)), device="cuda")
    ran = measured_launches(lambda: rb.step_many(2))
    k3_launches = ran["k3_k4"]
    others = (ran["wrappers"]["k4"], ran["k2"], ran["wrappers"]["k2_other"])
    log(json.dumps(dict(phase="mesh binary path", iterations=rb.iteration,
                        k3_route_instance="grid", k3_launches=k3_launches,
                        wrapper_counts=ran["wrappers"],
                        k4_launches=others[0], k2_launches=others[1])))
    if k3_launches != 2 * 8 or not ran["wrappers"]["k3_k4"] or any(others):
        raise AssertionError(f"binary mesh path launched K3 {k3_launches} "
                             "times for 2 iterations (want 16); K4 "
                             "(wrapper) / K2 / K2 grid and tiny (wrapper) "
                             f"{others} (want none)")
    rw = Renderer(scene, device="cuda")
    rw.step_many(2)
    compare_lanes("mesh binary tree vs 8-wide 1024x1024 d8 2spp", rb.accum,
                  rw.accum, ATOL, FRAC)
    # K4 has no route of its own (nor in the JAX package): its drive is the
    # wrapper on the path's two wavefronts.
    zero_counts()
    for qo, qd, tb in (bounce0, bounce1):
        PB.traverse(qo, qd, pb, t_bound=tb, sub_packets=True)
    torch.cuda.synchronize()
    k4_launches = read_counts()["k4"]

    # The stratified wavefront route, kernel against plain traversal.
    small = dataclasses.replace(
        scene, camera=copy.deepcopy(scene.camera),
        settings=dataclasses.replace(scene.settings, stratified=True))
    small.camera.resolution = (256, 256)
    small.camera.derive()
    got = Renderer(small, device="cuda").render(1).clone()
    kernel_traverse8 = P8.traverse8
    P8.traverse8 = lambda qo, qd, packed, t_bound=None, any_hit=False: \
        P8.traverse8_plain(qo, qd, packed, t_bound, any_hit)[:5]
    try:
        want = Renderer(small, device="cuda").render(1).clone()
    finally:
        P8.traverse8 = kernel_traverse8
    compare_lanes("stratified mesh 256x256 d8: K2 vs plain traversal", got,
                  want, ATOL, FRAC)

    cli = subprocess.run(
        [sys.executable, "-m", PKG, MESH, "--iterations", "4",
         "--device", "cuda", "--metrics", "--outdir", outdir,
         "--out", "mesh_cli_4spp"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if cli.returncode != 0:
        raise AssertionError(f"mesh CLI failed ({cli.returncode}):\n"
                             f"{cli.stderr}")
    metrics = json.loads(cli.stderr.strip().splitlines()[-1])
    if not os.path.exists(metrics["output"]):
        raise AssertionError("mesh CLI wrote no PNG")
    log(json.dumps(dict(phase="mesh cli", **metrics)))

    # ---- 8c. the train step on the mesh scene ------------------------------
    mesh_train(scene)

    # ---- 8e. the mesh path with NEE: K2's any-hit mode -----------------------
    any_hit = mesh_nee(scene, gpu)

    # ---- 8d. timing ---------------------------------------------------------
    runs = [time_ms(r.step, 4, warm=1), time_ms(r.step, 4, warm=1)]
    log(json.dumps(dict(metric="mesh_ms_per_iteration",
                        value=float(np.mean(runs)), runs=runs,
                        config="mesh.txt 1024x1024 depth 8", gpu=gpu,
                        **device_share(r, "traverse8_kernel"))))
    bounds = traversal_bounds(gpu, p8, pb, waves)
    k2 = k2_timing(gpu, p8, waves, util, mean_pops, bounds)
    k2_bounces(gpu, p8, mesh_bounces(r, P8, "traverse8"))
    k34 = binary_timing(gpu, pb, waves, bounds)
    k3_bounces(gpu, pb, mesh_bounces(rb, PB, "traverse"))
    src = f"{PKG}/csrc"
    jax_ops = "project3_cuda_path_tracer_tpu/ops"
    entries = [dict(name="bvh8 traversal (K2)", route="cuda",
                    source=f"{src}/bvh8.cu",
                    replaces=f"{jax_ops}/bvh8.py:355", launches=k2_launches,
                    max_abs_err=errs["K2"],
                    ms=k2[("persistent", "bounce-0")][0],
                    plain_ms=k2[("plain", "bounce-0")],
                    bound_ms=bounds[("K2", "bounce-0")]["bound_ms"],
                    bound_by=bounds[("K2", "bounce-0")]["bound_by"],
                    library_ms=None, grid_ms=k2[("grid", "bounce-0")][0],
                    unheld_ms=k2[("persistent", "bounce-0")][1],
                    **any_hit)]
    for name, replaces, launches, inst in (
            ("binary traversal (K3)", "pallas_bvh.py:128", k3_launches,
             "K3 grid"),
            ("binary traversal, warp packets (K4)", "pallas_bvh.py:343",
             k4_launches, "K4")):
        kid = name[-3:-1]
        b0, b1 = bounds[(kid, "bounce-0")], bounds[(kid, "bounce-1")]
        entries.append(dict(name=name, route="cuda",
                            source=f"{src}/bvh_binary.cu",
                            replaces=f"{jax_ops}/{replaces}",
                            launches=launches, max_abs_err=errs[kid],
                            ms=k34[(inst, "bounce-0")][0],
                            plain_ms=k34[("plain", "bounce-0")],
                            bound_ms=b0["bound_ms"], bound_by=b0["bound_by"],
                            library_ms=None,
                            unheld_ms=k34[(inst, "bounce-0")][1],
                            bounce1_ms=k34[(inst, "bounce-1")][0],
                            bounce1_bound_ms=b1["bound_ms"]))
    return entries, scene


def mesh_nee(scene, gpu: str) -> dict:
    """mesh.txt 1024x1024 depth 8 with --nee (stratified) through
    `Renderer`: one iteration with the counts set to 0 just before it,
    which must launch S1 once a bounce, and whose K2 any-hit launches (the
    shadow rays; one a bounce but the last) are captured by wrapping
    bvh8.traverse8; K2 any-hit held bit for bit
    against traverse8_plain(any_hit=True) on the bounce-0 and bounce-1
    shadow wavefronts, timed with the stream held, and its bound from the
    tree rows those walks read; the iteration's ms and kernels. Returns
    the K2 entry's any-hit keys."""
    from project3_cuda_path_tracer_tpu_torch import Renderer
    from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        time_ms as device_ms
    nee = dataclasses.replace(scene, settings=dataclasses.replace(
        scene.settings, nee=True, stratified=True))
    r = Renderer(nee, device="cuda")
    if r.route != "wavefront" or not r.cfg.nee:
        raise AssertionError(f"mesh --nee: route {r.route}, nee {r.cfg.nee}")
    p8 = r.packed_meshes[0]
    kernel, shadows = P8.traverse8, []

    def capture(qo, qd, packed, t_bound=None, any_hit=False, **kwargs):
        if any_hit:
            shadows.append((tuple(c.clone() for c in qo),
                            tuple(c.clone() for c in qd), t_bound.clone()))
        return kernel(qo, qd, packed, t_bound=t_bound, any_hit=any_hit,
                      **kwargs)

    zero_counts()
    P8.traverse8 = capture
    try:
        r.step()
    finally:
        P8.traverse8 = kernel
    torch.cuda.synchronize()
    depth = r.cfg.trace_depth
    counts = {k: v for k, v in read_counts().items()
              if k in ("k1", "k2", "k2_any_hit", "k2_other", "k3_k4",
                       "shade")}
    log(json.dumps(dict(phase="mesh nee path", scene="scenes/mesh.txt",
                        flags="--nee --stratified", depth=depth,
                        iterations=1, **counts)))
    if (counts["k2_any_hit"] != depth - 1 or counts["k2"] != 2 * depth - 1
            or len(shadows) != depth - 1 or counts["shade"] != depth
            or any(counts[k] for k in ("k1", "k2_other", "k3_k4"))):
        raise AssertionError(f"mesh --nee launches {counts} (want {depth} "
                             f"nearest and {depth - 1} any-hit K2 launches,"
                             f" {depth} of S1, no K1, K3 or K4)")
    img = r.accum.cpu().numpy()
    if not np.isfinite(img).all() or (img < 0).any() or img.mean() <= 0:
        raise AssertionError("mesh --nee image is not finite and > 0")

    out = {}
    for b in (0, 1):
        qo, qd, tb = shadows[b]
        tag = f"bounce-{b} shadow"
        k = P8.traverse8(qo, qd, p8, t_bound=tb, any_hit=True,
                         return_pops=True)
        t0 = time.perf_counter()
        p = P8.traverse8_plain(qo, qd, p8, t_bound=tb, any_hit=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = same_bits(k, p)
        n = int(tb.numel())
        live = tb > 0
        lo, ld = tuple(c[live] for c in qo), tuple(c[live] for c in qd)
        rd = tree_reads(lambda pk: P8.traverse8_plain(
            lo, ld, pk, tb[live], any_hit=True), p8, "nodes")
        n_dead = n - int(live.sum())
        bd = bound((n - n_dead) * (7 + 7) * 4 + n_dead * (1 + 7) * 4
                   + rd["node_rows"] * NODE8_BYTES
                   + rd["tri_rows"] * TRI_TEST_BYTES
                   + rd["hit_tris"] * TRI_HIT_BYTES,
                   rd["node_visits"] * 8 * BOX_OPS
                   + rd["tri_tests"] * TRI_OPS)
        held = [device_ms(lambda: P8._launch("persistent", qo, qd, p8, tb,
                                             any_hit=True), 20, warm=3)
                for _ in range(2)]
        ms = float(np.mean(held))
        rec = dict(metric="K2_any_hit_ms", wavefront=tag, rays=n,
                   dead_lanes=n_dead, occluded=int((k[4] >= 0).sum()),
                   bitwise=equal, value=ms, runs=held, plain_ms=plain_ms,
                   mean_pops_per_ray=float(k[5].float().mean()),
                   max_pops=int(k[5].max()),
                   one_thread_per_ray_utilisation=lane_utilisation(k[5]),
                   **bd, **rd, share_of_bound=bd["bound_ms"] / ms, gpu=gpu)
        log(json.dumps(rec))
        if not equal:
            raise AssertionError(f"K2 any-hit {tag}: differs from "
                                 "traverse8_plain(any_hit=True)")
        out[b] = rec
    runs = [time_ms(r.step, 3, warm=1), time_ms(r.step, 3, warm=0)]
    prof = profile_one(r.step)
    log(json.dumps(dict(metric="mesh_nee_ms_per_iteration",
                        value=float(np.mean(runs)), runs=runs,
                        config="mesh.txt 1024x1024 depth 8 --nee "
                               "--stratified", gpu=gpu, **prof)))
    return dict(nee_launches=counts["k2"], any_hit_ms=out[0]["value"],
                any_hit_bound_ms=out[0]["bound_ms"],
                any_hit_bound_by=out[0]["bound_by"],
                any_hit_plain_ms=out[0]["plain_ms"],
                any_hit_launches=counts["k2_any_hit"],
                any_hit_bounce1_ms=out[1]["value"],
                any_hit_bounce1_bound_ms=out[1]["bound_ms"])


def nee_scene(path: str, res: int, depth: int, **settings):
    """`sized` with RenderSettings fields set (nee, nee_ris, restir, ...)."""
    scene = sized(path, res, depth)
    for k, v in settings.items():
        setattr(scene.settings, k, v)
    return scene


def channel_means(r, steps: int, keep_at: int = 0):
    """Step `r` `steps` times: the image's channel means of each step
    [steps, 3], and a copy of the accumulator after `keep_at` steps."""
    out, kept = [], None
    for i in range(steps):
        before = r.accum.double().mean(dim=(0, 1))
        r.step()
        out.append(r.accum.double().mean(dim=(0, 1)) - before)
        if i + 1 == keep_at:
            kept = r.accum.clone()
    return torch.stack(out).cpu().numpy(), kept


# The NEE image's channel means against K1's plain ones at 16 spp, on
# 800x800: both estimate the same transport at equal depth, and the
# standard error of a 16-spp mean over 640,000 pixels is a few 0.01% of it,
# so 1% leaves a wide margin for noise while a missing MIS weight or light
# (10% and more) fails.
NEE_MEAN_REL = 0.01
# The largest share of lanes on which the card and the CPU may disagree
# which shadow rays started inside a wall (F3, `f3_lanes`).
F3_FLIPS = 0.1
# RIS and ReSTIR image means against plain NEE's at equal spp (the JAX
# tests/test_ris.py:38 tolerance).
RIS_MEAN_ABS = 0.015


def nee_room(name: str, path: str, outdir: str, gpu: str) -> dict:
    """A primitive room at 800x800 depth 8 with --nee (stratified) through
    `Renderer`: the route, K1 held at 0 launches (NEE never renders through
    the megakernel), the channel means at 16 spp against K1's plain render,
    ms and kernels per iteration, the RMSE of the first 8 spp of each
    against a 1,024-spp K1 reference, and the card against the CPU at
    64x64 depth 8."""
    from project3_cuda_path_tracer_tpu_torch import Renderer
    zero_counts()
    r = Renderer(nee_scene(path, 800, 8, nee=True, stratified=True),
                 device="cuda")
    per_it, nee8 = channel_means(r, 16, keep_at=8)
    torch.cuda.synchronize()
    counts = {k: read_counts()[k] for k in ("k1", "k2")}
    if r.route != "wavefront" or not r.cfg.nee or any(counts.values()):
        raise AssertionError(f"{name} --nee: route {r.route}, nee "
                             f"{r.cfg.nee}, launches {counts}")
    png = r.save(os.path.join(outdir, f"{name}_nee_800x800_16spp"))
    zero_counts()
    plain = Renderer(sized(path, 800, 8), device="cuda")
    plain_it, plain8 = channel_means(plain, 16, keep_at=8)
    k1 = read_counts()["k1"]
    if plain.route != "megakernel" or k1 != 16:
        raise AssertionError(f"{name} plain: route {plain.route}, "
                             f"{k1} K1 launches")
    nee_m, plain_m = per_it.mean(0), plain_it.mean(0)
    rel = np.abs(nee_m - plain_m) / plain_m
    se = np.hypot(per_it.std(0), plain_it.std(0)) / 4.0
    rec = dict(check=f"{name} --nee 800x800 d8 16spp mean vs K1 plain",
               route=r.route, launches=counts, nee=nee_m.tolist(),
               plain=plain_m.tolist(), rel_gap=rel.tolist(),
               se_gap=se.tolist(), limit_rel=NEE_MEAN_REL, png=png)
    log(json.dumps(rec))
    if not np.isfinite(per_it).all() or (rel > NEE_MEAN_REL).any():
        raise AssertionError(f"{name} --nee mean {nee_m} vs plain {plain_m}")

    # RMSE of the first 8 spp of each against a 1,024-spp K1 reference
    # (another seed)
    ref = Renderer(nee_scene(path, 800, 8, seed=99), device="cuda")
    ref.render(1024)
    truth = ref.accum / 1024
    e_nee, e_plain = (float(((a / 8 - truth) ** 2).mean().sqrt())
                      for a in (nee8, plain8))
    runs = [time_ms(r.step, 4, warm=1), time_ms(r.step, 4, warm=0)]
    prof = profile_one(r.step)
    out = dict(metric=f"{name}_nee_ms_per_iteration",
               value=float(np.mean(runs)), runs=runs,
               config=f"{name}.txt 800x800 depth 8 --nee --stratified",
               rmse_8spp_nee=e_nee, rmse_8spp_plain=e_plain,
               rmse_ratio=e_nee / e_plain, reference="K1 1024 spp, seed 99",
               gpu=gpu, **prof)
    log(json.dumps(out))

    # Lanes where the two runs disagree which shadow rays started inside a
    # wall are F3's (`f3_lanes`), left out of the divergent share; at most
    # F3_FLIPS of them.
    small, f3 = [], []
    for dev in ("cuda", "cpu"):
        rs = Renderer(nee_scene(path, 64, 8, nee=True, stratified=True),
                      device=dev)
        with f3_lanes() as flags:
            small.append(rs.render(1).cpu())
        f3.append(torch.stack(flags))
    flips = (f3[0] != f3[1]).any(dim=0)
    rec = compare_lanes(f"{name} --nee 64x64 d8: card vs CPU", small[0],
                        small[1], ATOL, FRAC, exclude=flips)
    if rec["excluded_frac"] > F3_FLIPS:
        raise AssertionError(f"{name}: {rec['excluded_frac']} of lanes "
                             "flip a shadow ray's start inside a wall")
    return out


@contextlib.contextmanager
def f3_lanes():
    """Collects, while the integrator runs, one [N] bool tensor a shadow
    pass marking the live path slots whose shadow ray started inside a solid
    (it met a surface from within, less than 1e-3 from its origin). That is
    ROADMAP's F3: the back-off of 1e-4 object units is about one float32
    step of an object-space distance to cornell's 0.01-thick walls, so the
    hit point lands on either side of its wall by an ulp of rounding, which
    the card and the CPU (their rsqrt, sin, cos) need not share."""
    from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
    real, flags = wf.intersect_planar, []

    def spy(*args, **kwargs):
        hit = real(*args, **kwargs)
        if kwargs.get("any_hit"):
            flags.append(((hit.t > 0) & (hit.t < 1e-3) & ~hit.outside
                          & kwargs["alive"]).cpu())
        return hit
    wf.intersect_planar = spy
    try:
        yield flags
    finally:
        wf.intersect_planar = real


def nee_phases(outdir: str, gpu: str) -> None:
    """Direct lighting on the card: cornell and lights.txt with --nee
    (`nee_room`); manylights.txt 800x800 depth 5 with --nee-ris 8 and
    --restir 8 against --nee (image means, ms per iteration, the
    reservoir's M reaching its cap); manylights256.txt with --nee-ris 8
    through the batched sphere pass (ms and kernels per iteration); the CLI
    with --nee on cornell."""
    from project3_cuda_path_tracer_tpu_torch import Renderer
    for name, path in (("cornell", SCENE), ("lights", LIGHTS)):
        nee_room(name, path, outdir, gpu)

    spp = 20
    imgs, rs = {}, {}
    for mode, kw in (("nee", dict(nee=True)),
                     ("nee-ris 8", dict(nee=True, nee_ris=8)),
                     ("restir 8", dict(restir=8))):
        r = Renderer(nee_scene(MANY, 800, 5, seed=3, **kw), device="cuda")
        if r.route != "wavefront" or not r.cfg.nee \
                or len(r.cfg.sphere_batch) != 12:
            raise AssertionError(f"manylights {mode}: {r.cfg}")
        r.render(spp)
        imgs[mode], rs[mode] = r.image(), r
    m = rs["restir 8"].reservoir["M"]
    cap = rs["restir 8"].cfg.restir_cap * 8
    rec = dict(check="manylights 800x800 d5 20spp: RIS and ReSTIR vs NEE",
               means={k: float(v.mean()) for k, v in imgs.items()},
               limit_abs=RIS_MEAN_ABS, reservoir_m_max=float(m.max()),
               reservoir_cap=cap,
               reservoir_at_cap_share=float((m == cap).float().mean()))
    for mode in ("nee-ris 8", "restir 8"):
        rs_mode = rs[mode]
        runs = [time_ms(rs_mode.step, 3, warm=1),
                time_ms(rs_mode.step, 3, warm=0)]
        rec[f"{mode} ms_per_iteration"] = float(np.mean(runs))
        rec[f"{mode} runs"] = runs
    runs = [time_ms(rs["nee"].step, 3, warm=1)]
    rec["nee ms_per_iteration"] = runs[0]
    log(json.dumps(dict(rec, gpu=gpu)))
    for mode in ("nee-ris 8", "restir 8"):
        gap = abs(float(imgs[mode].mean()) - float(imgs["nee"].mean()))
        if not np.isfinite(imgs[mode]).all() or gap >= RIS_MEAN_ABS:
            raise AssertionError(f"manylights {mode}: mean gap {gap}")
    if float(m.max()) != cap or bool(((m % 8) != 0).any()):
        raise AssertionError(f"restir M max {float(m.max())}, cap {cap}")

    r = Renderer(nee_scene(MANY256, 800, 5, nee=True, nee_ris=8),
                 device="cuda")
    if len(r.cfg.sphere_batch) != 256 or len(r.cfg.nee_lights) != 256:
        raise AssertionError("manylights256: not every sphere batched")
    r.render(2)
    img = r.image()
    if not np.isfinite(img).all() or img.mean() <= 0:
        raise AssertionError("manylights256 image is not finite and > 0")
    runs = [time_ms(r.step, 3, warm=0), time_ms(r.step, 3, warm=0)]
    log(json.dumps(dict(metric="manylights256_ris8_ms_per_iteration",
                        value=float(np.mean(runs)), runs=runs,
                        config="manylights256.txt 800x800 depth 5 "
                               "--nee-ris 8 (256 spheres batched)",
                        mean=float(img.mean()), gpu=gpu,
                        **profile_one(r.step))))

    cli = subprocess.run(
        [sys.executable, "-m", PKG, SCENE, "--nee", "--stratified",
         "--iterations", "4", "--device", "cuda", "--metrics", "--outdir",
         outdir, "--out", "cornell_nee_cli_4spp"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if cli.returncode != 0 or "route=wavefront" not in cli.stderr:
        raise AssertionError(f"--nee CLI failed ({cli.returncode}):\n"
                             f"{cli.stderr}")
    metrics = json.loads(cli.stderr.strip().splitlines()[-1])
    if not os.path.exists(metrics["output"]):
        raise AssertionError("--nee CLI wrote no PNG")
    log(json.dumps(dict(phase="nee cli", **metrics)))


@contextlib.contextmanager
def capturing(module, name: str, keep, limit: int = 2):
    """Wraps `module.<name>` while the block runs: the first `limit` calls
    whose arguments `keep(*args, **kwargs)` accepts are recorded (their
    tensors cloned) in the yielded list; every call is passed on."""
    real, calls = getattr(module, name), []

    def spy(*args, **kwargs):
        if len(calls) < limit and keep(*args, **kwargs):
            calls.append(tuple(
                tuple(c.clone() for c in a) if isinstance(a, tuple)
                else a.clone() if isinstance(a, torch.Tensor) else a
                for a in args) + (
                {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in kwargs.items()},))
        return real(*args, **kwargs)
    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def zero_counts() -> None:
    """Every kernel's launch counts to 0."""
    from project3_cuda_path_tracer_tpu_torch.utils.launches import \
        zero_launch_counts
    zero_launch_counts()


def read_counts() -> dict:
    """The kernels' wrappers' launch counts (`utils.launches`)."""
    from project3_cuda_path_tracer_tpu_torch.utils.launches import \
        launch_counts
    return launch_counts()


# a count of `read_counts` -> the kernel's name in the profiler's records,
# as a whole identifier (not torch's vectorized_gather_kernel for P1's
# gather_kernel); K2's template arguments are <schedule, any-hit, stack>
KERNEL_NAMES = {"k1": r"(?<!\w)megakernel(?!\w)",
                "k2": r"(?<!\w)traverse8_kernel(?!\w)",
                "k2_any_hit": r"(?<!\w)traverse8_kernel<\d+, true",
                "k3_k4": r"(?<!\w)binary_kernel(?!\w)",
                "p1": r"(?<!\w)gather_kernel(?!\w)",
                "prim": r"(?<!\w)prim_hit_kernel(?!\w)",
                "shade": r"(?<!\w)shade_kernel(?!\w)",
                "shade_index": r"(?<!\w)shade_index_kernel(?!\w)"}


def named_launches(prof) -> dict:
    """Each kernel's launches (KERNEL_NAMES) in a torch.profiler run's
    records. Raises if it recorded no device activity."""
    events = [(ev.key, ev.count) for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise AssertionError("the profiler recorded no device activity")
    return {tag: sum(c for name, c in events if re.search(rx, name))
            for tag, rx in KERNEL_NAMES.items()}


def measured_launches(fn) -> dict:
    """Run `fn()` with every count set to 0 just before it, and return the
    launches that ran on the card: K2's, K3/K4's, P1's, I1's and S1's from
    the tallies the kernels themselves keep in device memory
    (`utils.launches.device_launches`), K1's from its wrapper (its route
    never replays a graph); under "wrappers", the wrappers' counts over
    the same run. Where `fn` replays a captured graph the two differ: a
    wrapper counts a launch where it enqueues one, which under the capture
    happens once without the kernel running, and a replay runs the
    captured launches with no wrapper call, while each launch that runs
    adds one to its kernel's tally."""
    from project3_cuda_path_tracer_tpu_torch.utils.launches import \
        device_launches
    torch.cuda.synchronize()
    zero_counts()
    fn()
    torch.cuda.synchronize()
    wrappers = read_counts()
    return dict(device_launches(), k1=wrappers["k1"], wrappers=wrappers)


def textured_copy(outdir: str, name: str, res: int, extra: str = "",
                  tag: str = "") -> str:
    """scenes/<name>.txt at res x res (its assets by absolute path) with
    `extra` scene text appended, written under outdir as
    <name>_<res><tag>.txt."""
    with open(os.path.join(ROOT, "scenes", name + ".txt")) as f:
        text = f.read()
    scenes = os.path.join(ROOT, "scenes")
    text = (text.replace("RES         2048 2048", f"RES         {res} {res}")
            .replace("assets/", os.path.join(scenes, "assets") + "/")
            .replace("meshes/", os.path.join(scenes, "meshes") + "/"))
    path = os.path.join(outdir, f"{name}_{res}{tag}.txt")
    with open(path, "w") as f:
        f.write(text + extra)
    return path


def textured_path(name: str, outdir: str, gpu: str) -> dict:
    """scenes/<name>.txt at its own 2048x2048 depth 8 through `Renderer`:
    one iteration with every count set to 0 just before it, which must take
    the wavefront route with one K2 launch a bounce, no other traversal and
    no K1, and P1 launches and S1's shade and index entries once a bounce
    on textured_env (none on the procedural twin, whose sky keeps the
    chain);
    the fused-table indices and the K2 rays of that iteration are
    captured; ms per iteration (CUDA events, two runs of 4 after the
    warm-up), the profiler's kernels and device busy share, and an 8-spp
    PNG."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
    from project3_cuda_path_tracer_tpu_torch.ops import texfetch
    r = Renderer(load_scene(os.path.join(ROOT, "scenes", name + ".txt")),
                 device="cuda")
    w, h = r.scene.camera.resolution
    depth = r.cfg.trace_depth
    fused = r.tables[3].fused_packed
    zero_counts()
    every = lambda *a, **k: True  # noqa: E731
    with capturing(texfetch, "take_u32", every, limit=64) as fetches, \
            capturing(P8, "traverse8", every) as waves:
        r.step()
    torch.cuda.synchronize()
    counts = read_counts()
    fused_fetches = sum(torch.equal(f[0], fused) for f in fetches)
    rec = dict(phase=f"{name} path", scene=f"scenes/{name}.txt",
               resolution=[w, h], depth=depth, iterations=1, route=r.route,
               fetches=len(fetches), fused_fetches=fused_fetches, **counts)
    log(json.dumps(rec))
    textured = name == "textured_env"
    if ((w, h, depth) != (2048, 2048, 8) or r.route != "wavefront"
            or counts["k2"] != depth
            or any(counts[k] for k in ("k1", "k2_any_hit", "k2_other",
                                       "k3_k4", "p1_ab"))
            or counts["p1"] != len(fetches)
            or (counts["p1"] > 0) != textured
            or (textured and fused_fetches != depth)
            or counts["shade"] != (depth if textured else 0)
            or counts["shade_index"] != (depth if textured else 0)):
        raise AssertionError(f"{name} path: {rec}")
    runs = [time_ms(r.step, 4, warm=1), time_ms(r.step, 4, warm=0)]
    prof = profile_one(r.step)
    r.reset()
    r.render(8)
    img = r.image()
    if not np.isfinite(img).all() or (img < 0).any() or img.mean() <= 0:
        raise AssertionError(f"{name} image is not finite and > 0")
    png = r.save(os.path.join(outdir, f"{name}_2048_8spp"))
    out = dict(metric=f"{name}_ms_per_iteration", value=float(np.mean(runs)),
               runs=runs, config=f"{name}.txt 2048x2048 depth 8",
               k2_launches=counts["k2"], gather_launches=counts["p1"],
               mean=float(img.mean()), png=png, gpu=gpu, **prof)
    log(json.dumps(out))
    return dict(ms=out["value"], counts=counts, fetches=fetches[:2],
                waves=waves, packed=r.packed_meshes[0])


def p1_on_path(gpu: str, fetches: list) -> dict:
    """P1 on the texture path's own inputs, the fused-table indices of
    bounce 0 and bounce 1: bit for bit against gather_plain, timed held
    (stream held, 20 calls) and cold (each call after a 128 MB write)
    beside torch.take on the same indices and the plain version, with its
    bound: (8 N + the table's bytes) / the HBM rate. Returns bounce 0's
    numbers and both bounces' records."""
    from project3_cuda_path_tracer_tpu_torch.ops import texfetch as P1
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        time_cold_ms
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        time_ms as held_ms
    recs = []
    for b, (table, idx, _) in enumerate(fetches):
        got = P1.gather(table, idx)
        want = P1.gather_plain(table, idx)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        idx64 = idx.long()
        fns = dict(p1=lambda: P1.gather(table, idx),
                   torch_take=lambda: torch.take(table, idx64))
        warm = {k: [] for k in fns}
        cold = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            warm[k].append(held_ms(fns[k], 20, warm=3))
            cold[k].append(float(np.median(time_cold_ms(fns[k], 10))))
        plain = held_ms(lambda: P1.gather_plain(table, idx), 20, warm=3)
        bd = bound(idx.numel() * 8 + table.numel() * 4, 0)
        ms, cold_ms = float(np.mean(warm["p1"])), float(np.mean(cold["p1"]))
        rec = dict(metric="P1_path_ms", wavefront=f"bounce {b}",
                   fetches=idx.numel(), table_bytes=table.numel() * 4,
                   instance=P1.INSTANCES[P1.instance_for(table.numel() * 4)],
                   bitwise=equal, value=ms, runs=warm["p1"], cold_ms=cold_ms,
                   cold_runs=cold["p1"], plain_ms=plain,
                   library_ms=float(np.mean(warm["torch_take"])),
                   library_cold_ms=float(np.mean(cold["torch_take"])),
                   share_of_bound=bd["bound_ms"] / ms,
                   cold_share_of_bound=bd["bound_ms"] / cold_ms,
                   env_lanes=int((idx >= 512 * 512).sum()), **bd, gpu=gpu)
        log(json.dumps(rec))
        if not equal:
            raise AssertionError(f"P1 bounce {b}: differs from gather_plain")
        recs.append(rec)
    return recs


def k2_torus(gpu: str, packed, waves: list, any_hit: bool) -> list:
    """K2 on the torus's captured bounce-0 and bounce-1 wavefronts (`waves`,
    the renderer's traverse8 calls), nearest or any hit: bit for bit
    against traverse8_plain, pops included, and timed held."""
    from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        time_ms as held_ms
    recs = []
    for b, (qo, qd, _, kw) in enumerate(waves):
        tb = kw["t_bound"]
        k = P8.traverse8(qo, qd, packed, t_bound=tb, any_hit=any_hit,
                         return_pops=True)
        p = P8.traverse8_plain(qo, qd, packed, t_bound=tb, any_hit=any_hit)
        torch.cuda.synchronize()
        equal = same_bits(k, p)
        ms = held_ms(lambda: P8._launch("persistent", qo, qd, packed, tb,
                                        any_hit=any_hit), 20, warm=3)
        rec = dict(check=f"K2 torus {'any-hit' if any_hit else 'nearest'} "
                         f"bounce {b} vs traverse8_plain", bitwise=equal,
                   rays=int(tb.numel()), live=int((tb > 0).sum()),
                   hits=int((k[4] >= 0).sum()),
                   mean_pops=float(k[5].float().mean()),
                   max_pops=int(k[5].max()), held_ms=ms, gpu=gpu)
        log(json.dumps(rec))
        if not equal:
            raise AssertionError(rec["check"] + ": differs")
        recs.append(rec)
    return recs


# The emissive sphere of the mixed-mode copy of textured_env (the one of
# tests/test_torch_envnee.py).
EMITTER = """
MATERIAL 4
RGB 1 .9 .8
EMITTANCE 6

OBJECT 4
sphere
material 4
TRANS 1.5 4 3
ROTAT 0 0 0
SCALE 1 1 1
"""

# Image means of the filtering modes at 16 spp: --bilinear against nearest
# within 0.03 (tests/test_bilinear.py::test_bilinear_render_smoke) and
# --bilinear-fast against --bilinear within 0.02
# (::test_bilinear_fast_render_matches_exact), the pairs that file bounds.
BILINEAR_MEAN, FAST_MEAN = 0.03, 0.02


def bilinear_modes(gpu: str) -> dict:
    """textured_env at 2048x2048 depth 8 in each filtering mode: 16 spp
    each from one seed, the image means compared as tests/test_bilinear.py
    bounds them, and ms per iteration."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    out = {}
    for mode, kw in (("nearest", {}), ("bilinear", dict(bilinear=True)),
                     ("bilinear_fast", dict(bilinear=True,
                                            bilinear_fast=True))):
        scene = load_scene(os.path.join(ROOT, "scenes", "textured_env.txt"))
        for k, v in kw.items():
            setattr(scene.settings, k, v)
        r = Renderer(scene, device="cuda")
        r.render(16)
        mean = float(r.image().mean())
        runs = [time_ms(r.step, 4, warm=0), time_ms(r.step, 4, warm=0)]
        out[mode] = dict(mean=mean, ms=float(np.mean(runs)), runs=runs)
        del r
    gaps = dict(bilinear_vs_nearest=abs(out["bilinear"]["mean"]
                                        - out["nearest"]["mean"]),
                fast_vs_bilinear=abs(out["bilinear_fast"]["mean"]
                                     - out["bilinear"]["mean"]),
                fast_vs_nearest=abs(out["bilinear_fast"]["mean"]
                                    - out["nearest"]["mean"]))
    log(json.dumps(dict(check="textured_env 2048x2048 d8 16spp: filtering "
                              "modes", **out, **gaps,
                        limits=dict(bilinear_vs_nearest=BILINEAR_MEAN,
                                    fast_vs_bilinear=FAST_MEAN), gpu=gpu)))
    if (gaps["bilinear_vs_nearest"] >= BILINEAR_MEAN
            or gaps["fast_vs_bilinear"] >= FAST_MEAN):
        raise AssertionError(f"filtering modes' means: {gaps}")
    return out


def env_nee(outdir: str, gpu: str) -> dict:
    """Env-map NEE on textured_env at 512x512 depth 8 (stratified): the
    16-spp image mean within 1% of the plain render's (and the gap in
    standard errors of the per-iteration means), the 8-spp RMSE of each
    against a 256-spp plain reference of another seed, ms per iteration;
    K2's any-hit mode bit for bit on the bounce-0 and bounce-1 env shadow
    rays (unbounded occlusion queries). Then the mixed mode once, on a copy
    with an emissive sphere: its 16-spp mean against the plain render's
    within 1%."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
    path = textured_copy(outdir, "textured_env", 512)
    lit = textured_copy(outdir, "textured_env", 512, EMITTER, "_lit")
    recs = {}
    for mode, scene_path in (("env", path), ("mixed", lit)):
        nee_s = load_scene(scene_path)
        nee_s.settings.nee = nee_s.settings.stratified = True
        r = Renderer(nee_s, device="cuda")
        if r.route != "wavefront" or not r.cfg.nee_env or (
                (r.cfg.nee_q == 0.0) != (mode == "env")):
            raise AssertionError(f"{mode} NEE wiring: {r.cfg}")
        zero_counts()
        with capturing(P8, "traverse8",
                       lambda *a, **k: k.get("any_hit", False)) as shadows:
            per_it, nee8 = channel_means(r, 16, keep_at=8)
        counts = read_counts()
        plain_s = load_scene(scene_path)
        plain_s.settings.stratified = True
        plain = Renderer(plain_s, device="cuda")
        plain_it, plain8 = channel_means(plain, 16, keep_at=8)
        nee_m, plain_m = per_it.mean(0), plain_it.mean(0)
        rel = np.abs(nee_m - plain_m) / plain_m
        se = np.hypot(per_it.std(0), plain_it.std(0)) / 4.0
        rec = dict(check=f"textured_env {mode} --nee 512x512 d8 16spp mean "
                         "vs plain", nee=nee_m.tolist(),
                   plain=plain_m.tolist(), rel_gap=rel.tolist(),
                   gap_in_se=(np.abs(nee_m - plain_m) / se).tolist(),
                   limit_rel=NEE_MEAN_REL, nee_q=r.cfg.nee_q,
                   launches_16_iterations=counts, gpu=gpu)
        if mode == "env":
            ref_s = load_scene(path)
            ref_s.settings.seed = 99
            ref = Renderer(ref_s, device="cuda")
            ref.render(256)
            truth = ref.accum / 256
            e_nee, e_plain = (float(((a / 8 - truth) ** 2).mean().sqrt())
                              for a in (nee8, plain8))
            runs = [time_ms(r.step, 4, warm=1), time_ms(r.step, 4, warm=0)]
            rec.update(rmse_8spp_nee=e_nee, rmse_8spp_plain=e_plain,
                       rmse_ratio=e_nee / e_plain,
                       reference="plain 256 spp, seed 99",
                       ms_per_iteration=float(np.mean(runs)), runs=runs,
                       **profile_one(r.step))
            r.save(os.path.join(outdir, "textured_env_nee_512_16spp"))
        log(json.dumps(rec))
        if not np.isfinite(per_it).all() or (rel > NEE_MEAN_REL).any():
            raise AssertionError(f"{mode} --nee mean {nee_m} vs plain "
                                 f"{plain_m}")
        if counts["k2_any_hit"] == 0 or counts["p1"] == 0:
            raise AssertionError(f"{mode} --nee launches {counts}")
        recs[mode] = dict(rec, shadows=shadows[:2], packed=r.packed_meshes[0])
    return recs


def card_vs_cpu(gpu: str) -> None:
    """textured_env and textured_env_proc at 64x64 depth 8, one stratified
    iteration on the card and on the CPU: at most 1% of the lanes
    diverge."""
    from project3_cuda_path_tracer_tpu_torch import Renderer
    for name in ("textured_env", "textured_env_proc"):
        imgs = []
        for dev in ("cuda", "cpu"):
            scene = sized(os.path.join(ROOT, "scenes", name + ".txt"), 64, 8)
            scene.settings.stratified = True
            imgs.append(Renderer(scene, device=dev).render(1).cpu())
        compare_lanes(f"{name} 64x64 d8: card vs CPU", imgs[0], imgs[1],
                      ATOL, FRAC)


def textured_phases(outdir: str, gpu: str) -> dict:
    """Slice D on the card: textured_env and textured_env_proc at their own
    2048x2048 depth 8 (`textured_path`); P1 on the path's bounce-0 and
    bounce-1 fused-table indices (`p1_on_path`); K2 on the torus, nearest
    on the main path's bounce-0/1 rays and any-hit on env NEE's bounce-0/1
    shadow rays (`k2_torus`); the filtering modes (`bilinear_modes`); env
    and mixed NEE (`env_nee`); the card against the CPU (`card_vs_cpu`).
    Returns P1's path numbers for the `kernels` line."""
    main = textured_path("textured_env", outdir, gpu)
    proc = textured_path("textured_env_proc", outdir, gpu)
    p1 = p1_on_path(gpu, main["fetches"])
    k2 = k2_torus(gpu, main["packed"], main["waves"], any_hit=False)
    modes = bilinear_modes(gpu)
    nee = env_nee(outdir, gpu)
    k2_any = k2_torus(gpu, nee["env"]["packed"], nee["env"]["shadows"],
                      any_hit=True)
    card_vs_cpu(gpu)
    log(json.dumps(dict(metric="textured_summary_ms_per_iteration",
                        textured_env=main["ms"], textured_env_proc=proc["ms"],
                        **{m: v["ms"] for m, v in modes.items()},
                        env_nee_512=nee["env"]["ms_per_iteration"],
                        k2_torus_nearest_ms=[k["held_ms"] for k in k2],
                        k2_torus_any_hit_ms=[k["held_ms"] for k in k2_any],
                        gpu=gpu)))
    return dict(p1=p1, launches=main["counts"]["p1"],
                k2_launches=main["counts"]["k2"] + proc["counts"]["k2"])


def traversal_bounds(gpu: str, p8, pb, waves: dict) -> dict:
    """(kernel, wavefront) -> the traversal's bound: each live ray's 7
    input floats (origin, direction, t_bound) and 7 output words (t,
    normal, uv, tri); each dead lane's (!(t_bound > 0)) bound in and 7
    words out, which is all its miss record needs; and what the live rays
    read of the tree, once (the rows the plain traversals read), with the
    slab and triangle tests they make. K2 and K3 on both wavefronts; K4's
    is K3's, since each of its lanes visits and tests exactly what its K3
    walk does."""
    from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
    from project3_cuda_path_tracer_tpu_torch.ops import pallas_bvh as PB
    out = {}
    for kid, tag, node_bytes, box_tests in (
            ("K2", "bounce-0", NODE8_BYTES, 8),
            ("K2", "bounce-1", NODE8_BYTES, 8),
            ("K3", "bounce-0", NODE2_BYTES, 1),
            ("K3", "bounce-1", NODE2_BYTES, 1)):
        qo, qd, tb = waves[tag]
        n = int(qo[0].shape[0])
        live = tb > 0
        n_dead = n - int(live.sum())
        lo, ld = tuple(c[live] for c in qo), tuple(c[live] for c in qd)
        if kid == "K2":
            rd = tree_reads(lambda p: P8.traverse8_plain(lo, ld, p, tb[live]),
                            p8, "nodes")
        else:
            rd = tree_reads(
                lambda p: PB.traverse_binary_plain(lo, ld, p, tb[live]), pb,
                "nodes_f")
        out[(kid, tag)] = dict(bound(
            (n - n_dead) * (7 + 7) * 4 + n_dead * (1 + 7) * 4
            + rd["node_rows"] * node_bytes
            + rd["tri_rows"] * TRI_TEST_BYTES
            + rd["hit_tris"] * TRI_HIT_BYTES,
            rd["node_visits"] * box_tests * BOX_OPS
            + rd["tri_tests"] * TRI_OPS), **rd)
        log(json.dumps(dict(metric=f"{kid}_bound", wavefront=tag, rays=n,
                            dead_lanes=n_dead, **out[(kid, tag)], gpu=gpu)))
        if kid == "K3":
            out[("K4", tag)] = out[(kid, tag)]
            log(json.dumps(dict(metric="K4_bound", wavefront=tag, rays=n,
                                dead_lanes=n_dead, same_as="K3_bound",
                                **out[(kid, tag)], gpu=gpu)))
    return out


def k2_timing(gpu: str, p8, waves: dict, util: dict, mean_pops: dict,
              bounds: dict) -> dict:
    """Phase 8d for K2 on each wavefront: each schedule's busy lane share
    and deepest stack (one counted launch each), then plain, persistent,
    grid, grid, persistent, plain, each schedule's turn timed twice: by its
    kernel (the stream held while the host enqueues, utils/device.time_ms)
    and with its host side (no hold); every instance's registers, spills,
    local memory and global loads in the SASS; the floors (all lanes dead,
    every ray one pop). Returns {(schedule,
    wavefront): (held ms, unheld ms)} and {("plain", wavefront): ms}."""
    from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
    from project3_cuda_path_tracer_tpu_torch.utils import cuda_build
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        time_ms as device_ms
    dev = torch.device("cuda")
    lib = cuda_build.library_path("bvh8")
    spills = ptxas_report(lib + ".log", K2_MANGLED, k2_instance)
    loads = sass_counts(lib, K2_MANGLED, k2_instance, "LDG|LDL|STL|LDS|STS")
    instances = []
    for rec in P8.kernel_attributes(dev):
        key = (rec["instance"], rec["any_hit"])
        sass = loads.get(key, {})
        ldg = {k: v for k, v in sass.items() if k.startswith("LDG")}
        instances.append(dict(
            rec, **spills.get(key, {}), sass_loads=sass or "not measured",
            ldg_128=sum(v for k, v in ldg.items() if ".128" in k),
            ldg_scalar=sum(v for k, v in ldg.items()
                           if ".64" not in k and ".128" not in k)))
    log(json.dumps(dict(k2_instances=instances, gpu=gpu)))
    if any(r.get("spill_store_bytes", 1) or r.get("spill_load_bytes", 1)
           for r in instances):
        raise AssertionError("a K2 instance spills (or ptxas gave no report)")
    main = {r["instance"]: r for r in instances if not r["any_hit"]}
    out = {}
    for tag, (qo, qd, tb) in waves.items():
        n = int(qo[0].shape[0])

        def launch(sched, stats=None):
            return lambda: P8._launch(sched, qo, qd, p8, tb, stats=stats)

        def plain():
            P8.traverse8_plain(qo, qd, p8, t_bound=tb)

        lanes = {}
        for sched in ("persistent", "grid"):
            st = torch.zeros((3,), dtype=torch.int64, device=dev)
            launch(sched, st)()
            torch.cuda.synchronize()
            lanes[sched] = [int(v) for v in st.cpu()]
        plain_ms = [time_ms(plain, 1, warm=1)]
        held = {"persistent": [], "grid": []}
        unheld = {"persistent": [], "grid": []}
        for sched in ("persistent", "grid", "grid", "persistent"):
            held[sched].append(device_ms(launch(sched), 20, warm=3))
            unheld[sched].append(time_ms(launch(sched), 20))
        plain_ms.append(time_ms(plain, 1, warm=0))
        out[("plain", tag)] = float(np.mean(plain_ms))
        b = bounds[("K2", tag)]
        for sched in ("persistent", "grid"):
            ms = float(np.mean(held[sched]))
            out[(sched, tag)] = (ms, float(np.mean(unheld[sched])))
            inst = main[sched]
            log(json.dumps(dict(
                metric="K2_traversal_ms", schedule=sched, wavefront=tag,
                rays=n, value=ms, runs=held[sched],
                unheld_ms=out[(sched, tag)][1], unheld_runs=unheld[sched],
                plain_ms=out[("plain", tag)], plain_runs=plain_ms,
                busy_lane_slots=lanes[sched][0], lane_slots=lanes[sched][1],
                busy_lane_share=lanes[sched][0] / max(lanes[sched][1], 1),
                deepest_stack=lanes[sched][2],
                one_thread_per_ray_utilisation=util[tag],
                mean_pops_per_ray=mean_pops[tag],
                registers=inst["registers"],
                spill_store_bytes=inst.get("spill_store_bytes"),
                local_bytes=inst["local_bytes"],
                blocks_per_sm=inst["blocks_per_sm"],
                ldg_128=inst["ldg_128"], ldg_scalar=inst["ldg_scalar"],
                bound_ms=b["bound_ms"], share_of_bound=b["bound_ms"] / ms,
                gpu=gpu)))
    # What a ray costs before any descent: the bounce-0 rays all dead (the
    # bound read, the record written) and reversed (each pops the root
    # only), each schedule timed held in turns.
    qo, qd, tb = waves["bounce-0"]
    for case, (o, d, t) in (("all dead", (qo, qd, torch.full_like(tb, -1.0))),
                            ("reversed", (qo, tuple(-c for c in qd), tb))):
        pops = P8.traverse8(o, d, p8, t_bound=t, return_pops=True)[5]
        rec = dict(metric="K2_floor_ms", case=case, rays=int(pops.numel()),
                   one_pop_share=float((pops == 1).float().mean()))
        for sched in ("persistent", "grid", "grid", "persistent"):
            rec.setdefault(sched, []).append(device_ms(
                lambda: P8._launch(sched, o, d, p8, t), 20, warm=3))
        log(json.dumps(dict(rec, gpu=gpu)))
    return out


def mesh_bounces(r, module, wrapper: str) -> list:
    """The inputs (qo, qd, t_bound) of every traversal launch that one
    iteration of the mesh renderer `r` makes, one a bounce, copied as the
    renderer passed them to `module.<wrapper>` (bvh8.traverse8 for K2,
    pallas_bvh.traverse for K3)."""
    kernel, waves = getattr(module, wrapper), []

    def capture(qo, qd, packed, t_bound=None, **kwargs):
        waves.append((tuple(c.clone() for c in qo),
                      tuple(c.clone() for c in qd), t_bound.clone()))
        return kernel(qo, qd, packed, t_bound=t_bound, **kwargs)

    setattr(module, wrapper, capture)
    try:
        r.step()
    finally:
        setattr(module, wrapper, kernel)
    torch.cuda.synchronize()
    if len(waves) != r.cfg.trace_depth:
        raise AssertionError(f"one mesh iteration made {len(waves)} "
                             f"{wrapper} launches (want {r.cfg.trace_depth})")
    return waves


def k2_bounces(gpu: str, p8, bounces: list) -> None:
    """K2's two schedules on the wavefront of every bounce of one mesh.txt
    iteration (the renderer's launches): the schedules bit for bit, each
    one's busy lane share, the dead share, mean pops and the
    one-thread-per-ray utilisation (from the kernel's pops), then
    persistent, grid, grid, persistent timed with the stream held; and the
    sums over the iteration."""
    from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        time_ms as device_ms
    dev = torch.device("cuda")
    total = {"persistent": 0.0, "grid": 0.0}
    for b, (qo, qd, tb) in enumerate(bounces):
        res, lanes = {}, {}
        for sched in ("persistent", "grid"):
            st = torch.zeros((3,), dtype=torch.int64, device=dev)
            res[sched] = P8._launch(sched, qo, qd, p8, tb, return_pops=True,
                                    stats=st)
            torch.cuda.synchronize()
            lanes[sched] = [int(v) for v in st.cpu()]
        if not same_bits(res["persistent"], res["grid"]):
            raise AssertionError(f"K2 bounce {b}: the schedules differ")
        held = {"persistent": [], "grid": []}
        for sched in ("persistent", "grid", "grid", "persistent"):
            held[sched].append(device_ms(
                lambda: P8._launch(sched, qo, qd, p8, tb), 20, warm=3))
        pops = res["persistent"][5]
        rec = dict(metric="K2_bounce_ms", bounce=b, rays=int(pops.numel()),
                   bitwise=True,
                   dead_share=float((~(tb > 0)).float().mean()),
                   mean_pops_per_ray=float(pops.float().mean()),
                   max_pops=int(pops.max()),
                   one_thread_per_ray_utilisation=lane_utilisation(pops))
        for sched in ("persistent", "grid"):
            ms = float(np.mean(held[sched]))
            total[sched] += ms
            rec.update({f"{sched}_ms": ms, f"{sched}_runs": held[sched],
                        f"{sched}_busy_lane_share":
                            lanes[sched][0] / max(lanes[sched][1], 1)})
        log(json.dumps(dict(rec, gpu=gpu)))
    log(json.dumps(dict(metric="K2_iteration_ms", bounces=len(bounces),
                        persistent_ms=total["persistent"],
                        grid_ms=total["grid"],
                        config="mesh.txt 1024x1024 depth 8, one iteration's "
                               "K2 launches, each held", gpu=gpu)))


# A K3/K4 instance's mangled name: binary_kernel<SCHED> (SCHED 1 grid, 2
# packet).
K34_MANGLED = re.compile(r"binary_kernelILi(\d)E")


def k34_instance(m: re.Match) -> str:
    """The instance of a K34_MANGLED match, as `pallas_bvh.INSTANCES`
    names it."""
    from project3_cuda_path_tracer_tpu_torch.ops import pallas_bvh as PB
    return {v: k for k, v in PB.INSTANCES.items()}[int(m.group(1))]


def k34_lanes(pb, qo, qd, tb) -> dict:
    """name -> (busy, total) lane slots of the steps of one counted launch
    of every instance of K34_INSTANCES on these rays."""
    from project3_cuda_path_tracer_tpu_torch.ops import pallas_bvh as PB
    dev = torch.device("cuda")
    lanes = {}
    for name, inst in K34_INSTANCES:
        st = torch.zeros((2,), dtype=torch.int64, device=dev)
        PB._launch(inst, qo, qd, pb, tb, stats=st)
        torch.cuda.synchronize()
        lanes[name] = [int(v) for v in st.cpu()]
    return lanes


def k34_held(pb, qo, qd, tb, iters: int = 20) -> dict:
    """name -> held ms of each instance of K34_INSTANCES on these rays,
    timed in turns (each instance twice, in order then reversed)."""
    from project3_cuda_path_tracer_tpu_torch.ops import pallas_bvh as PB
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        time_ms as device_ms
    held = {name: [] for name, _ in K34_INSTANCES}
    for name, inst in K34_INSTANCES + K34_INSTANCES[::-1]:
        held[name].append(device_ms(
            lambda: PB._launch(inst, qo, qd, pb, tb), iters, warm=3))
    return held


def binary_timing(gpu: str, pb, waves: dict, bounds: dict) -> dict:
    """Phase 8d for K3 and K4 on each wavefront: every instance's busy lane
    share (one counted launch each), then plain, the instances in turns
    (each timed held, and once more with its host side), plain; every
    instance's registers, spills and local memory; the floors (every ray
    dead, every ray one step). Returns {(instance name, wavefront): (held
    ms, unheld ms)} and {("plain", wavefront): ms}."""
    from project3_cuda_path_tracer_tpu_torch.ops import pallas_bvh as PB
    from project3_cuda_path_tracer_tpu_torch.utils import cuda_build
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        time_ms as device_ms
    dev = torch.device("cuda")
    lib = cuda_build.library_path("bvh_binary")
    spills = ptxas_report(lib + ".log", K34_MANGLED, k34_instance)
    instances = [dict(rec, **spills.get(rec["instance"], {}))
                 for rec in PB.kernel_attributes(dev)]
    log(json.dumps(dict(k34_instances=instances, gpu=gpu)))
    if any(r.get("spill_store_bytes", 1) or r.get("spill_load_bytes", 1)
           for r in instances):
        raise AssertionError("a K3/K4 instance spills (or ptxas gave no "
                             "report)")
    attrs = {r["instance"]: r for r in instances}
    out = {}
    for tag, (qo, qd, tb) in waves.items():
        steps = PB._launch("grid", qo, qd, pb, tb, True)[5]
        lanes = k34_lanes(pb, qo, qd, tb)

        def plain():
            PB.traverse_binary_plain(qo, qd, pb, t_bound=tb)

        plain_ms = [time_ms(plain, 1, warm=1)]
        held = k34_held(pb, qo, qd, tb)
        plain_ms.append(time_ms(plain, 1, warm=0))
        out[("plain", tag)] = float(np.mean(plain_ms))
        for name, inst in K34_INSTANCES:
            unheld = time_ms(lambda: PB._launch(inst, qo, qd, pb, tb), 20)
            ms = float(np.mean(held[name]))
            out[(name, tag)] = (ms, unheld)
            a = attrs[inst]
            b = bounds[(name[:2], tag)]
            log(json.dumps(dict(
                metric=f"{name[:2]}_traversal_ms", instance=name,
                wavefront=tag, rays=int(qo[0].shape[0]), value=ms,
                runs=held[name], unheld_ms=unheld,
                plain_ms=out[("plain", tag)], plain_runs=plain_ms,
                busy_lane_slots=lanes[name][0], lane_slots=lanes[name][1],
                busy_lane_share=lanes[name][0] / max(lanes[name][1], 1),
                one_thread_per_ray_utilisation=lane_utilisation(steps),
                mean_steps_per_ray=float(steps.float().mean()),
                max_steps=int(steps.max()), registers=a["registers"],
                spill_store_bytes=a.get("spill_store_bytes"),
                local_bytes=a["local_bytes"],
                blocks_per_sm=a["blocks_per_sm"], bound_ms=b["bound_ms"],
                share_of_bound=b["bound_ms"] / ms, gpu=gpu)))
    # What a ray costs before any descent: the bounce-0 rays all dead (the
    # bound read, the record written) and reversed (each visits the root
    # only), every instance held in turns.
    qo, qd, tb = waves["bounce-0"]
    for case, (o, d, t) in (("all dead", (qo, qd, torch.full_like(tb, -1.0))),
                            ("reversed", (qo, tuple(-c for c in qd), tb))):
        steps = PB._launch("grid", o, d, pb, t, True)[5]
        held = k34_held(pb, o, d, t)
        log(json.dumps(dict(metric="K3_floor_ms", case=case,
                            rays=int(steps.numel()),
                            one_step_share=float((steps == 1).float().mean()),
                            **{name: v for name, v in held.items()},
                            gpu=gpu)))
    return out


def k3_bounces(gpu: str, pb, bounces: list) -> None:
    """K3 and K4 on the wavefront of every bounce of one `pack_all`
    iteration of mesh.txt (the renderer's 8 K3 launches): every instance
    bit for bit against the route's, steps included; the dead share, mean
    and max steps, the one-thread-per-ray utilisation (from the steps);
    each instance's busy lane share and its held time (in turns); and the
    sums over the iteration."""
    from project3_cuda_path_tracer_tpu_torch.ops import pallas_bvh as PB
    names = [name for name, _ in K34_INSTANCES]
    total = dict.fromkeys(names, 0.0)
    for b, (qo, qd, tb) in enumerate(bounces):
        res = {name: PB._launch(inst, qo, qd, pb, tb, True)
               for name, inst in K34_INSTANCES}
        torch.cuda.synchronize()
        route = res[names[0]]
        for name, other in res.items():
            if not same_bits(route, other):
                raise AssertionError(f"K3 bounce {b}: {name} differs from "
                                     "the route's instance")
        lanes = k34_lanes(pb, qo, qd, tb)
        held = k34_held(pb, qo, qd, tb)
        steps = route[5]
        rec = dict(metric="K3_bounce_ms", bounce=b, rays=int(steps.numel()),
                   bitwise=True,
                   dead_share=float((~(tb > 0)).float().mean()),
                   mean_steps_per_ray=float(steps.float().mean()),
                   max_steps=int(steps.max()),
                   one_thread_per_ray_utilisation=lane_utilisation(steps))
        for name in names:
            ms = float(np.mean(held[name]))
            total[name] += ms
            rec[name] = dict(ms=ms, runs=held[name],
                             busy_lane_share=lanes[name][0]
                             / max(lanes[name][1], 1))
        log(json.dumps(dict(rec, gpu=gpu)))
    log(json.dumps(dict(metric="K3_iteration_ms", bounces=len(bounces),
                        **{f"{name} ms": v for name, v in total.items()},
                        config="mesh.txt 1024x1024 depth 8, pack_all, one "
                               "iteration's K3 launches, each held",
                        gpu=gpu)))


def mesh_train(scene) -> None:
    """The train step on mesh.txt at 32x32, depth 3: InverseRenderer turns
    the differentiable recompute on, so each bounce runs K2 for the winning
    triangle and then Moller-Trumbore in torch ops, and checkpoints each
    bounce (remat), so a differentiated bounce runs K2 again in the
    backward. Counts at 0 before, read after: K2 ran, K1 did not.

    The target is a flat grey, so the residual is non-zero on every pixel.
    The blob covers ~5% of the view, and a path that leaves it reaches the
    light on few of 1,024 lanes, so one render's gradient on the mesh's
    albedo can be 0 (CPU runs at 32x32 found that on one of four
    iterations): the check sums the gradients of four stratified
    iterations."""
    from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
    small = dataclasses.replace(
        scene, camera=copy.deepcopy(scene.camera),
        settings=dataclasses.replace(scene.settings, trace_depth=3))
    small.camera.resolution = (32, 32)
    small.camera.derive()
    zero_counts()
    ir = PInv.InverseRenderer(small, np.full((32, 32, 3), 0.5, np.float32),
                              device="cuda")
    losses = [ir.step(), ir.step()]
    cfg = dataclasses.replace(ir.cfg, stratified=True)
    leaves = PInv.param_leaves(ir.params)
    grads = [torch.zeros_like(p) for p in leaves]
    for it in range(4):
        loss, _ = PInv.history_residual_grad_loss(
            ir.params, *ir.tables, None, cfg, ir.target, ir.hist,
            ir.packed_meshes, iteration=it)
        for acc, g in zip(grads, torch.autograd.grad(loss, leaves,
                                                     allow_unused=True)):
            if g is not None:
                acc += g
    torch.cuda.synchronize()
    k2, k1 = read_counts()["k2"], read_counts()["k1"]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    mesh_albedo = float(grads[0][2].abs().max())
    log(json.dumps(dict(phase="mesh train", resolution=[32, 32], depth=3,
                        differentiable_mesh=ir.cfg.differentiable_mesh,
                        losses=losses, k2_launches=k2, k1_launches=k1,
                        grads_finite=finite,
                        mesh_albedo_grad_max=mesh_albedo)))
    # a seed render (3 bounces), then two steps and four gradients: six
    # differentiated renders whose 3 bounces each walk twice (remat, the
    # rule on mesh scenes: once forward, once in the backward's recompute)
    want = 3 + 6 * 3 * (2 if ir.cfg.remat else 1)
    if not (ir.cfg.differentiable_mesh and ir.cfg.remat and k2 == want
            and k1 == 0):
        raise AssertionError(f"mesh train: K2 launched {k2} times (want "
                             f"{want}), K1 {k1}")
    if not (finite and np.isfinite(losses).all() and mesh_albedo > 0):
        raise AssertionError("mesh train: gradients not finite and non-zero")


def grads_card_vs_cpu(scene, tag: str, cfg, nonzero_leaf=None) -> dict:
    """The history loss's gradients on the card against the CPU's, on
    `scene` under `cfg` (stratified draws: the same trace on both
    devices), iteration 3. As in tests/test_torch_inverse.py, lanes that
    diverge at a decision threshold (transcendentals differ by ulps between
    the two devices) are found from the images, at most FRAC of them, and
    get no weight; the rest agree to rtol 1e-3 (the backward of the
    material gather sums its lanes in another order on the card). The
    textures are fused and the meshes packed as the InverseRenderer holds
    them. The gradient of leaf `nonzero_leaf` (of any leaf, if None) must
    be non-zero."""
    from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
    from project3_cuda_path_tracer_tpu_torch.ops import texfetch
    from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
    w, h = scene.camera.resolution
    rng = np.random.default_rng(0)
    tgt = rng.random((h, w, 3), dtype=np.float32) * 0.5
    resid = rng.random((h, w, 3), dtype=np.float32)

    def grads(dev, res):
        params = PInv.params_from_scene(scene, dev)
        loss, img = PInv.history_residual_grad_loss(
            params, PI.to_device(scene.geoms, dev),
            PI.to_device(scene.meshes, dev),
            texfetch.fuse(PI.to_device(scene.textures, dev)), None, cfg,
            torch.from_numpy(tgt).to(dev), torch.from_numpy(res).to(dev),
            tuple(PI.to_device(p, dev) for p in scene.packed_meshes),
            iteration=3)
        leaves = PInv.param_leaves(params)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        return (img.detach().cpu().numpy(), float(loss.detach()),
                [torch.zeros_like(p).cpu() if x is None else x.cpu()
                 for p, x in zip(leaves, g)])

    img_c = grads("cpu", resid)[0]
    img_g = grads("cuda", resid)[0]
    diverged = (np.abs(img_c - img_g) > ATOL).any(axis=-1)
    resid = np.where(diverged[..., None], tgt, resid)
    _, loss_c, g_c = grads("cpu", resid)
    _, loss_g, g_g = grads("cuda", resid)
    errs = [float(((a - b).abs() / (b.abs() + 1e-7)).max())
            for a, b in zip(g_g, g_c)]
    rec = dict(check=tag, lanes=w * h, diverged=int(diverged.sum()),
               loss_card=loss_g, loss_cpu=loss_c, max_rel_err=max(errs),
               rtol=1e-3)
    log(json.dumps(rec))
    if diverged.mean() > FRAC:
        raise AssertionError(f"{tag}: {diverged.sum()} lanes diverge")
    for a, b in zip(g_g, g_c):
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-7):
            raise AssertionError(f"{tag}: gradients differ: {rec}")
    live = g_c if nonzero_leaf is None else [g_c[nonzero_leaf]]
    if max(float(g.abs().max()) for g in live) <= 0:
        raise AssertionError(f"{tag}: the gradient is zero")
    return rec


def train_phases(gpu: str) -> None:
    """The train step (models/inverse.py) on the card: gradients against
    the CPU's, and InverseRenderer fitting an albedo back (its steps
    replay the train-step graphs). The step at full width is
    `train_graph_phases`'."""
    from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
    from project3_cuda_path_tracer_tpu_torch.render import integrator as PI

    # ---- 9a. gradients, card against CPU ----------------------------------
    scene = sized(SCENE, 64, 8)
    scene.settings.stratified = True
    grads_card_vs_cpu(scene, "train grads card vs cpu 64x64 d8",
                      PI.build_trace_config(scene), nonzero_leaf=0)

    # ---- 9c. InverseRenderer fits the albedo back --------------------------
    # 128x128, depth 2 (tests/test_torch_train.py fits at 64x64 on the CPU;
    # a card's step costs about the same at 128x128, which halves the
    # gradient noise): target the mean of 128 renders at the true albedo,
    # the other leaves frozen, 100 steps, then 50 two-render steps whose
    # mean must be within 0.2 of 0.98.
    ref = PInv.InverseRenderer(sized(SCENE, 128, 2), np.zeros((128, 128, 3)),
                               device="cuda")
    with torch.no_grad():
        tgt = torch.stack([
            PInv.render_image(ref.params, *ref.tables,
                              PInv.step_generator(100, k, "cuda"), ref.cfg)
            for k in range(128)]).mean(0)
    bad = sized(SCENE, 128, 2)
    bad.materials.color[1] = 0.5
    ir = PInv.InverseRenderer(bad, tgt.cpu().numpy(), learning_rate=2e-2,
                              seed=3, device="cuda")
    color = ir.params.materials.color
    for leaf in PInv.param_leaves(ir.params):
        if leaf is not color:
            leaf.requires_grad_(False)
    t0 = time.perf_counter()
    ir.fit(100)
    tail = []
    for _ in range(50):
        ir.step(polish=True)
        tail.append(color[1].detach().clone())
    got = torch.stack(tail).mean(0).cpu().numpy()
    log(json.dumps(dict(check="fit white albedo 128x128 d2", start=0.5,
                        true=0.98, recovered=got.tolist(), atol=0.2,
                        seconds=time.perf_counter() - t0)))
    if np.abs(got - 0.98).max() > 0.2:
        raise AssertionError(f"fit recovered {got}, not 0.98 +- 0.2")


def g1_entry(g1: dict, train_graph: dict) -> dict:
    """G1's entry of the `kernels` line: the cornell [M,3] field's record
    of `g1_phase` and the launches of the cornell 800x800 train scan."""
    rec = g1["records"][0]
    return {"name": "mat_grad", "route": "cuda",
            "source": f"{PKG}/csrc/mat_grad.cu", "replaces": None,
            "launches": train_graph["cornell_800"]["mat_grad_launches"],
            "launches_per_train_step":
                train_graph["cornell_800"]["mat_grad_per_replay"],
            **{k: rec[k] for k in ("value", "cold_ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by",
                                   "share_of_bound", "bitwise")}}


def g1_phase(gpu: str) -> dict:
    """G1 (csrc/mat_grad.cu), the backward of the material gather, on the
    cornell train step's shapes: 640,000 lanes over its 5 materials, an
    [M,3] field's three gradient planes and an [M] field's one, the lanes'
    materials drawn at random or all one (index_put_'s worst case), and
    manylights256's 258 materials. Each: bit for bit against
    `mat_grad_plain` run on the card and against a second run; held time
    (stream held, 20 calls) and cold (each call after a 128 MB write); the
    bytes bound (mat_id and the planes read once); the plain version's
    time; index_put_(accumulate=True) into zeros, the backward torch gives
    the gather, as `library_ms`. Returns the records for the `kernels`
    line."""
    from project3_cuda_path_tracer_tpu_torch.ops import matgrad as MG
    from project3_cuda_path_tracer_tpu_torch.utils.device import (
        time_cold_ms, time_ms as held_ms)
    dev = torch.device("cuda")
    n = 800 * 800
    rng = np.random.default_rng(18)
    recs = []
    for m, c, kind in ((5, 3, "random"), (5, 1, "random"),
                       (5, 3, "one material"), (258, 3, "random")):
        ids = torch.from_numpy(np.full(n, 3) if kind == "one material"
                               else rng.integers(0, m, n)).to(dev)
        planes = [torch.from_numpy(rng.standard_normal(n, np.float32)).to(
            dev) for _ in range(c)]
        stacked = torch.stack(planes, -1) if c == 3 else planes[0]

        def kernel():
            return MG.mat_grad(ids, planes, m)

        def plain():
            return MG.mat_grad_plain(ids, planes, m)

        def library():
            return torch.zeros((m, c) if c == 3 else (m,),
                               device=dev).index_put_((ids,), stacked,
                                                      accumulate=True)
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        bitwise = torch.equal(got.view(torch.int32), want.view(torch.int32))
        repeat = torch.equal(got.view(torch.int32), again.view(torch.int32))
        gap = float((got - library().view(m, c)).abs().max())
        held = [held_ms(kernel, 20, warm=3) for _ in range(2)]
        cold = time_cold_ms(kernel, 5)
        rec = dict(metric="G1_mat_grad_ms", materials=m, planes=c, lanes=n,
                   ids=kind, value=float(np.mean(held)), held_runs=held,
                   cold_ms=float(np.median(cold)), cold_runs=cold,
                   plain_ms=held_ms(plain, 5, warm=1),
                   library_ms=held_ms(library, 5, warm=1),
                   bitwise=bitwise, repeat_bitwise=repeat,
                   max_gap_to_library=gap, **bound(n * (8 + 4 * c), 0),
                   gpu=gpu)
        rec["share_of_bound"] = rec["bound_ms"] / rec["value"]
        rec["cold_share_of_bound"] = rec["bound_ms"] / rec["cold_ms"]
        log(json.dumps(rec))
        recs.append(rec)
        if not (bitwise and repeat):
            raise AssertionError(f"G1 {m}x{c} {kind}: bitwise {bitwise}, "
                                 f"repeat {repeat}")
    return dict(records=recs)


def prim_runs(cfg) -> int:
    """The I1 launches of one `intersect_planar` under `cfg`: its runs of
    CUBE/SPHERE geoms (outside the batched spheres) between SDF geoms."""
    from project3_cuda_path_tracer_tpu_torch.scene import types as T
    runs, open_run = 0, False
    for g, t in enumerate(cfg.geom_types):
        if t == T.SDF:
            open_run = False
        elif t in (T.CUBE, T.SPHERE) and g not in set(cfg.sphere_batch):
            runs += not open_run
            open_run = True
    return runs


def i1_entry(i1: dict) -> dict:
    """I1's entry of the `kernels` line: mesh.txt's bounce-0 record of
    `i1_phase` and the launches that ran on the card over each render
    cell's chunk of I1_ITERS iterations (the capture's replays)."""
    rec = i1["records"][0]
    return {"name": "prim_hit", "route": "cuda",
            "source": f"{PKG}/csrc/prim_hit.cu", "replaces": None,
            "launches": sum(i1["launches"].values()),
            "launches_by_path": i1["launches"],
            "launches_per_iteration": i1["launches_per_iteration"],
            "path": "mesh.txt 1024x1024 d8, bounce 0",
            **{k: rec[k] for k in ("value", "cold_ms", "plain_ms",
                                   "bound_ms", "bound_by", "share_of_bound",
                                   "bitwise")},
            "library_ms": None}


# the iterations of each render cell's chunk in `i1_phase`: the first
# eager (the traced one), then the capture and a replay each
I1_ITERS = 4


def i1_phase(mesh_scene, gpu: str) -> dict:
    """I1 (csrc/prim_hit.cu), the analytic primitives' nearest hit, on the
    render cells' wavefronts: mesh.txt 1024x1024, cornell 800x800 with NEE
    (bounce 0 and 1, nearest and shadow queries), textured_env 2048x2048
    under the thin lens, each traced by the first (eager) iteration of a
    Renderer's step_many(I1_ITERS), whose launches `measured_launches`
    reads from the device tally: I1 must run 8 times an iteration on mesh
    and textured_env and 15 on cornell (8 bounces, 7 shadow queries) in
    the eager iteration and in each replay of the captured graph, which
    holds as many. Each query: the kernel bit for bit against
    `primitive_run_plain` on the card on every HitP field; held time
    (stream held, 20 calls), cold (each call after a 128 MB write); the
    bytes bound (the ray planes, the bound of a shadow query and the record
    written once; a broadcast origin once); the plain chain's time.
    Returns the records and the launches."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    from project3_cuda_path_tracer_tpu_torch.ops import primhit as I1
    from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
    from project3_cuda_path_tracer_tpu_torch.ops.vec import V3
    from project3_cuda_path_tracer_tpu_torch.scene import types as T
    from project3_cuda_path_tracer_tpu_torch.utils.device import (
        time_cold_ms, time_ms as held_ms)
    t_start = time.perf_counter()
    mesh = copy.deepcopy(mesh_scene)
    cornell = sized(SCENE, 800, 8)
    cornell.settings.nee = True
    textured = load_scene(TEXTURED)
    want_it = {"mesh": 8, "cornell_nee": 15, "textured_env": 8}
    recs, ran_by_cell, per_replay = [], {}, {}
    for cell, scene in (("mesh", mesh), ("cornell_nee", cornell),
                        ("textured_env", textured)):
        scene.settings.stratified = True
        r = Renderer(scene, device="cuda")
        if r.route != "wavefront":
            raise AssertionError(f"{cell} takes the {r.route} route")
        calls, real = [], wf.intersect_planar

        def spy(o, d, times, geoms, types, *args, **kw):
            if len(calls) < (4 if cell == "cornell_nee" else 2):
                calls.append((V3(*(c.clone() for c in o)),
                              V3(*(c.clone() for c in d)), times.clone(),
                              geoms, tuple(types), kw))
            return real(o, d, times, geoms, types, *args, **kw)

        def chunk():
            wf.intersect_planar = spy   # on the first iteration, eager
            try:
                r.step_many(1)
            finally:
                wf.intersect_planar = real
            r.step_many(I1_ITERS - 1)   # the capture, then its replays
        ran = measured_launches(chunk)
        if r.graph is None or r.graph.replays != I1_ITERS - 1:
            raise AssertionError(f"I1 {cell}: the chunk replayed no graph")
        ran_by_cell[cell] = ran["prim"]
        per_replay[cell] = r.graph.launches["prim"]
        if (ran["prim"] != I1_ITERS * want_it[cell]
                or per_replay[cell] != want_it[cell]):
            raise AssertionError(
                f"I1 {cell}: {ran['prim']} launches over {I1_ITERS} "
                f"iterations, {per_replay[cell]} a replay, not "
                f"{want_it[cell]} an iteration ({ran['wrappers']})")
        for q, (o, d, times, geoms, types, kw) in enumerate(calls):
            max_t, tangents = kw.get("max_t"), kw.get("tangents", False)
            n = o.x.shape[0]
            t_init = (torch.full((n,), wf.BIG, device=o.x.device)
                      if max_t is None else torch.clamp(max_t, max=wf.BIG))
            skip = set(kw.get("sphere_batch", ()))
            run = tuple((g, t) for g, t in enumerate(types)
                        if t in (T.CUBE, T.SPHERE) and g not in skip)

            def kernel():
                return I1.nearest(o, d, times, geoms, run,
                                  None if max_t is None else t_init, None,
                                  tangents)

            def plain():
                return wf.primitive_run_plain(
                    o, d, times, geoms, run,
                    wf.init_hit(n, o.x.device, t_init, tangents), tangents)
            with torch.no_grad():
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                bad = I1.differing_lanes(got, want)
                held = [held_ms(kernel, 20, warm=3) for _ in range(2)]
                cold = time_cold_ms(kernel, 5)
                plain_ms = held_ms(plain, 3, warm=1)
            rows = len(I1.ROWS) - (0 if tangents else I1.TANGENT_ROWS)
            read = sum(4 * (1 if c.stride(0) == 0 else n)
                       for c in (*o, *d, times))
            read += 4 * n if max_t is not None else 0
            written = n * (4 * rows + 8 + 1)
            kind = "shadow" if max_t is not None else "nearest"
            bounce = q // 2 if cell == "cornell_nee" else q
            rec = dict(metric="I1_prim_hit_ms", cell=cell,
                       query=f"{kind} bounce {bounce}",
                       lanes=n, geoms=len(run),
                       hit_share=float((want.t < t_init).float().mean()),
                       value=float(np.mean(held)), held_runs=held,
                       cold_ms=float(np.median(cold)), cold_runs=cold,
                       plain_ms=plain_ms, bitwise=not bad,
                       differing_lanes=bad, bytes_read=read,
                       bytes_written=written,
                       **bound(read + written, 0), gpu=gpu)
            rec["share_of_bound"] = rec["bound_ms"] / rec["value"]
            rec["cold_share_of_bound"] = rec["bound_ms"] / rec["cold_ms"]
            log(json.dumps(rec))
            recs.append(rec)
            if bad:
                raise AssertionError(f"I1 {cell} query {q}: {bad}")
        del r
    out = dict(metric="I1_summary", iterations=I1_ITERS,
               launches=ran_by_cell, launches_per_replay=per_replay,
               seconds=time.perf_counter() - t_start, gpu=gpu)
    log(json.dumps(out))
    return dict(records=recs, launches=ran_by_cell,
                launches_per_iteration=per_replay)


def s1_entry(s1: dict) -> dict:
    """S1's entry of the `kernels` line: mesh.txt's bounce-0 record of
    `s1_phase` and the launches that ran on the card over each render
    cell's chunk of S1_ITERS iterations (the capture's replays)."""
    rec = s1["records"][0]
    return {"name": "shade", "route": "cuda",
            "source": f"{PKG}/csrc/shade.cu", "replaces": None,
            "launches": sum(s1["launches"].values()),
            "launches_by_path": s1["launches"],
            "launches_per_iteration": s1["launches_per_iteration"],
            "path": "mesh.txt 1024x1024 d8, bounce 0",
            **{k: rec[k] for k in ("value", "cold_ms", "plain_ms",
                                   "bound_ms", "bound_by", "share_of_bound",
                                   "bitwise")},
            "library_ms": None}


# the iterations of each render cell's chunk in `s1_phase`: the first
# eager (the traced one), then the capture and a replay each
S1_ITERS = 4


def plane_bytes(planes: dict) -> int:
    """Bytes of the [N] planes read once each (a broadcast plane once)."""
    return sum(t.element_size() * (1 if t.stride(0) == 0 else t.shape[0])
               for t in planes.values())


def s1_phase(mesh_scene, gpu: str) -> dict:
    """S1 (csrc/shade.cu), the no-grad shading step, on the render cells'
    wavefronts: mesh.txt 1024x1024, cornell 800x800 with NEE, textured_env
    2048x2048 (the fused texel: the index entry point, P1, the shade entry
    point), bounces 0 and 1 each, traced by the first (eager) iteration of
    a Renderer's step_many(S1_ITERS), whose launches `measured_launches`
    reads from the device tally: S1's shade entry must run 8 times an
    iteration in every cell, its index entry 8 times on textured_env, in
    the eager iteration and in each replay of the captured graph, which
    holds as many. Each step: the kernel bit for bit against the chain
    (`wavefront.shade_plain`) on the card on every output plane, and the
    index against the chain's; held time (stream held, 20 calls) and cold
    (each call after a 128 MB write) of S1's launches (on textured_env the
    index and shade entries, P1 apart, and the whole step with P1); the
    bytes bound (each plane S1 reads and writes once; the exact-point
    planes, which only a transmitted ray reads, only where a material
    refracts); the chain's time.
    Returns the records and the launches."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    from project3_cuda_path_tracer_tpu_torch.ops import primhit as I1
    from project3_cuda_path_tracer_tpu_torch.ops import shade as S1
    from project3_cuda_path_tracer_tpu_torch.ops import texfetch
    from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
    from project3_cuda_path_tracer_tpu_torch.utils.device import (
        time_cold_ms, time_ms as held_ms)
    t_start = time.perf_counter()
    mesh = copy.deepcopy(mesh_scene)
    cornell = sized(SCENE, 800, 8)
    cornell.settings.nee = True
    textured = load_scene(TEXTURED)
    recs, ran_by_cell, per_replay = [], {}, {}
    for cell, scene in (("mesh", mesh), ("cornell_nee", cornell),
                        ("textured_env", textured)):
        scene.settings.stratified = True
        r = Renderer(scene, device="cuda")
        if r.route != "wavefront":
            raise AssertionError(f"{cell} takes the {r.route} route")
        calls, real = [], wf.shade_planar

        def spy(*args, **kw):
            if len(calls) < 2:
                calls.append((args, kw))
            return real(*args, **kw)

        def chunk():
            wf.shade_planar = spy   # on the first iteration, eager
            try:
                r.step_many(1)
            finally:
                wf.shade_planar = real
            r.step_many(S1_ITERS - 1)   # the capture, then its replays
        ran = measured_launches(chunk)
        if r.graph is None or r.graph.replays != S1_ITERS - 1:
            raise AssertionError(f"S1 {cell}: the chunk replayed no graph")
        tex = cell == "textured_env"
        want = {"shade": 8, "shade_index": 8 if tex else 0}
        ran_by_cell[cell] = {k: ran[k] for k in want}
        per_replay[cell] = {k: r.graph.launches[k] for k in want}
        if (ran_by_cell[cell] != {k: S1_ITERS * v for k, v in want.items()}
                or per_replay[cell] != want):
            raise AssertionError(
                f"S1 {cell}: {ran_by_cell[cell]} launches over {S1_ITERS} "
                f"iterations, {per_replay[cell]} a replay, not {want} an "
                f"iteration ({ran['wrappers']})")
        for bounce, (args, kw) in enumerate(calls):
            hit, ray_d, thr, alive, mats, tx, uni = args[:7]
            nee, last = kw.get("nee"), kw["last_bounce"]
            area = kw.get("nee_area", 0.0)
            texel = None
            with torch.no_grad():
                if tex:
                    idx = S1.fused_index(hit, ray_d, mats, tx)
                    texel = texfetch.take_u32(tx.fused_packed, idx)
                    aflat, _ = wf._atlas_flat_index(tx, hit.mat_id, hit.u,
                                                    hit.v)
                    na = tx.atlas.shape[0] * tx.atlas.shape[1]
                    chain_idx = torch.where(
                        hit.t <= 0.0, wf._env_flat_index(tx, ray_d) + na,
                        aflat)
                    index_bad = int((idx != chain_idx).sum())

                def kernel():
                    return S1.shade(hit, ray_d, thr, alive, mats, tx, uni,
                                    last, nee, area, texel=texel)

                def whole():
                    return S1.shade(hit, ray_d, thr, alive, mats, tx, uni,
                                    last, nee, area)

                def index():
                    return S1.fused_index(hit, ray_d, mats, tx)

                def plain():
                    return wf.shade_plain(*args, **kw)
                got, want_out = whole(), plain()
                torch.cuda.synchronize()
                bad = I1.differing_lanes(got, want_out)
                held = [held_ms(kernel, 20, warm=3) for _ in range(2)]
                cold = time_cold_ms(kernel, 5)
                extra = {}
                if tex:
                    ih = [held_ms(index, 20, warm=3) for _ in range(2)]
                    ic = time_cold_ms(index, 5)
                    held = [a + b for a, b in zip(held, ih)]
                    cold = [a + b for a, b in zip(cold, ic)]
                    extra = dict(
                        index_ms=float(np.mean(ih)),
                        index_cold_ms=float(np.median(ic)),
                        index_bitwise=index_bad == 0,
                        index_differing_lanes=index_bad,
                        step_with_p1_ms=held_ms(whole, 20, warm=3))
                plain_ms = held_ms(plain, 3, warm=1)
            n = hit.t.shape[0]
            planes = S1.shade_planes(hit, ray_d, thr, alive, uni, nee,
                                     texel)
            if not bool((mats.has_refractive > 0).any()):
                # only a transmitted ray starts from the exact point
                for k in ("sx", "sy", "sz"):
                    del planes[k]
            read = plane_bytes(planes)
            written = n * (4 * (13 if nee is not None else 12) + 1)
            if tex:
                read += plane_bytes(S1.index_planes(hit, ray_d))
                written += 4 * n
            rec = dict(metric="S1_shade_ms", cell=cell,
                       step=f"bounce {bounce}", lanes=n,
                       alive_share=float(alive.float().mean()),
                       value=float(np.mean(held)), held_runs=held,
                       cold_ms=float(np.median(cold)), cold_runs=cold,
                       plain_ms=plain_ms, bitwise=not bad,
                       differing_lanes=bad, bytes_read=read,
                       bytes_written=written, **extra,
                       **bound(read + written, 0), gpu=gpu)
            rec["share_of_bound"] = rec["bound_ms"] / rec["value"]
            rec["cold_share_of_bound"] = rec["bound_ms"] / rec["cold_ms"]
            log(json.dumps(rec))
            recs.append(rec)
            if bad or extra.get("index_differing_lanes"):
                raise AssertionError(
                    f"S1 {cell} bounce {bounce}: {bad}, index "
                    f"{extra.get('index_differing_lanes')}")
        del r, calls
    out = dict(metric="S1_summary", iterations=S1_ITERS,
               launches=ran_by_cell, launches_per_replay=per_replay,
               seconds=time.perf_counter() - t_start, gpu=gpu)
    log(json.dumps(out))
    return dict(records=recs,
                launches={c: v["shade"] + v["shade_index"]
                          for c, v in ran_by_cell.items()},
                launches_per_iteration=per_replay)


# ---------------------------------------------------------------------------
# The train step as one captured graph (slice J)
# ---------------------------------------------------------------------------

class TrainCase:
    """One scene's train step on the card as InverseRenderer holds it
    (`train_config`, textures fused, meshes packed) and one start state
    (`start`: the scene's parameters, a fresh Adam state, one history
    render seeded from `step_generator(99, 0)`), stepped as make_train_step
    calls (`eager`) or through make_train_scan."""

    def __init__(self, scene, target: torch.Tensor):
        from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
        from project3_cuda_path_tracer_tpu_torch.ops import texfetch
        from project3_cuda_path_tracer_tpu_torch.render import \
            integrator as PI
        dev = torch.device("cuda")
        self.scene, self.target = scene, target
        self.cfg = PInv.train_config(scene)
        self.tables = (PI.to_device(scene.geoms, dev),
                       PI.to_device(scene.meshes, dev),
                       texfetch.fuse(PI.to_device(scene.textures, dev)))
        self.packed = tuple(PI.to_device(p, dev)
                            for p in scene.packed_meshes)
        self.hist0 = PInv.make_seed_history(
            *self.tables, self.cfg, self.packed)(
            PInv.params_from_scene(scene, dev),
            PInv.step_generator(99, 0, dev))

    def start(self):
        from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
        from project3_cuda_path_tracer_tpu_torch.models import optim
        p = PInv.params_from_scene(self.scene, torch.device("cuda"))
        return p, optim.init(PInv.param_leaves(p)), self.hist0.clone()

    def eager(self, step, state, seed: int, steps, history: bool):
        """make_train_step calls for the step indices `steps`, step i
        drawing from step_generator(seed, i): (params, opt_state, hist or
        None, losses)."""
        from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
        p, s, h = state
        losses = []
        for i in steps:
            gen = PInv.step_generator(seed, i, "cuda")
            if history:
                p, s, h, loss = step(p, s, h, gen, self.target)
            else:
                p, s, loss = step(p, s, gen, self.target)
            losses.append(loss)
        return p, s, h if history else None, torch.stack(losses)


def nondeterministic_ops(fn) -> list:
    """The ops of `fn()` that torch names as having no deterministic CUDA
    implementation (the warnings of `use_deterministic_algorithms(True,
    warn_only=True)`, which is on during this call alone)."""
    import warnings
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0][:120]
                   for w in caught if "deterministic" in str(w.message)})


def timed(fn, n: int) -> tuple:
    """(fn()'s result, device ms a step by CUDA events around it, host wall
    ms a step), n steps, synchronised on both sides."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return (out, start.elapsed_time(stop) / n,
            (time.perf_counter() - t0) * 1e3 / n)


def within(gap: dict, spread: dict) -> bool:
    return all(gap[k] <= spread[k] for k in gap)


def graph_vs_eager(tag: str, case: TrainCase, history: bool, n: int,
                   gpu: str, config: str, second: bool = False,
                   profile: bool = False) -> dict:
    """make_train_scan(num_steps=n) against n make_train_step calls from one
    start state, seed 7. The rule: the loop's first step, run once more
    from the start state, sets the spread; where the two agree bit for
    bit, the graph's state (losses, leaves, mu, nu, count, history:
    `train_state_gap`) must equal the loop's bit for bit; where they do
    not, the ops torch names as nondeterministic are printed and the
    graph is held to the gap between two whole loops, no looser. Both ways
    timed (`timed`: the loop, then the graph's first call, whose first
    step is eager and whose second is captured), with each one's peak
    memory, the capture's seconds, pool bytes and launches a replay, and
    the kernels' device tallies over the graph's call. With `second`, a
    second call of the same function from the first one's outputs (seed
    8, as bench.py's next epoch: replays alone) and the loop continued
    from the eager outputs, timed in that order, held the same way: no new
    capture; without it, two more replays are timed alone. With `profile`,
    one replay and one eager step under torch.profiler."""
    from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
    gap_of = PInv.train_state_gap
    step = PInv.make_train_step(*case.tables, case.cfg,
                                packed_meshes=case.packed, history=history)
    run = PInv.make_train_scan(*case.tables, case.cfg, num_steps=n,
                               packed_meshes=case.packed, history=history)
    kept = {}

    def loop():
        one = case.eager(step, case.start(), 7, range(1), history)
        kept["one"] = PInv.copy_train_state(*one[:3]) + (one[3].clone(),)
        rest = case.eager(step, one[:3], 7, range(1, n), history)
        return rest[:3] + (torch.cat([one[3], rest[3]]),)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want, eager_ms, eager_wall = timed(loop, n)
    eager_peak = torch.cuda.max_memory_allocated()
    again = case.eager(step, case.start(), 7, range(1), history)
    spread = gap_of(kept.pop("one"), again)
    bitwise = not any(spread.values())
    ops = []
    if not bitwise:
        ops = nondeterministic_ops(
            lambda: case.eager(step, case.start(), 7, range(1), history))
        spread = gap_of(want, case.eager(step, case.start(), 7, range(n),
                                         history))
    del again

    def graph_call(state, seed):
        p, s, h = state
        out = run(p, s, h, seed, case.target) if history else run(
            p, s, seed, case.target)
        return out if history else (out[0], out[1], None, out[2])
    torch.cuda.reset_peak_memory_stats()
    got = {}

    def first_call():
        got["out"], got["ms"], got["wall"] = timed(
            lambda: graph_call(case.start(), 7), n)
    ran = measured_launches(first_call)
    graph_peak = torch.cuda.max_memory_allocated()
    gap = gap_of(got["out"], want)
    tg = run.train_graph
    g = tg.graph
    if g is None:
        raise AssertionError(f"{tag}: nothing was captured")
    rec = dict(metric=f"train_graph_{tag}", config=config, steps=n,
               history=history, remat=case.cfg.remat,
               deterministic=bitwise, nondeterministic_ops=ops,
               eager_spread=spread, gap=gap,
               bitwise=not any(gap.values()),
               ms_per_step_eager=eager_ms, host_wall_ms_eager=eager_wall,
               ms_per_step_graph_first_call=got["ms"],
               host_wall_ms_graph_first_call=got["wall"],
               peak_memory_bytes_eager=eager_peak,
               peak_memory_bytes_graph_first_call=graph_peak,
               capture_s=g.capture_s, instantiate_s=g.instantiate_s,
               pool_bytes=g.pool_bytes, launches_per_replay=g.launches,
               device_launches={k: v for k, v in ran.items()
                                if k != "wrappers"},
               wrapper_launches=ran["wrappers"],
               losses_graph=got["out"][3].tolist(),
               losses_eager=want[3].tolist(), gpu=gpu)
    if second:
        got2, ms2, wall2 = timed(lambda: graph_call(
            PInv.copy_train_state(*got["out"][:3]), 8), n)
        want2, ems2, ewall2 = timed(lambda: case.eager(
            step, PInv.copy_train_state(*want[:3]), 8, range(n), history), n)
        gap2 = gap_of(got2, want2)
        rec.update(second_call=dict(
            gap=gap2, bitwise=not any(gap2.values()),
            ms_per_step_graph=ms2, host_wall_ms_graph=wall2,
            ms_per_step_eager=ems2, host_wall_ms_eager=ewall2,
            captured_again=run.train_graph.graph is not g,
            replays=g.replays))
        rec["second_call"]["fwdbwd_path_segments_per_s_graph"] = (
            case.cfg.width * case.cfg.height * case.cfg.trace_depth
            / (ms2 / 1e3))
        rec["second_call"]["fwdbwd_path_segments_per_s_eager"] = (
            case.cfg.width * case.cfg.height * case.cfg.trace_depth
            / (ems2 / 1e3))
    rec["graph_replays"] = g.replays
    if not second:
        # two more replays, timed: the graph's ms a step
        def replays():
            for k in range(2):
                tg._prepare(9, k)
                g.replay()
        _, rec["ms_per_step_graph_replays"], rec[
            "host_wall_ms_graph_replays"] = timed(replays, 2)
    if profile:
        def replay():
            tg._prepare(9, 0)
            g.replay()
        p, s, h = case.start()
        rec.update(replay_profile=profile_one(replay, host_ops=False),
                   eager_step_profile=profile_one(
                       lambda: case.eager(step, (p, s, h), 9, range(1),
                                          history), host_ops=False))
    log(json.dumps(rec))
    if not within(gap, spread):
        raise AssertionError(f"{tag}: the graph's state is {gap} from the "
                             f"eager loop's, the eager spread {spread}")
    if rec["graph_replays"] != n - 1 + (n if second else 0):
        raise AssertionError(f"{tag}: {rec['graph_replays']} replays")
    if second and (rec["second_call"]["captured_again"]
                   or not within(rec["second_call"]["gap"], spread)):
        raise AssertionError(f"{tag}: second call {rec['second_call']}")
    if not np.isfinite(rec["losses_graph"]).all():
        raise AssertionError(f"{tag}: non-finite loss")
    rec["run"] = run
    return rec


def inverse_graphs(gpu: str) -> dict:
    """(e) InverseRenderer on cornell 256x256 depth 8 (white albedo 0.5, a
    flat grey target): fit(6, polish_steps=2), then a history, a polish
    and a history step, each form's graph replayed after the other's
    (they share one pool), against the loop of make_train_step calls on
    InverseRenderer's draw schedule, by `graph_vs_eager`'s rule (the
    spread of the first step, seed render included, run twice; of the
    whole schedule where those differ)."""
    from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
    bad = sized(SCENE, 256, 8)
    bad.materials.color[1] = 0.5
    w, h = bad.camera.resolution
    target = np.full((h, w, 3), 0.3, np.float32)
    kinds = "hhhhpphph"

    def reference(kinds):
        """The renderer's schedule `kinds` (h: a history step, p: a polish
        step) as make_train_step calls."""
        ref = PInv.InverseRenderer(bad, target, seed=4, device="cuda")
        hstep = PInv.make_train_step(*ref.tables, ref.cfg, history=True)
        pstep = PInv.make_train_step(*ref.tables, ref.cfg)
        seed_hist = PInv.make_seed_history(*ref.tables, ref.cfg)
        p, s, hist, draws, losses = ref.params, ref.opt_state, None, 0, []
        for kind in kinds:
            if kind == "h" and hist is None:
                hist = seed_hist(p, PInv.step_generator(4, draws, "cuda"))
                draws += 1
            gen = PInv.step_generator(4, draws, "cuda")
            draws += 1
            if kind == "h":
                p, s, hist, loss = hstep(p, s, hist, gen, ref.target)
            else:
                p, s, loss = pstep(p, s, gen, ref.target)
                hist = None
            losses.append(loss)
        return p, s, hist, torch.stack(losses)

    want, eager_ms, _ = timed(lambda: reference(kinds), len(kinds))
    spread = PInv.train_state_gap(reference("h"), reference("h"))
    if any(spread.values()):
        spread = PInv.train_state_gap(want, reference(kinds))
    ir = PInv.InverseRenderer(bad, target, seed=4, device="cuda")

    def fit():
        return ir.fit(6, polish_steps=2) + [ir.step(), ir.step(polish=True),
                                            ir.step()]
    losses, graph_ms, _ = timed(fit, len(kinds))
    got = (ir.params, ir.opt_state, ir.hist,
           torch.tensor(losses, device="cuda"))
    want = want[:3] + (want[3].float(),)
    gap = PInv.train_state_gap(got, want)
    graphs = ir.graphs
    rec = dict(metric="train_graph_inverse_renderer",
               config="cornell 256x256 depth 8, fit(6, polish_steps=2) "
                      "then history, polish, history steps",
               gap=gap, eager_spread=spread,
               bitwise=not any(gap.values()), losses=losses,
               ms_per_step_eager=eager_ms, ms_per_step_graph=graph_ms,
               graphs={k: None if g is None else dict(
                   replays=g.replays, capture_s=g.capture_s,
                   instantiate_s=g.instantiate_s, pool_bytes=g.pool_bytes)
                   for k, g in graphs.items()},
               shared_pool=all(g is not None for g in graphs.values()) and (
                   graphs["history"].graph.pool()
                   == graphs["two_render"].graph.pool()),
               gpu=gpu)
    log(json.dumps(rec))
    if not within(gap, spread):
        raise AssertionError(f"inverse renderer graphs: {gap} from the "
                             f"eager steps, spread {spread}")
    if not (rec["shared_pool"] and graphs["history"].replays == 5
            and graphs["two_render"].replays == 2):
        raise AssertionError(f"inverse renderer graphs: {rec['graphs']}")
    return rec


def train_graph_phases(gpu: str, target: torch.Tensor) -> dict:
    """Slice J: the train step as one captured CUDA graph, replayed by
    make_train_scan and InverseRenderer. (a) cornell 800x800 depth 8, the
    history form, bench.py's configuration (white albedo 0.5, the main
    path's image as target): 5 steps both ways (`graph_vs_eager`), then
    (b) a second call of the same function, profiled, and 3 two-render
    polish steps through InverseRenderer from (a)'s state; (c) the
    two-render form at 256x256; (d) textured_env at 512x512 depth 8 (cut
    from its own 2048x2048 for time), remat by the rule, K2 and P1 inside
    the graph (16 each a step: forward and recompute), by their device
    tallies; (e) `inverse_graphs`. K1 launches 0 throughout. Each part's
    graphs are deleted before the next. Returns the tallies for the
    `kernels` line."""
    import gc
    from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
    t_start = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_start - sum(marks.values())
    zero_counts()
    bad = sized(SCENE, 800, 8)
    bad.materials.color[1] = 0.5
    case = TrainCase(bad, target)
    if (case.cfg.width, case.cfg.height, case.cfg.trace_depth,
            case.cfg.remat) != (800, 800, 8, False):
        raise AssertionError(f"the train step is not bench.py's: {case.cfg}")
    a = graph_vs_eager("cornell_800_history", case, True, 5, gpu,
                       "cornell 800x800 depth 8, history step (bench.py)",
                       second=True, profile=True)
    # the polish steps, through InverseRenderer, from (a)'s graph state
    state = a.pop("run").train_graph
    ir = PInv.InverseRenderer(bad, target.cpu().numpy(), device="cuda")
    with torch.no_grad():
        for mine, theirs in zip(PInv.param_leaves(ir.params) + ir.opt_state.mu
                                + ir.opt_state.nu + [ir.opt_state.count],
                                PInv.param_leaves(state.params)
                                + state.opt_state.mu + state.opt_state.nu
                                + [state.opt_state.count]):
            mine.copy_(theirs)
    del state
    gc.collect()
    polish, polish_ms, _ = timed(
        lambda: [ir.step(polish=True) for _ in range(3)], 3)
    albedo = float(ir.params.materials.color[1, 0].detach())
    g = ir.graphs["two_render"]
    log(json.dumps(dict(
        metric="train_graph_polish_steps", config="cornell 800x800 depth 8, "
        "3 two-render steps of InverseRenderer from (a)'s state (one eager, "
        "the capture, a replay)", ms_per_step=polish_ms, losses=polish,
        white_albedo_after=albedo, replays=g.replays, capture_s=g.capture_s,
        instantiate_s=g.instantiate_s, pool_bytes=g.pool_bytes, gpu=gpu)))
    del ir
    gc.collect()
    torch.cuda.empty_cache()
    mark("cornell_800")
    def grey(scene):
        w, h = scene.camera.resolution
        return torch.full((h, w, 3), 0.3, device="cuda")
    small = sized(SCENE, 256, 8)
    small.materials.color[1] = 0.5
    c = graph_vs_eager("cornell_256_two_render", TrainCase(small, grey(small)),
                       False, 3, gpu, "cornell 256x256 depth 8, two-render "
                       "step")
    c.pop("run")
    gc.collect()
    torch.cuda.empty_cache()
    mark("cornell_256_two_render")
    tex = sized(TEXTURED, 512, 8)
    d = graph_vs_eager("textured_env_512_history", TrainCase(tex, grey(tex)),
                       True, 3, gpu, "textured_env 512x512 depth 8 (its own "
                       "2048x2048 cut for time), history step, remat by "
                       "the rule")
    d.pop("run")
    gc.collect()
    torch.cuda.empty_cache()
    mark("textured_env_512")
    e = inverse_graphs(gpu)
    gc.collect()
    torch.cuda.empty_cache()
    mark("inverse_renderer")
    k1 = read_counts()["k1"]
    per, ran, wrappers = (d["launches_per_replay"], d["device_launches"],
                          d["wrapper_launches"])
    # the eager step counted by its wrappers, the capture once more (no
    # kernel runs under it), and 2 replays by the kernels' own tallies
    tallies_ok = all(
        per[k] == 16 and ran[k] == wrappers[k] - per[k] + 2 * per[k]
        and wrappers[k] == 2 * per[k] for k in ("k2", "p1"))
    out = dict(seconds=time.perf_counter() - t_start, seconds_by_part=marks,
               k1_launches=k1, textured_tallies_ok=tallies_ok,
               k2_launches=ran["k2"], gather_launches=ran["p1"],
               cornell_800=dict(
                   eager_ms=a["ms_per_step_eager"],
                   graph_ms=a["second_call"]["ms_per_step_graph"],
                   eager_ms_second=a["second_call"]["ms_per_step_eager"],
                   bitwise=a["bitwise"], deterministic=a["deterministic"],
                   pool_bytes=a["pool_bytes"],
                   mat_grad_per_replay=a["launches_per_replay"]["mat_grad"],
                   mat_grad_launches=a["device_launches"]["mat_grad"]),
               gpu=gpu)
    log(json.dumps(dict(metric="train_graph_summary", **out)))
    if k1:
        raise AssertionError(f"train graph: K1 launched {k1} times")
    # G1 keeps two eager cornell steps bit for bit, and so the graph
    if not (a["deterministic"] and a["bitwise"]
            and a["launches_per_replay"]["mat_grad"] > 0):
        raise AssertionError(f"cornell 800 train graph: {out['cornell_800']}"
                             f", nondeterministic ops "
                             f"{a['nondeterministic_ops']}")
    if not tallies_ok:
        raise AssertionError(f"textured train graph: K2/P1 launches {ran}, "
                             f"{per} a replay, wrappers {wrappers}")
    if not (np.isfinite(polish).all() and albedo != 0.5):
        raise AssertionError(f"polish steps: {polish}, albedo {albedo}")
    return dict(out, records=dict(a=a, c=c, d=d, e=e))


def profile_one(fn, top: int = 6, host_ops: bool = True,
                named: bool = False) -> dict:
    """One call of `fn` under torch.profiler: device time of its kernels
    against the wall time of the call (the device-busy share), and the
    `top` kernels by device time (name, launches, us). `host_ops=False`
    records the device activity alone, which spares the profiler a host
    event per op on iterations of 10^5 eager ops. `named`: each kernel's
    launches by name (`named_launches`, which raises where the profiler
    recorded no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if host_ops:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = named_launches(prof) if named else None
    per_kernel = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        per_kernel.append((getattr(ev, "self_device_time_total",
                                   getattr(ev, "self_cuda_time_total", 0.0)),
                           ev.count, ev.key[:120]))
    device_us = sum(k[0] for k in per_kernel)
    if device_us == 0:
        return dict(profile="not measured: no device events")
    per_kernel.sort(reverse=True)
    out = dict(profiled_wall_us=wall_us, device_us=device_us,
               device_busy_share=device_us / wall_us,
               kernels_launched=sum(k[1] for k in per_kernel),
               top_kernels=[dict(name=n, launches=c, us=t)
                            for t, c, n in per_kernel[:top]])
    if by_name is not None:
        out["named_launches"] = by_name
    return out


def p1_sizes(gpu: str) -> dict:
    """P1 at the probe's 64 KB and 256 KB atlases and the 512 KB sky table:
    every instance that holds the table bit for bit against the plain
    version, then timed in turns (in order, then reversed) warm (stream
    held, 20 calls) and cold (each call after a 128 MB write), beside
    `torch.take` and the plain version. Returns the records by texels."""
    from project3_cuda_path_tracer_tpu_torch.ops import texfetch as P1
    from project3_cuda_path_tracer_tpu_torch.tools import exp_gather
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        time_cold_ms
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        time_ms as held_ms
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for side in (*exp_gather.SIDES, exp_gather.SKY):
        table, _, idx = exp_gather.inputs(side)
        p = table.numel()
        want = P1.gather_plain(table, idx).view(torch.int32)
        fits = [k for k in P1.INSTANCES
                if P1.slice_bytes(p, k) <= P1.SLICE_BYTES]
        for k in fits:
            got = P1._gather_instance(k, table, idx)
            torch.cuda.synchronize()
            equal = torch.equal(got.view(torch.int32), want)
            log(json.dumps(dict(check=f"P1 {P1.INSTANCES[k]} P={p}",
                                fetches=idx.numel(), bitwise=equal)))
            if not equal:
                raise AssertionError(f"P1 {P1.INSTANCES[k]} differs at P={p}")
        t_i32, idx64 = table.view(torch.int32), idx.long()
        fns = {P1.INSTANCES[k]: (lambda k=k: P1._gather_instance(
            k, table, idx)) for k in fits}
        fns["torch_take"] = lambda: torch.take(t_i32, idx64)
        warm = {k: [] for k in fns}
        cold = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            warm[k].append(held_ms(fns[k], 20, warm=3))
            cold[k].append(float(np.median(time_cold_ms(fns[k], 10))))
        plain = held_ms(lambda: P1.gather_plain(table, idx), 20, warm=3)
        b = bound(idx.numel() * 8 + p * 4, 0)
        pick = P1.INSTANCES[P1.instance_for(p * 4)]
        rec = dict(metric="P1_gather_ms", texels=p, table_bytes=p * 4,
                   pick=pick, gpu=gpu, bound_ms=b["bound_ms"],
                   plain_ms=plain)
        for k, name in ((k, P1.INSTANCES[k]) for k in fits):
            grid, per = P1.plan(0, k, p)
            rec[name] = dict(
                ms=float(np.mean(warm[name])),
                cold_ms=float(np.mean(cold[name])),
                share_warm=b["bound_ms"] / float(np.mean(warm[name])),
                share_cold=b["bound_ms"] / float(np.mean(cold[name])),
                grid=grid, blocks_per_sm=per, busy_sms=sms,
                runs=warm[name], cold_runs=cold[name])
        rec["torch_take"] = dict(ms=float(np.mean(warm["torch_take"])),
                                 cold_ms=float(np.mean(cold["torch_take"])))
        rec["fastest_cold"] = min((n for n in rec if n in fns
                                   and n != "torch_take"),
                                  key=lambda n: rec[n]["cold_ms"])
        log(json.dumps(rec))
        out[p] = rec
    return out


def p2_chain(gpu: str) -> dict:
    """P2: each kind bit for bit against the plain version at PLAIN_STEPS
    and against the first port's kernel at STEPS (its SHA-256), then the
    chain floor's terms and each kind's floor."""
    from project3_cuda_path_tracer_tpu_torch.tools import \
        exp_extract_cost as P2
    table, state = P2.inputs()
    errs = {}
    for kind in P2.KINDS:
        got = P2.extract_cost(table, state, kind, P2.PLAIN_STEPS)
        want = P2.extract_cost_plain(table, state, kind, P2.PLAIN_STEPS)
        full = P2.extract_cost(table, state, kind, P2.STEPS)
        torch.cuda.synchronize()
        errs[kind] = float((got - want).abs().max())
        equal = torch.equal(got, want)
        same = P2.sha256(full) == P2.SHA256_STEPS[kind]
        log(json.dumps(dict(check=f"P2 {kind} {P2.PLAIN_STEPS} steps",
                            bitwise=equal, max_abs_err=errs[kind],
                            first_kernel_at_steps=P2.STEPS,
                            first_kernel_bitwise=same)))
        if not (equal and same):
            raise AssertionError(f"P2 {kind}: kernel differs from the plain "
                                 "version or the first kernel")
    terms = P2.chain_terms(table)
    floors = {k: P2.chain_floor_ns(terms, k) for k in P2.KINDS}
    log(json.dumps(dict(metric="P2_chain_floor_ns_per_step", **terms,
                        floor_ns=floors, gpu=gpu)))
    return dict(errs=errs, terms=terms, floors=floors)


def probe_phases(gpu: str) -> list:
    """P1 and P2: each instance and kind bit for bit, P1's sizes timed warm
    and cold, P2's chain floor, then each probe's entry point (its main())
    with the counts at 0 before and read after (P1's in `utils.launches`,
    P2's in its own module). Returns their `kernels` entries."""
    from project3_cuda_path_tracer_tpu_torch.tools import \
        exp_extract_cost as P2
    from project3_cuda_path_tracer_tpu_torch.tools import exp_gather as P1
    sizes = p1_sizes(gpu)
    chain = p2_chain(gpu)

    out = {}
    zero_counts()
    P2.LAUNCHES = 0
    for name, mod, launched in (("gather", P1, lambda: read_counts()["p1"]),
                                ("extract_cost", P2, lambda: P2.LAUNCHES)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main()
        recs = [json.loads(line) for line in buf.getvalue().splitlines()
                if line.startswith("{")]
        for rec in recs:
            log(json.dumps(dict(probe=name, gpu=gpu, **rec)))
        if rc != 0 or launched() == 0:
            raise AssertionError(f"probe {name}: rc {rc}, "
                                 f"{launched()} launches")
        out[name] = (recs, launched())
    recs, gather_launches = out["gather"]
    by = {(r["prim"], r["P"]): r for r in recs}
    if not all(by[("cuda_gather_u32", s * s)]["correct"] for s in P1.SIDES):
        raise AssertionError("P1 probe: gather not correct")
    big = P1.SIDES[-1] ** 2
    recs, p2_launches = out["extract_cost"]
    if not all(r["bitwise"] for r in recs):
        raise AssertionError("P2 probe: kernel differs from plain")
    e48 = next(r for r in recs if r["kind"] == "extract48")
    # P1: each index read and each fetched word written once, the table
    # once. P2 (extract48 at PLAIN_STEPS, the entry's `ms`): per step the
    # whole [16,128] state folds 48 scalars (an FMA each) and 128 lanes are
    # summed; it reads the rows it visits and the state, writes the state.
    # Its chain floor: PLAIN_STEPS x extract48's floor a step.
    b1 = bound(P1.N * 8 + big * 4, 0)
    steps = P2.PLAIN_STEPS
    b2 = bound(steps * P2.ROW * 4 + 2 * P2.SUB * P2.LANES * 4,
               steps * (P2.SUB * P2.LANES * 48 * 2 + P2.LANES - 1))
    floor2 = steps * chain["floors"]["extract48"] * 1e-6
    for name, b in (("P1", b1), ("P2", b2)):
        log(json.dumps(dict(metric=f"{name}_bound", **b, gpu=gpu)))
    pick = sizes[big][sizes[big]["pick"]]
    return [
        dict(name="texel gather (P1)", route="cuda",
             source=f"{PKG}/csrc/gather.cu",
             replaces="tools/exp_gather.py:88", launches=gather_launches,
             max_abs_err=0.0, ms=by[("cuda_gather_u32", big)]["ms"],
             plain_ms=by[("plain_index_u32", big)]["ms"],
             bound_ms=b1["bound_ms"], bound_by=b1["bound_by"],
             library_ms=by[("torch_take_u32", big)]["ms"],
             instance=sizes[big]["pick"], cold_ms=pick["cold_ms"],
             library_cold_ms=sizes[big]["torch_take"]["cold_ms"],
             ms_by_texels={p: dict(pick=r["pick"], ms=r[r["pick"]]["ms"],
                                   cold_ms=r[r["pick"]]["cold_ms"],
                                   bound_ms=r["bound_ms"])
                           for p, r in sizes.items()}),
        dict(name="dependent-load chain (P2)", route="cuda",
             source=f"{PKG}/csrc/extract_cost.cu",
             replaces="tools/exp_extract_cost.py:61", launches=p2_launches,
             max_abs_err=max(chain["errs"].values()), ms=e48["ms"],
             plain_ms=e48["plain_ms"], bound_ms=b2["bound_ms"],
             bound_by=b2["bound_by"], library_ms=None,
             chain_floor_ms=floor2, share_of_floor=floor2 / e48["ms"],
             ns_per_step={r["kind"]: r["ns_per_step"] for r in recs},
             chain_floor_ns_per_step=chain["floors"])]


def settings_of(scene, res: int = 0, depth: int = 0, **settings):
    """A copy of `scene` (its tables shared) at res x res and depth when
    given, with RenderSettings fields `settings`."""
    cam = copy.deepcopy(scene.camera)
    if res:
        cam.resolution = (res, res)
        cam.derive()
    st = dataclasses.replace(scene.settings, **settings)
    if depth:
        st.trace_depth = depth
    return dataclasses.replace(scene, camera=cam, settings=st)


def iteration_ms(renderers: dict, gpu: str, config: str) -> dict:
    """Each renderer's ms an iteration (CUDA events around 3 steps, after
    one warm-up), timed twice in turns (A B .. B A), then one step of each
    under torch.profiler's device activity (kernels, device busy share).
    `renderers` maps a metric tag to a Renderer."""
    tags = list(renderers)
    runs = {t: [] for t in tags}
    for order in (tags, tags[::-1]):
        for t in order:
            runs[t].append(time_ms(renderers[t].step, 3,
                                   warm=0 if runs[t] else 1))
    out = {}
    for t in tags:
        r = renderers[t]
        out[t] = dict(metric=f"{t}_ms_per_iteration",
                      value=float(np.mean(runs[t])), runs=runs[t],
                      route=r.route, config=config, gpu=gpu,
                      **profile_one(r.step, host_ops=False))
        log(json.dumps(out[t]))
    return out


def dead_runs(t_bound: torch.Tensor) -> int:
    """The number of maximal runs of dead lanes (!(t_bound > 0))."""
    dead = ~(t_bound > 0)
    return int(dead[0]) + int((dead[1:] & ~dead[:-1]).sum())


def k2_wave_bound(p8, qo, qd, tb) -> dict:
    """K2's bound on one wavefront: the tree rows its live rays read, once
    (a plain traversal of the live rays under `RowLog`), each live ray's 7
    planes read and 7 written, 32 B for a dead lane (t_bound <= 0)."""
    from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
    n = int(tb.numel())
    live = tb > 0
    n_live = int(live.sum())
    lo, ld = tuple(c[live] for c in qo), tuple(c[live] for c in qd)
    rd = tree_reads(lambda pk: P8.traverse8_plain(lo, ld, pk, tb[live]), p8,
                    "nodes")
    bd = bound(n_live * (7 + 7) * 4 + (n - n_live) * (1 + 7) * 4
               + rd["node_rows"] * NODE8_BYTES
               + rd["tri_rows"] * TRI_TEST_BYTES
               + rd["hit_tris"] * TRI_HIT_BYTES,
               rd["node_visits"] * 8 * BOX_OPS + rd["tri_tests"] * TRI_OPS)
    return dict(rays=n, live=n_live, **bd, **rd)


def k2_compacted(gpu: str, p8, sorted_waves: list, plain_waves: list,
                 buckets: int) -> dict:
    """K2 on the bounce-1 wavefront of one --sort --compact iteration of
    mesh.txt against traverse8_plain bit for bit, pops included. That
    wavefront is bounce 0's paths in bucket order (by the material they
    hit, then the misses): each bucket's paths end or go on together, so
    its dead lanes lie in at most `buckets` runs, where the identity order
    scatters them. Held (stream held, 20 launches; twice, in turns) beside
    K2's held time on the same iteration's bounce-1 wavefront in the
    identity order, the plain traversal's time, and the bound (the tree
    rows the live rays read, once; the same rays in either order)."""
    from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        time_ms as device_ms
    qo, qd, _, kw = sorted_waves[1]
    tb = kw["t_bound"]
    k = P8.traverse8(qo, qd, p8, t_bound=tb, return_pops=True)
    t0 = time.perf_counter()
    p = P8.traverse8_plain(qo, qd, p8, t_bound=tb)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    equal = same_bits(k, p)
    bd = k2_wave_bound(p8, qo, qd, tb)
    n, n_live = bd.pop("rays"), bd.pop("live")
    uo, ud, _, ukw = plain_waves[1]
    ub = ukw["t_bound"]
    if int((ub > 0).sum()) != n_live:
        raise AssertionError("the sorted and the identity-order bounce-1 "
                             "wavefronts hold different live rays")
    held, held_plain_order = [], []
    for _ in range(2):  # in turns: compacted, identity order
        held.append(device_ms(lambda: P8._launch(
            "persistent", qo, qd, p8, tb), 20, warm=3))
        held_plain_order.append(device_ms(lambda: P8._launch(
            "persistent", uo, ud, p8, ub), 20, warm=3))
    ms, ms_id = float(np.mean(held)), float(np.mean(held_plain_order))
    runs = dead_runs(tb), dead_runs(ub)
    rec = dict(metric="K2_compacted_ms", wavefront="bounce-1 sort+compact",
               rays=n, live=n_live, dead_runs=runs[0],
               identity_order_dead_runs=runs[1], bitwise=equal,
               value=ms, runs=held, identity_order_ms=ms_id,
               identity_order_runs=held_plain_order, plain_ms=plain_ms,
               mean_pops_per_ray=float(k[5].float().mean()),
               max_pops=int(k[5].max()), **bd,
               share_of_bound=bd["bound_ms"] / ms, gpu=gpu)
    log(json.dumps(rec))
    if not (equal and runs[0] <= buckets and runs[0] < runs[1]):
        raise AssertionError(f"K2 on the compacted wavefront: {rec}")
    return rec


def mesh_integrator(scene, gpu: str):
    """mesh.txt at 1024x1024 depth 8 under slice E's knobs: the --stratified
    --sort --compact path (one iteration with every count set to 0 just
    before it: 8 K2, 8 I1 and 8 S1 launches, nothing else), its image after 2
    iterations bit for bit the identity order's, K2 on its compacted bounce-1
    wavefront (`k2_compacted`), ms an iteration for sort+compact, Russian
    roulette and plain in turns, and the first-bounce cache (no AA, 4
    iterations: 8 K2 launches, then 7 each; within 1e-5 of the uncached
    render). Returns K2's keys for the `kernels` line and the ms an
    iteration of each configuration."""
    from project3_cuda_path_tracer_tpu_torch import Renderer
    from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
    every = lambda *a, **k: True  # noqa: E731
    srt = Renderer(settings_of(scene, stratified=True, sort_materials=True,
                               compact=True), device="cuda")
    plain = Renderer(settings_of(scene, stratified=True), device="cuda")
    zero_counts()
    with capturing(P8, "traverse8", every, limit=8) as sorted_waves:
        srt.step()
    torch.cuda.synchronize()
    counts = read_counts()
    rec = dict(phase="mesh sort+compact path", scene="scenes/mesh.txt",
               flags="--stratified --sort --compact", route=srt.route,
               depth=srt.cfg.trace_depth, iterations=1, **counts)
    log(json.dumps(rec))
    if (srt.route != "wavefront" or counts["k2"] != srt.cfg.trace_depth
            or counts["prim"] != srt.cfg.trace_depth
            or counts["shade"] != srt.cfg.trace_depth
            or any(v for k, v in counts.items()
                   if k not in ("k2", "prim", "shade"))):
        raise AssertionError(f"mesh sort+compact path: {rec}")
    with capturing(P8, "traverse8", every, limit=8) as plain_waves:
        plain.step()
    srt.step()
    plain.step()
    torch.cuda.synchronize()
    equal = torch.equal(srt.accum, plain.accum)
    log(json.dumps(dict(check="mesh 1024x1024 d8 2spp: sort+compact vs "
                              "identity order", bitwise=equal,
                        mean=float(srt.accum.mean() / 2))))
    if not equal:
        raise AssertionError("mesh: the sorted image differs")
    k2c = k2_compacted(gpu, srt.packed_meshes[0], sorted_waves, plain_waves,
                       scene.num_materials + 2)

    # in turns, all three stratified: plain, sort+compact, roulette alone
    rr = Renderer(settings_of(scene, stratified=True, russian_roulette=True),
                  device="cuda")
    times = iteration_ms({"mesh_plain": plain, "mesh_sort_compact": srt,
                          "mesh_russian_roulette": rr}, gpu,
                         "mesh.txt 1024x1024 depth 8 --stratified")

    # the first-bounce cache: no AA, 4 iterations, each with its K2 count
    noaa = settings_of(scene, antialias=False, seed=3)
    cached = Renderer(settings_of(noaa, first_bounce_cache=True),
                      device="cuda")
    per_step = []
    for _ in range(4):
        zero_counts()
        cached.step()
        torch.cuda.synchronize()
        per_step.append(read_counts()["k2"])
    ref = Renderer(noaa, device="cuda")
    ref.render(4)
    gap = float((cached.accum - ref.accum).abs().max() / 4)
    depth = cached.cfg.trace_depth
    rec = dict(check="mesh 1024x1024 d8 first-bounce cache, no AA, 4 spp",
               k2_launches_per_iteration=per_step, max_abs_gap=gap,
               limit=1e-5, route=cached.route)
    log(json.dumps(rec))
    if per_step != [depth] + [depth - 1] * 3 or gap > 1e-5:
        raise AssertionError(f"first-bounce cache: {rec}")
    times.update(iteration_ms({"mesh_first_bounce_cache": cached}, gpu,
                              "mesh.txt 1024x1024 depth 8 no AA, cache"))
    k2 = dict(compacted_launches=counts["k2"], compacted_ms=k2c["value"],
              compacted_identity_order_ms=k2c["identity_order_ms"],
              compacted_plain_ms=k2c["plain_ms"],
              compacted_bound_ms=k2c["bound_ms"],
              compacted_bound_by=k2c["bound_by"], cached_launches=per_step)
    return k2, {k: v["value"] for k, v in times.items()}


def sdf_dispersion(name: str, outdir: str, gpu: str, spp: int = 16) -> dict:
    """scenes/<name>.txt at its own 800x800 depth 8 through `Renderer`: the
    route (wavefront, no K1; I1 alone, one launch a run of primitives a
    bounce) of one iteration with the counts set to 0 before it, one iteration's kernels and busy share (torch.profiler's
    device activity), then an `spp` image whose eager iterations are timed
    by CUDA events (ms an iteration); the card against the CPU at 64x64
    depth 8, stratified, with the share of divergent lanes."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    path = os.path.join(ROOT, "scenes", name + ".txt")
    scene = load_scene(path)
    r = Renderer(scene, device="cuda")
    w, h = scene.camera.resolution
    zero_counts()
    r.step()
    torch.cuda.synchronize()
    counts = read_counts()
    if ((w, h, r.cfg.trace_depth) != (800, 800, 8) or r.route != "wavefront"
            or counts["prim"] != prim_runs(r.cfg) * r.cfg.trace_depth
            or any(v for k, v in counts.items() if k != "prim")):
        raise AssertionError(f"{name}: {w}x{h} d{r.cfg.trace_depth}, route "
                             f"{r.route}, launches {counts}")
    prof = profile_one(r.step, host_ops=False)
    r.reset()
    rec = dict(metric=f"{name}_ms_per_iteration",
               value=time_ms(r.step, spp, warm=0), route=r.route,
               config=f"{name}.txt 800x800 depth 8, the {spp} spp of its "
                      "image",
               gpu=gpu, **prof)
    log(json.dumps(rec))
    img = r.image()
    if not np.isfinite(img).all() or (img < 0).any() or img.mean() <= 0:
        raise AssertionError(f"{name} image is not finite and > 0")
    png = r.save(os.path.join(outdir, f"{name}_800x800_{spp}spp"))
    imgs = []
    for dev in ("cuda", "cpu"):
        small = sized(path, 64, 8)
        small.settings.stratified = True
        imgs.append(Renderer(small, device=dev).render(1).cpu())
    cmp = compare_lanes(f"{name} 64x64 d8: card vs CPU", imgs[0], imgs[1],
                        ATOL, FRAC)
    return dict(ms=rec["value"], kernels=rec.get("kernels_launched"),
                busy=rec.get("device_busy_share"), image=img,
                mean=img.mean(axis=(0, 1)).tolist(), png=png,
                card_vs_cpu_diverged=cmp["diverged_frac"], scene=scene)


def integrator_phases(mesh_scene, outdir: str, gpu: str) -> dict:
    """Slice E on the card (`mesh_integrator`, then the primitive, SDF and
    dispersion scenes): cornell_dof 800x800 d8 --sort --stratified
    (BASELINE config 3) bit for bit with the identity order on the
    wavefront; sdf.txt and dispersion.txt at their own 800x800 d8
    (`sdf_dispersion`), dispersion's red and blue splitting against the
    same scene without dispersion (the JAX tests/test_dispersion.py:40
    check); Russian roulette on cornell against K1's plain render; the
    Sobol sampler's 8-spp RMSE beside the lattice's against a 1,024-spp K1
    reference, both on the wavefront route (the lattice there through the
    first-bounce cache knob, which AA leaves without a cache); the CLI
    with --clamp 4 --gamma 2.2 --aces. Prints its own wall time; returns
    K2's keys for the `kernels` line."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
    t_start = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_start - sum(marks.values())
    k2, mesh_ms = mesh_integrator(mesh_scene, gpu)
    mark("mesh")

    # BASELINE config 3: sorted-by-material shading, 800x800
    dof = load_scene(os.path.join(ROOT, "scenes", "cornell_dof.txt"))
    srt = Renderer(settings_of(dof, 800, 8, stratified=True,
                               sort_materials=True), device="cuda")
    srt.render(2)
    acc = torch.zeros_like(srt.accum)
    cfg = dataclasses.replace(srt.cfg, sort_materials=False)
    for it in range(2):
        acc.add_(PI.to_image(PI.trace_wavefront(
            *srt.tables, cfg, iteration=it), cfg))
    torch.cuda.synchronize()
    equal = torch.equal(acc, srt.accum)
    log(json.dumps(dict(check="cornell_dof 800x800 d8 --sort --stratified "
                              "2spp vs the identity-order wavefront",
                        route=srt.route, bitwise=equal)))
    if srt.route != "wavefront" or not equal:
        raise AssertionError("cornell_dof --sort: the image differs")
    iteration_ms({"cornell_dof_sort": srt}, gpu,
                 "cornell_dof.txt 800x800 depth 8 --sort --stratified")
    mark("cornell_dof")

    # SDFs and dispersion at their own size (sdf.txt's eager iteration takes
    # ~1.6 s: 8 of them; dispersion's 16 feed the split check below)
    res = {name: sdf_dispersion(name, outdir, gpu, spp)
           for name, spp in (("sdf", 8), ("dispersion", 16))}
    flat = res["dispersion"].pop("scene")
    flat.materials.dispersion = torch.zeros_like(flat.materials.dispersion)
    r0 = Renderer(flat, device="cuda")
    r0.render(16)
    img, img0 = res["dispersion"]["image"], r0.image()
    rb, rb0 = (float(np.abs(a[..., 0] - a[..., 2]).mean())
               for a in (img, img0))
    rec = dict(check="dispersion 800x800 d8 16spp: red and blue split",
               mean_abs_red_minus_blue=rb, without_dispersion=rb0,
               channel_means=res["dispersion"]["mean"],
               channel_means_without=img0.mean(axis=(0, 1)).tolist())
    log(json.dumps(rec))
    if not rb > 3.0 * max(rb0, 1e-6):
        raise AssertionError(f"dispersion does not split the bands: {rec}")
    mark("sdf_dispersion")

    # Russian roulette against K1's plain render, 16 spp
    cornell = load_scene(SCENE)
    rr = Renderer(settings_of(cornell, russian_roulette=True),
                  device="cuda")
    rr_it, _ = channel_means(rr, 16)
    zero_counts()
    k1 = Renderer(cornell, device="cuda")
    k1_it, _ = channel_means(k1, 16)
    rel = np.abs(rr_it.mean(0) - k1_it.mean(0)) / k1_it.mean(0)
    rec = dict(check="cornell --russian-roulette 800x800 d8 16spp mean vs "
                     "K1 plain", route=rr.route,
               k1_launches=read_counts()["k1"],
               rr=rr_it.mean(0).tolist(), plain=k1_it.mean(0).tolist(),
               rel_gap=rel.tolist(),
               se_gap=(np.hypot(rr_it.std(0), k1_it.std(0)) / 4).tolist(),
               limit_rel=0.01)
    log(json.dumps(rec))
    if rr.route != "wavefront" or k1.route != "megakernel" or \
            (rel > 0.01).any():
        raise AssertionError(f"Russian roulette mean: {rec}")
    iteration_ms({"cornell_russian_roulette": rr}, gpu,
                 "cornell.txt 800x800 depth 8 --russian-roulette")
    mark("russian_roulette")

    # Sobol against lattice, both on the wavefront route, 8 spp
    ref = Renderer(settings_of(cornell, seed=99), device="cuda")
    ref.render(1024)
    truth = ref.accum / 1024
    rmse, samplers = {}, {}
    for impl in ("sobol", "lattice"):
        r = Renderer(settings_of(cornell, stratified=True, strat_impl=impl,
                                 first_bounce_cache=True), device="cuda")
        if r.route != "wavefront" or r._cached_first_hit() is not None:
            raise AssertionError(f"{impl}: route {r.route}")
        r.render(8)
        rmse[impl] = float(((r.accum / 8 - truth) ** 2).mean().sqrt())
        samplers[f"cornell_{impl}"] = r
    iteration_ms(samplers, gpu, "cornell.txt 800x800 depth 8 --stratified "
                 "--sampler sobol|lattice")
    log(json.dumps(dict(check="cornell 800x800 d8 8spp RMSE vs K1 1024spp",
                        rmse_sobol=rmse["sobol"],
                        rmse_lattice=rmse["lattice"],
                        ratio=rmse["sobol"] / rmse["lattice"], gpu=gpu)))
    mark("samplers")

    cli = subprocess.run(
        [sys.executable, "-m", PKG, SCENE, "--iterations", "4",
         "--device", "cuda", "--clamp", "4", "--gamma", "2.2", "--aces",
         "--metrics", "--outdir", outdir, "--out", "cornell_clamp_cli_4spp"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if cli.returncode != 0 or "route=wavefront" not in cli.stderr:
        raise AssertionError(f"clamp CLI ({cli.returncode}):\n{cli.stderr}")
    metrics = json.loads(cli.stderr.strip().splitlines()[-1])
    if not os.path.exists(metrics["output"]):
        raise AssertionError("clamp CLI wrote no PNG")
    log(json.dumps(dict(phase="clamp gamma aces cli", **metrics)))
    mark("cli")
    seconds = time.perf_counter() - t_start
    log(json.dumps(dict(metric="integrator_summary", seconds=seconds,
                        seconds_by_part=marks,
                        mesh_ms=mesh_ms,
                        sdf_ms=res["sdf"]["ms"],
                        dispersion_ms=res["dispersion"]["ms"],
                        sdf_kernels=res["sdf"]["kernels"],
                        dispersion_kernels=res["dispersion"]["kernels"],
                        sdf_card_vs_cpu=res["sdf"]["card_vs_cpu_diverged"],
                        dispersion_card_vs_cpu=res["dispersion"][
                            "card_vs_cpu_diverged"],
                        rmse_ratio_sobol_lattice=rmse["sobol"]
                        / rmse["lattice"], gpu=gpu)))
    return k2


# The adaptive image's channel means against K1's plain ones at 32 spp on
# 800x800. The standard error of a 32-spp mean over 640,000 pixels is a few
# 0.01% of it, but the adaptive estimate accum / count is not unbiased: the
# count depends on the pixel's own earlier samples (a pixel whose samples
# missed the light keeps a small variance and few samples), so at 32 spp
# the JAX package's own adaptive image reads ~2% below its uniform render
# (tests/torch_adaptive_bias.py). 3% holds the port to that estimator and
# still fails a broken allocation (the JAX package measured -40% without
# its starvation guard) or a scatter that drops repeated pixels.
ADAPTIVE_MEAN_REL = 0.03
# The JAX tests/test_adaptive.py resume contract: counts exact, sums to
# rtol/atol 2e-5 (the two runs may group a pixel's sums differently).
ADAPTIVE_TOL = 2e-5


def timed_replans(r) -> list:
    """Wraps `r._replan`: the host ms of each replan (synchronised on both
    sides) is appended to the returned list."""
    real, ms = r._replan, []

    def replan():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    r._replan = replan
    return ms


def adaptive_cornell(outdir: str, gpu: str, truth: torch.Tensor) -> dict:
    """cornell 800x800 d8 --adaptive --adaptive-epoch 8 --stratified, 32
    iterations with every count set to 0 before them: the wavefront route,
    no kernel launched but I1 (one a bounce); counts summing to exactly
    32 x 640,000 and spread after the replans; the image's channel means within ADAPTIVE_MEAN_REL
    of K1's plain 32-spp render; the 32-spp RMSE against the 1,024-spp K1 reference
    `truth` beside the uniform wavefront render's (printed, not gated); the
    replans' host ms; ms an iteration in turns with the uniform wavefront
    iteration."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    cornell = load_scene(SCENE)
    w, h = cornell.camera.resolution
    spp, npix = 32, w * h
    ra = Renderer(settings_of(cornell, stratified=True, adaptive=True,
                              adaptive_epoch=8), device="cuda")
    replans = timed_replans(ra)
    ran = measured_launches(lambda: ra.step_many(spp))
    counts = {k: ran[k] for k in KERNEL_NAMES}
    cnt = ra.count.astype(np.float64)
    rec = dict(phase="cornell adaptive path", scene="scenes/cornell.txt",
               flags="--adaptive --adaptive-epoch 8 --stratified",
               resolution=[w, h], route=ra.route, depth=ra.cfg.trace_depth,
               iterations=spp, wrapper_counts=ran["wrappers"],
               **counts, count_sum=cnt.sum(), count_std=cnt.std(),
               count_min=cnt.min(), count_max=cnt.max(),
               replan_host_ms=replans, gpu=gpu)
    log(json.dumps(rec))
    if (ra.route != "wavefront"
            or any(v for k, v in counts.items() if k not in ("prim", "shade"))
            or counts["prim"] != spp * ra.cfg.trace_depth
            or counts["shade"] != spp * ra.cfg.trace_depth
            or any(v for k, v in ran["wrappers"].items()
                   if k not in ("prim", "shade"))
            or cnt.sum() != spp * npix or not cnt.std() > 0
            or len(replans) != 3):
        raise AssertionError(f"cornell adaptive path: {rec}")
    k1 = Renderer(cornell, device="cuda")
    k1.render(spp)
    a_mean = ra._mean().double().mean(dim=(0, 1)).cpu().numpy()
    k_mean = (k1.accum / spp).double().mean(dim=(0, 1)).cpu().numpy()
    rel = np.abs(a_mean - k_mean) / k_mean
    rec = dict(check=f"cornell --adaptive {w}x{h} d8 32spp mean vs K1 plain",
               adaptive=a_mean.tolist(), plain=k_mean.tolist(),
               rel_gap=rel.tolist(), limit_rel=ADAPTIVE_MEAN_REL,
               k1_route=k1.route)
    log(json.dumps(rec))
    if k1.route != "megakernel" or (rel > ADAPTIVE_MEAN_REL).any():
        raise AssertionError(f"adaptive mean: {rec}")
    png = ra.save(os.path.join(outdir, "cornell_adaptive_800x800_32spp"))
    uni = Renderer(settings_of(cornell, stratified=True,
                               first_bounce_cache=True), device="cuda")
    if uni.route != "wavefront" or uni._cached_first_hit() is not None:
        raise AssertionError(f"uniform wavefront: route {uni.route}")
    uni.render(spp)
    rmse = {t: float(((m - truth) ** 2).mean().sqrt())
            for t, m in (("adaptive", ra._mean()),
                         ("uniform", uni.accum / spp))}
    log(json.dumps(dict(check=f"cornell {w}x{h} d8 32spp RMSE vs K1 1024spp",
                        rmse_adaptive=rmse["adaptive"],
                        rmse_uniform_wavefront=rmse["uniform"],
                        ratio=rmse["adaptive"] / rmse["uniform"], png=png,
                        gpu=gpu)))
    times = iteration_ms({"cornell_adaptive": ra,
                          "cornell_uniform_wavefront": uni}, gpu,
                         f"cornell.txt {w}x{h} depth 8 --stratified "
                         "[--adaptive --adaptive-epoch 8]")
    return dict(ms=times["cornell_adaptive"]["value"],
                uniform_ms=times["cornell_uniform_wavefront"]["value"],
                replan_ms=replans, rmse_ratio=rmse["adaptive"]
                / rmse["uniform"], mean_rel_gap=float(rel.max()))


def adaptive_mesh(mesh_scene, gpu: str) -> dict:
    """mesh.txt 1024x1024 d8 --adaptive --adaptive-epoch 8 --stratified, the
    cost proxy on: iteration 0 (the identity plan) and iteration 8 (the
    first replanned mapping, every count set to 0 before it: 8 K2 and 8 I1
    launches, nothing else) have their bounce-0/1 K2 wavefronts captured. On the
    replanned ones (repeated pixels, each pixel's paths contiguous) K2
    equals traverse8_plain bit for bit, and is held (stream held, 20
    launches; twice, in turns) beside the identity order's wavefront of the
    same size, with its bound. Then ms an iteration in turns with the plain
    stratified mesh iteration. Returns K2's `adaptive_*` keys."""
    from project3_cuda_path_tracer_tpu_torch import Renderer
    from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        time_ms as device_ms
    every = lambda *a, **k: True  # noqa: E731
    ra = Renderer(settings_of(mesh_scene, stratified=True, adaptive=True,
                              adaptive_epoch=8), device="cuda")
    w, h = mesh_scene.camera.resolution
    depth, npix = ra.cfg.trace_depth, w * h
    with capturing(P8, "traverse8", every, limit=2) as identity_waves:
        ra.step()
    ra.step_many(7)
    replans = timed_replans(ra)
    zero_counts()
    with capturing(P8, "traverse8", every, limit=2) as waves:
        ra.step()
    torch.cuda.synchronize()
    counts = read_counts()
    pix, _, cimg = ra._plan
    cost = ra._cost > 1.0
    share = float(cimg.cpu().numpy()[cost].sum() / npix)
    rec = dict(phase="mesh adaptive path", scene="scenes/mesh.txt",
               flags="--adaptive --adaptive-epoch 8 --stratified",
               resolution=[w, h], route=ra.route, depth=depth, iteration=8,
               **counts,
               replan_host_ms=replans, distinct_pixels=int(
                   (cimg > 0).sum()), max_paths_a_pixel=int(cimg.max()),
               box_pixel_share=float(cost.mean()), box_path_share=share,
               count_sum=float(ra.count.astype(np.float64).sum()), gpu=gpu)
    log(json.dumps(rec))
    if (ra.route != "wavefront" or counts["k2"] != depth
            or counts["prim"] != depth or counts["shade"] != depth
            or any(v for k, v in counts.items()
                   if k not in ("k2", "prim", "shade"))
            or len(replans) != 1 or int(cimg.max()) < 2
            or not bool((pix[1:] >= pix[:-1]).all())
            or rec["count_sum"] != 9 * npix):
        raise AssertionError(f"mesh adaptive path: {rec}")
    p8 = ra.packed_meshes[0]
    out = []
    for b in (0, 1):
        qo, qd, _, kw = waves[b]
        uo, ud, _, ukw = identity_waves[b]
        tb, ub = kw["t_bound"], ukw["t_bound"]
        k = P8.traverse8(qo, qd, p8, t_bound=tb, return_pops=True)
        t0 = time.perf_counter()
        p = P8.traverse8_plain(qo, qd, p8, t_bound=tb)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = same_bits(k, p)
        bd = k2_wave_bound(p8, qo, qd, tb)
        held, held_id = [], []
        for _ in range(2):  # in turns: adaptive, identity order
            held.append(device_ms(lambda: P8._launch(
                "persistent", qo, qd, p8, tb), 20, warm=3))
            held_id.append(device_ms(lambda: P8._launch(
                "persistent", uo, ud, p8, ub), 20, warm=3))
        ms = float(np.mean(held))
        rec = dict(metric="K2_adaptive_ms", wavefront=f"bounce-{b} adaptive",
                   bitwise=equal, value=ms, runs=held,
                   identity_order_ms=float(np.mean(held_id)),
                   identity_order_runs=held_id,
                   identity_order_live=int((ub > 0).sum()),
                   plain_ms=plain_ms,
                   mean_pops_per_ray=float(k[5].float().mean()),
                   max_pops=int(k[5].max()), **bd,
                   share_of_bound=bd["bound_ms"] / ms, gpu=gpu)
        log(json.dumps(rec))
        if not equal or bd["rays"] != npix:
            raise AssertionError(f"K2 on the adaptive wavefront: {rec}")
        out.append(rec)
    plain = Renderer(settings_of(mesh_scene, stratified=True), device="cuda")
    times = iteration_ms({"mesh_adaptive": ra, "mesh_plain": plain}, gpu,
                         f"mesh.txt {w}x{h} depth 8 --stratified "
                         "[--adaptive --adaptive-epoch 8]")
    return dict(adaptive_launches=counts["k2"], adaptive_ms=out[0]["value"],
                adaptive_identity_order_ms=out[0]["identity_order_ms"],
                adaptive_plain_ms=out[0]["plain_ms"],
                adaptive_bound_ms=out[0]["bound_ms"],
                adaptive_bound_by=out[0]["bound_by"],
                adaptive_bounce1_ms=out[1]["value"],
                adaptive_bounce1_identity_order_ms=out[1][
                    "identity_order_ms"],
                adaptive_bounce1_bound_ms=out[1]["bound_ms"],
                adaptive_iteration_ms=times["mesh_adaptive"]["value"],
                plain_iteration_ms=times["mesh_plain"]["value"])


def adaptive_card_vs_cpu(mesh_scene) -> None:
    """cornell and mesh.txt at 64x64 d8, stratified, one iteration under
    one fixed non-uniform plan: the card against the CPU, lane contract."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    from project3_cuda_path_tracer_tpu_torch.render import adaptive as A
    plan = A.plan_from_err(np.random.default_rng(5).gamma(0.5, 1.0,
                                                           (64, 64)))
    for name, scene in (("cornell", load_scene(SCENE)),
                        ("mesh.txt", mesh_scene)):
        small = settings_of(scene, 64, 8, stratified=True, adaptive=True)
        imgs = []
        for dev in ("cuda", "cpu"):
            r = Renderer(small, device=dev)
            r._set_plan(plan)
            r.step()
            imgs.append(r.accum.cpu())
        compare_lanes(f"{name} --adaptive 64x64 d8, one fixed plan: card vs "
                      "CPU", imgs[0], imgs[1], ATOL, FRAC)


def denoise_phase(mesh_scene, outdir: str, gpu: str,
                  truth: torch.Tensor) -> dict:
    """The denoiser on cornell 800x800 (K1's renders): at 4 spp the
    denoised image's RMSE against the 1,024-spp reference `truth` below the
    raw image's; the G-buffer with the mirror relay off and on and the
    filter timed apart (CUDA events; each one's kernels by torch.profiler),
    and the whole `denoised_accum` at 4 spp (relay off) and 64 spp (relay
    on). mesh.txt 1024x1024: one `denoised_accum` with every count set to
    0 before it: its G-buffer's K2 and I1 launch, nothing else. Returns
    the K2 launches."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    from project3_cuda_path_tracer_tpu_torch.render import denoise as dn
    low = Renderer(load_scene(SCENE), device="cuda")
    low.render(4)
    raw = low._mean()
    den = low.denoised_accum() / 4
    rmse = {t: float(((m - truth) ** 2).mean().sqrt())
            for t, m in (("raw", raw), ("denoised", den))}
    png = low.save(os.path.join(outdir, "cornell_denoised_4spp"),
                   denoise=True)
    rec = dict(check="cornell d8 4spp denoised RMSE vs raw, K1 1024spp "
                     "reference", resolution=list(low.scene.camera.resolution),
               rmse_raw=rmse["raw"],
               rmse_denoised=rmse["denoised"],
               ratio=rmse["denoised"] / rmse["raw"], png=png, gpu=gpu)
    log(json.dumps(rec))
    if not rmse["denoised"] < rmse["raw"]:
        raise AssertionError(f"denoise: {rec}")
    parts = {}
    for relay in (False, True):
        def gbuf(relay=relay):
            return dn.gbuffer(low.scene, low.cfg, low.packed_meshes,
                              albedo=True, relay=relay, tables=low.tables)
        parts[f"gbuffer_relay_{'on' if relay else 'off'}"] = gbuf
    normal, pos, alb = dn.gbuffer(low.scene, low.cfg, low.packed_meshes,
                                  albedo=True, relay=False,
                                  tables=low.tables)
    parts["filter"] = lambda: dn.atrous_denoise(raw, normal, pos, albedo=alb)
    parts["denoised_accum_4spp"] = low.denoised_accum
    w, h = low.scene.camera.resolution
    config = f"cornell.txt {w}x{h}"
    out = {}
    for tag, fn in parts.items():
        out[tag] = dict(metric=f"denoise_{tag}_ms",
                        value=time_ms(fn, 3, warm=1), gpu=gpu, config=config,
                        **profile_one(fn, host_ops=False))
        log(json.dumps(out[tag]))
    low.render(60)
    rmse64 = {t: float(((m - truth) ** 2).mean().sqrt())
              for t, m in (("raw", low._mean()),
                           ("denoised", low.denoised_accum() / 64))}
    out["denoised_accum_64spp"] = dict(
        metric="denoise_denoised_accum_64spp_ms",
        value=time_ms(low.denoised_accum, 3, warm=1),
        rmse_raw=rmse64["raw"], rmse_denoised=rmse64["denoised"],
        relay=True, config=config, gpu=gpu)
    log(json.dumps(out["denoised_accum_64spp"]))
    rm = Renderer(mesh_scene, device="cuda")
    rm.step()
    zero_counts()
    img = rm.denoised_accum()
    torch.cuda.synchronize()
    counts = read_counts()
    rec = dict(phase="mesh denoise G-buffer", scene="scenes/mesh.txt",
               resolution=list(mesh_scene.camera.resolution), **counts,
               finite=bool(torch.isfinite(img).all()),
               ms=time_ms(rm.denoised_accum, 2, warm=0), gpu=gpu)
    log(json.dumps(rec))
    if (counts["k2"] != 1 or counts["prim"] != 1
            or any(v for k, v in counts.items() if k not in ("k2", "prim"))
            or not rec["finite"]):
        raise AssertionError(f"mesh denoise: {rec}")
    return dict(gbuffer_launches=counts["k2"],
                **{k: v["value"] for k, v in out.items()})


def checkpoint_cli(outdir: str) -> dict:
    """Checkpoint and resume through the CLI, each mode as two chains run
    at once (six processes): --iterations 16 --checkpoint-every 8, then
    --iterations 32 --checkpoint-every 8 --resume; and 32 iterations in one
    run. The final checkpoints (iteration 32) must agree: cornell uniform
    (K1, draws from (seed, iteration)) bit for bit; cornell --adaptive
    --adaptive-epoch 12 --stratified (resumed at 16, mid-epoch) with equal
    counts and sums within 2e-5; lights.txt --restir 8 within 2e-5, and
    whether it is bit for bit is printed."""
    import concurrent.futures as cf
    ckdir = os.path.join(outdir, "checkpoints")
    os.makedirs(ckdir, exist_ok=True)
    modes = {"uniform": (SCENE, []),
             "adaptive": (SCENE, ["--adaptive", "--adaptive-epoch", "12",
                                  "--stratified"]),
             "restir": (LIGHTS, ["--restir", "8"])}

    def cmd(mode, out, iters, *extra):
        scene, flags = modes[mode]
        return [sys.executable, "-m", PKG, scene, "--device", "cuda",
                "--iterations", str(iters), "--checkpoint-every", "8",
                "--outdir", ckdir, "--out", out, "--metrics", *flags, *extra]

    def chain(cmds):
        done = []
        for c in cmds:
            done.append(subprocess.run(c, cwd=ROOT, capture_output=True,
                                       text=True, timeout=600))
            if done[-1].returncode != 0:
                break
        return done

    chains = {}
    for mode in modes:
        chains[(mode, "split")] = [cmd(mode, f"{mode}_split", 16),
                                   cmd(mode, f"{mode}_split", 32,
                                       "--resume")]
        chains[(mode, "whole")] = [cmd(mode, f"{mode}_whole", 32)]
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=len(chains)) as pool:
        futs = {k: pool.submit(chain, v) for k, v in chains.items()}
        results = {k: f.result() for k, f in futs.items()}
    wall = time.perf_counter() - t0
    for key, runs in results.items():
        for run in runs:
            if run.returncode != 0:
                raise AssertionError(f"checkpoint CLI {key} failed "
                                     f"({run.returncode}):\n{run.stderr}")
    out = dict(wall_s=wall)
    from project3_cuda_path_tracer_tpu_torch.render import checkpoint as ck
    for mode, (scene, _) in modes.items():
        resumed = results[(mode, "split")][1].stderr
        if "at iteration 16" not in resumed:
            raise AssertionError(f"{mode}: the second run did not resume at "
                                 f"16:\n{resumed}")
        files = [os.path.join(ckdir, f"{mode}_{k}.ckpt.npz")
                 for k in ("split", "whole")]
        (a, it_a, _), (b, it_b, _) = (ck.load_checkpoint(f, scene)
                                      for f in files)
        xa, xb = (ck.load_extras(f) for f in files)
        bitwise = bool(np.array_equal(a, b)) and all(
            np.array_equal(xa[k], xb[k]) for k in xa)
        gap = float(np.abs(a.astype(np.float64) - b).max())
        close = bool(np.allclose(a, b, rtol=ADAPTIVE_TOL, atol=ADAPTIVE_TOL))
        counts_equal = (mode != "adaptive"
                        or np.array_equal(xa["count"], xb["count"]))
        rec = dict(check=f"CLI {mode} resume 16 -> 32 vs uninterrupted 32",
                   scene=os.path.relpath(scene, ROOT), iterations=[it_a,
                                                                   it_b],
                   bitwise=bitwise, max_abs_gap=gap, within_2e_5=close,
                   counts_equal=bool(counts_equal), extras=sorted(xa),
                   mean=float(a.mean() / 32))
        if mode == "adaptive":
            rec["count_std"] = float(xa["count"].std())
        log(json.dumps(rec))
        if (it_a != 32 or it_b != 32 or not counts_equal
                or not (bitwise if mode == "uniform" else close)
                or (mode == "adaptive" and not rec["count_std"] > 0)):
            raise AssertionError(f"checkpoint resume: {rec}")
        out[mode] = dict(bitwise=bitwise, max_abs_gap=gap)
    return out


def services_phases(mesh_scene, outdir: str, gpu: str) -> dict:
    """Slice F on the card: adaptive sampling on cornell 800x800 d8
    (`adaptive_cornell`) and mesh.txt 1024x1024 d8 (`adaptive_mesh`), the
    card against the CPU under a fixed plan (`adaptive_card_vs_cpu`), the
    denoiser with its G-buffer (`denoise_phase`), `compaction_ratios` on
    mesh.txt at 1024x1024, and checkpoint/resume through the CLI
    (`checkpoint_cli`). Prints its own wall time by part; returns K2's keys
    for the `kernels` line."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    from project3_cuda_path_tracer_tpu_torch.render import diagnostics
    t_start = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_start - sum(marks.values())
    ref = Renderer(settings_of(load_scene(SCENE), seed=99), device="cuda")
    ref.render(1024)
    truth = ref.accum / 1024
    mark("reference")
    cornell = adaptive_cornell(outdir, gpu, truth)
    mark("adaptive_cornell")
    k2 = adaptive_mesh(mesh_scene, gpu)
    mark("adaptive_mesh")
    adaptive_card_vs_cpu(mesh_scene)
    mark("card_vs_cpu")
    dn = denoise_phase(mesh_scene, outdir, gpu, truth)
    k2["gbuffer_launches"] = dn.pop("gbuffer_launches")
    mark("denoise")
    ratios = diagnostics.compaction_ratios(mesh_scene, device="cuda")
    rec = dict(check="compaction_ratios mesh.txt",
               resolution=list(mesh_scene.camera.resolution),
               ratios=ratios.tolist())
    log(json.dumps(rec))
    if ratios[0] != 1.0 or (np.diff(ratios) > 0).any():
        raise AssertionError(f"compaction ratios: {rec}")
    mark("diagnostics")
    ck = checkpoint_cli(outdir)
    mark("checkpoint_cli")
    log(json.dumps(dict(metric="services_summary",
                        seconds=time.perf_counter() - t_start,
                        seconds_by_part=marks, cornell_adaptive=cornell,
                        mesh_adaptive_ms=k2["adaptive_iteration_ms"],
                        mesh_plain_ms=k2["plain_iteration_ms"],
                        denoise_ms=dn, compaction_ratios=ratios.tolist(),
                        checkpoints=ck, gpu=gpu)))
    return k2


# ---------------------------------------------------------------------------
# Slices G and H and the train step through every scene
# ---------------------------------------------------------------------------

GB = 1e9


def train_step_run(name: str, gpu: str, capture: bool = False) -> dict:
    """scenes/<name>.txt at its own size through InverseRenderer's history
    step, under the memory schedule of `models.inverse.train_config`'s
    rule: the history seeded by one render, then, with every count set to
    0 and the peak memory reset, one (eager) step timed by CUDA events,
    its K2 and P1 launches counted (with `capture`, its K2 rays and texel
    fetches kept)."""
    import gc
    from project3_cuda_path_tracer_tpu_torch import load_scene
    from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
    from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
    from project3_cuda_path_tracer_tpu_torch.ops import texfetch
    scene = load_scene(os.path.join(ROOT, "scenes", name + ".txt"))
    w, h = scene.camera.resolution
    every = lambda *a, **k: True  # noqa: E731
    ir = PInv.InverseRenderer(scene, np.full((h, w, 3), 0.3, np.float32),
                              device="cuda")
    cfg = ir.cfg
    fetches = waves = []
    ir.seed_history()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    with contextlib.ExitStack() as stack:
        if capture:
            # the forward's bounce 0 and 1 (cloned: kept out of the peak's
            # baseline by their small count)
            fetches = stack.enter_context(capturing(
                texfetch, "take_u32", every))
            waves = stack.enter_context(capturing(P8, "traverse8", every))
        losses = [ir.step()]
    stop.record()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    rec = dict(metric="train_step_ms", scene=f"scenes/{name}.txt",
               value=start.elapsed_time(stop),
               host_wall_ms=(time.perf_counter() - t0) * 1e3,
               config=f"{name}.txt {w}x{h} depth {cfg.trace_depth}, "
                      f"history step, remat {cfg.remat}",
               remat=cfg.remat, peak_memory_bytes=peak, peak_gb=peak / GB,
               k2_launches_per_step=counts["k2"],
               gather_launches_per_step=counts["p1"], counts=counts,
               losses=losses, gpu=gpu)
    log(json.dumps(rec))
    packed = ir.packed_meshes[0] if ir.packed_meshes else None
    del ir
    gc.collect()
    torch.cuda.empty_cache()
    if not np.isfinite(rec["losses"]).all():
        raise AssertionError(f"{name} train step: non-finite loss {rec}")
    return dict(rec=rec, fetches=fetches, waves=waves, packed=packed)


def train_textured_phases(gpu: str) -> dict:
    """The train step through textured, SDF and dispersive scenes:
    textured_env at its own 2048x2048 depth 8 (remat by the rule: the torus
    is a mesh), sdf.txt (remat by the rule: SDF geoms) and dispersion.txt
    (no remat) at 800x800 depth 8, one step each under the rule's
    schedule; K2 and P1 held bit for
    bit against their plain versions on the textured step's own bounce-0
    and bounce-1 inputs; the card against the CPU at 64x64 depth 8.
    Returns the launches for the `kernels` line."""
    from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
    recs = {}
    tex = train_step_run("textured_env", gpu, capture=True)
    r = tex["rec"]
    # remat: each bounce's K2 walk and fused fetch run again in the backward
    depth = 8
    if not (r["remat"] and r["counts"]["k2"] == 2 * depth
            and r["counts"]["p1"] == 2 * depth and r["counts"]["k1"] == 0
            and r["counts"]["prim"] == 0
            and len(tex["fetches"]) == len(tex["waves"]) == 2):
        raise AssertionError(f"textured train step: {r}")
    recs["textured_env"] = r
    # the texel fetches of the forward pass's bounces 0 and 1 (the first
    # two; the recompute repeats them), and the torus's K2 rays
    p1 = p1_on_path(gpu, tex["fetches"][:2])
    k2 = k2_torus(gpu, tex["packed"], tex["waves"][:2], any_hit=False)
    del tex
    # sdf.txt takes remat by the rule (the eager march's saved planes);
    # dispersion.txt does not. The schedules the rule leaves out are not
    # run (their times are in PERF.md section 5). Neither launches a
    # traversal or fetch kernel; G1 runs in every step's backward. No step
    # launches I1: the camera is a parameter, so every bounce's rays take a
    # gradient and each primitive test runs the chain.
    for name, rule_remat in (("sdf", True), ("dispersion", False)):
        rule = train_step_run(name, gpu)["rec"]
        counts = rule["counts"]
        if not (rule["remat"] == rule_remat and counts["mat_grad"] > 0
                and not any(v for k, v in counts.items()
                            if k != "mat_grad")):
            raise AssertionError(f"{name} train step: {rule}")
        recs[name] = rule
    for name in ("textured_env", "sdf", "dispersion"):
        small = sized(os.path.join(ROOT, "scenes", name + ".txt"), 64, 8)
        small.settings.stratified = True
        cfg = dataclasses.replace(PInv.train_config(small), stratified=True)
        grads_card_vs_cpu(small, f"train grads card vs cpu {name} 64x64 d8",
                          cfg)
    log(json.dumps(dict(metric="train_textured_summary", gpu=gpu, **{
        k: dict(ms=v["value"], peak_gb=v["peak_gb"], remat=v["remat"],
                k2=v["k2_launches_per_step"],
                p1=v["gather_launches_per_step"])
        for k, v in recs.items()})))
    return dict(k2_launches=r["counts"]["k2"],
                gather_launches=r["counts"]["p1"], p1=p1, k2=k2)


SHARD_ITERS = 4


def shard_worker(init: str, rank: int, world: int, out: str) -> int:
    """One rank of the 2-rank gloo run (`chip_smoke.py --shard-worker`):
    cornell 800x800 depth 8, stratified, through ShardedRenderer on card 0
    with CUDA tensors over gloo, SHARD_ITERS iterations; then the sharded
    history loss's gradients at 64x64 depth 8. Rank 0 writes the gathered
    image and the summed gradients to `out`."""
    sys.path.insert(0, ROOT)
    from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
    from project3_cuda_path_tracer_tpu_torch.parallel import sharding
    os.environ["LOCAL_RANK"] = "0"
    sharding.init_distributed("gloo", f"file://{init}", world, rank)
    try:
        scene = sized(SCENE, 800, 8)
        scene.settings.stratified = True
        r = sharding.ShardedRenderer(scene, device="cuda")
        r.render(SHARD_ITERS)
        img = r.image()
        small = sized(SCENE, 64, 8)
        loss, grads = shard_train_grads(small, sharding, PInv)
    finally:
        sharding.shutdown()
    if rank == 0:
        np.savez(out, image=img, loss=loss.cpu().numpy(),
                 **{f"g{i}": g.cpu().numpy() for i, g in enumerate(grads)
                    if g is not None})
    return 0


def shard_train_grads(scene, sharding, PInv):
    """The sharded history loss's all-reduced (loss, gradients) on `scene`,
    pseudo-random draws from step_generator(4, 0), target 0.3, residual 1."""
    w, h = scene.camera.resolution
    dev = torch.device("cuda")
    cfg, _ = sharding.make_train_step_sharded(scene, dev)
    tables, packed, meshes = sharding.shard_scene(scene, dev)
    lo, hi = sharding.row_block(h, sharding.dist.get_world_size(),
                                sharding.dist.get_rank())
    params = PInv.params_from_scene(scene, dev)
    tgt = torch.full((hi - lo, w, 3), 0.3, device=dev)
    res = torch.ones((hi - lo, w, 3), device=dev)
    loss, _ = sharding.history_loss_sharded(
        params, tables, cfg, tgt, res, packed, meshes,
        PInv.step_generator(4, 0, dev))
    return sharding.all_reduce_grads(loss, PInv.param_leaves(params))


def sharding_phases(mesh_scene, outdir: str, gpu: str) -> dict:
    """Slice G on the card: mesh.txt 1024x1024 depth 8 through
    ShardedRenderer in a world of one over NCCL, against the single-process
    Renderer (the same wavefront route) to 1e-5, its K2, I1 and S1
    launches counted (one each a bounce), ms an iteration in turns with the single process; the sharded history
    loss's gradients at world one against the single process; then two
    ranks on the one card over gloo with CUDA tensors (two processes of
    this script, `--shard-worker`), their gathered cornell image and
    summed gradients against the single process. Returns K2's launches."""
    from project3_cuda_path_tracer_tpu_torch import Renderer
    from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
    from project3_cuda_path_tracer_tpu_torch.parallel import sharding
    t0 = time.perf_counter()
    sharding.init_distributed("nccl")
    try:
        if sharding.dist.get_backend() != "nccl":
            raise AssertionError("world of one is not on nccl")
        scene = settings_of(mesh_scene)
        sh = sharding.ShardedRenderer(scene, device="cuda")
        single = Renderer(scene, device="cuda")
        ran = measured_launches(lambda: sh.step_many(SHARD_ITERS))
        counts = {k: ran[k] for k in KERNEL_NAMES}
        single.step_many(SHARD_ITERS)
        gap = float(np.abs(sh.image() - single.image()).max())
        runs = {"sharded": [], "single": []}
        for k in ("sharded", "single", "single", "sharded"):
            rr = sh if k == "sharded" else single
            runs[k].append(time_ms(rr.step, 2, warm=0))
        small = sized(SCENE, 64, 8)
        loss, grads = shard_train_grads(small, sharding, PInv)
    finally:
        sharding.shutdown()
    want_loss, want_grads = single_train_grads(small, PInv)
    grad_err = max_rel(grads, want_grads)
    rec = dict(metric="sharded_ms_per_iteration", backend="nccl", world=1,
               scene="scenes/mesh.txt", resolution=[1024, 1024], depth=8,
               value=float(np.mean(runs["sharded"])),
               single_process_ms=float(np.mean(runs["single"])), runs=runs,
               max_abs_gap=gap, atol=1e-5, k2_launches=counts["k2"],
               counts=counts, wrapper_counts=ran["wrappers"],
               train_loss=float(loss),
               single_train_loss=float(want_loss),
               train_grad_max_rel_err=grad_err, gpu=gpu)
    log(json.dumps(rec))
    if (gap > 1e-5 or counts["k2"] != 8 * SHARD_ITERS or counts["k1"]
            or counts["prim"] != 8 * SHARD_ITERS
            or counts["shade"] != 8 * SHARD_ITERS
            or not ran["wrappers"]["k2"] or grad_err > 1e-4
            or abs(float(loss) - float(want_loss)) > 1e-5 * abs(
                float(want_loss))):
        raise AssertionError(f"sharded world 1: {rec}")

    # two ranks on the one card over gloo
    # absolute: a file:// URL's path (and the workers' cwd is ROOT)
    init = os.path.abspath(os.path.join(outdir, "gloo_store"))
    out = os.path.abspath(os.path.join(outdir, "gloo_out.npz"))
    for f in (init, out):
        if os.path.exists(f):
            os.remove(f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-worker", init,
         str(rank), "2", out], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=300)[1][-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in procs):
        raise AssertionError(f"gloo ranks failed: {errs}")
    with np.load(out) as f:
        got = dict(f)
    for f in (init, out):  # gloo's store may have removed its file
        if os.path.exists(f):
            os.remove(f)
    scene = sized(SCENE, 800, 8)
    scene.settings.stratified = True
    ref = Renderer(scene, device="cuda", route="wavefront")
    ref.render(SHARD_ITERS)
    gap2 = float(np.abs(got["image"] - ref.image()).max())
    g2 = [torch.from_numpy(got[f"g{i}"]) if f"g{i}" in got else None
          for i in range(len(want_grads))]
    err2 = max_rel(g2, want_grads)
    rec2 = dict(check="sharded 2 ranks gloo cuda tensors vs single process",
                scene="scenes/cornell.txt", resolution=[800, 800], depth=8,
                iterations=SHARD_ITERS, max_abs_gap=gap2, atol=1e-5,
                train_loss=float(got["loss"]),
                single_train_loss=float(want_loss),
                train_grad_max_rel_err=err2,
                seconds=time.perf_counter() - t0, gpu=gpu)
    log(json.dumps(rec2))
    if (gap2 > 1e-5 or err2 > 1e-4 or abs(float(got["loss"])
                                          - float(want_loss))
            > 1e-5 * abs(float(want_loss))):
        raise AssertionError(f"sharded 2 ranks: {rec2}")
    return dict(k2_launches=counts["k2"], ms=rec["value"],
                single_ms=rec["single_process_ms"])


def single_train_grads(scene, PInv):
    """The single-process history loss and gradients on the inputs of
    `shard_train_grads`."""
    from project3_cuda_path_tracer_tpu_torch.ops import texfetch
    from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
    w, h = scene.camera.resolution
    dev = torch.device("cuda")
    cfg = PInv.train_config(scene)
    params = PInv.params_from_scene(scene, dev)
    loss, _ = PInv.history_residual_grad_loss(
        params, PI.to_device(scene.geoms, dev), PI.to_device(scene.meshes,
                                                             dev),
        texfetch.fuse(PI.to_device(scene.textures, dev)),
        PInv.step_generator(4, 0, dev), cfg,
        torch.full((h, w, 3), 0.3, device=dev),
        torch.ones((h, w, 3), device=dev))
    return loss.detach(), PInv._grads(loss, PInv.param_leaves(params))


def max_rel(got, want) -> float:
    """The largest relative gap between two gradient lists (None on both
    sides where a leaf takes none; a None against a tensor is infinite)."""
    err = 0.0
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            return float("inf")
        if w is not None:
            g, w = g.cpu().double(), w.cpu().double()
            err = max(err, float(((g - w).abs() / (w.abs() + 1e-6)).max()))
    return err


def preview_phase(outdir: str, gpu: str) -> dict:
    """Slice H on the card: the preview server (port 0) over cornell
    800x800 depth 8 on the megakernel route; four iterations, a frame,
    POST /orbit, then with the counts set to 0 four more iterations, which
    must be four K1 launches on the new camera: the frame equals a fresh
    Renderer's at the orbited camera, bit for bit, and differs from the
    old view. Returns K1's launches."""
    import urllib.request
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    from project3_cuda_path_tracer_tpu_torch.app.preview import PreviewServer
    from project3_cuda_path_tracer_tpu_torch.utils import image as img_io
    r = Renderer(load_scene(SCENE), device="cuda")
    if r.route != "megakernel":
        raise AssertionError(f"preview: route {r.route}")
    srv = PreviewServer(r, port=0).start()

    def get(path, data=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}{path}", data=data,
            method="POST" if data is not None else "GET")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read()
    try:
        srv.step_many(4)
        before = get("/frame.png")
        t0 = time.perf_counter()
        get("/orbit?dphi=0.35&dtheta=-0.1&dzoom=-1.5", b"")
        orbit_ms = (time.perf_counter() - t0) * 1e3
        zero_counts()
        srv.step_many(4)
        torch.cuda.synchronize()
        counts = read_counts()
        frame = get("/frame.png")
        state = json.loads(get("/state"))
    finally:
        srv.stop()
    fresh_scene = load_scene(SCENE)
    fresh_scene.camera = copy.deepcopy(r.scene.camera)
    fresh = Renderer(fresh_scene, device="cuda")
    fresh.render(4)
    want = img_io.encode_png((np.clip(fresh.image(), 0, 1) * 255)
                             .astype(np.uint8))
    with open(os.path.join(outdir, "preview_orbit_4spp.png"), "wb") as f:
        f.write(frame)
    rec = dict(phase="preview orbit", scene="scenes/cornell.txt",
               resolution=[800, 800], depth=8, state=state,
               k1_launches=counts["k1"], counts=counts,
               frame_equals_fresh_renderer=frame == want,
               differs_from_old_view=frame != before, orbit_ms=orbit_ms,
               png=os.path.join(outdir, "preview_orbit_4spp.png"), gpu=gpu)
    log(json.dumps(rec))
    if not (counts["k1"] == 4 and frame == want and frame != before
            and state["iteration"] == 4
            and sum(counts.values()) == counts["k1"]):
        raise AssertionError(f"preview: {rec}")
    return dict(k1_launches=counts["k1"])


# the counts of KERNEL_NAMES a chunk's graph may hold
CHUNK_KERNELS = ("k2", "k2_any_hit", "k3_k4", "p1", "prim", "shade",
                 "shade_index")


def chunk_measure(tag: str, eager, chunk, n: int, ran: dict, window: int,
                  gpu: str, config: str, s1: tuple, k: int = 3,
                  **extra) -> dict:
    """After `eager` took n step() calls and `chunk` n iterations, the last
    `window` of them one run of step_many measured by `measured_launches`
    (`ran`): the states bit for bit (`same_state`); ms an iteration of both
    forms in turns (eager, graph, graph, eager; CUDA events around k
    iterations each, the host's side included); one replay under
    torch.profiler's device activity (kernels, busy share, the
    replay's kernels by name, printed: the profiler loses a few records of
    a run now and then, so it counts no launch that is checked); the
    graph's launches a replay, capture and instantiate seconds and pool
    bytes. Raises unless the states are equal, the graph holds `s1`
    launches of S1 a replay (its shade entry, its index entry), and the
    kernels' device tallies show each kernel of CHUNK_KERNELS launched
    `window` times the graph's launches a replay over the measured run and
    once that over the profiled replay."""
    from project3_cuda_path_tracer_tpu_torch.render.integrator import \
        same_state
    from project3_cuda_path_tracer_tpu_torch.utils.launches import \
        device_launches
    torch.cuda.synchronize()
    equal = same_state(eager, chunk)
    g = chunk.graph
    if g is None:
        raise AssertionError(f"chunk {tag}: nothing was captured")
    per = {key: g.launches[key] for key in CHUNK_KERNELS}
    runs = {"eager": [], "graph": []}
    for form in ("eager", "graph", "graph", "eager"):
        fn = eager.step if form == "eager" else (lambda: chunk.step_many(1))
        runs[form].append(time_ms(fn, k, warm=0))
    zero_counts()
    prof = profile_one(lambda: chunk.step_many(1), host_ops=False,
                       named=True)
    replay_ran = device_launches()
    ms = {f: float(np.mean(v)) for f, v in runs.items()}
    named = {key: prof["named_launches"][key] for key in CHUNK_KERNELS}
    launches = {key: ran[key] for key in CHUNK_KERNELS}
    replay_launches = {key: replay_ran[key] for key in CHUNK_KERNELS}
    rec = dict(metric=f"chunk_{tag}", config=config, bitwise=equal,
               iterations=n, ms_per_iteration_eager=ms["eager"],
               ms_per_iteration_graph=ms["graph"],
               eager_over_graph=ms["eager"] / ms["graph"], runs=runs,
               launches_per_replay=per, measured_iterations=window,
               launches=launches, wrapper_counts=ran["wrappers"],
               replay_launches=replay_launches,
               replay_named_launches=named, replays=g.replays,
               capture_s=g.capture_s, instantiate_s=g.instantiate_s,
               pool_bytes=g.pool_bytes,
               replay_kernels=prof.get("kernels_launched"),
               replay_device_busy_share=prof.get("device_busy_share"),
               replay_device_us=prof.get("device_us"),
               replay_top_kernels=prof.get("top_kernels"), gpu=gpu,
               **extra)
    log(json.dumps(rec))
    if not equal:
        raise AssertionError(f"chunk {tag}: the replayed state differs from "
                             "the eager loop's")
    if (per["shade"], per["shade_index"]) != s1:
        raise AssertionError(f"chunk {tag}: S1 {per['shade']} + "
                             f"{per['shade_index']} launches a replay, not "
                             f"{s1[0]} + {s1[1]}")
    if replay_launches != per:
        raise AssertionError(f"chunk {tag}: a replay launched "
                             f"{replay_launches}, the capture counted {per}")
    if launches != {key: window * per[key] for key in CHUNK_KERNELS}:
        raise AssertionError(f"chunk {tag}: {window} iterations launched "
                             f"{launches}, {per} a replay")
    return rec


def chunk_config(tag: str, make, n: int, gpu: str, config: str,
                 s1: tuple = (8, 0), k: int = 3, **extra) -> dict:
    """Two Renderers from `make()`: n eager step() calls on one, step_many(n)
    on the other measured by `measured_launches` (`chunk_measure`)."""
    eager, chunk = make(), make()
    if not chunk.chunkable():
        raise AssertionError(f"chunk {tag}: route {chunk.route} not "
                             "chunkable")
    ran = measured_launches(lambda: chunk.step_many(n))
    for _ in range(n):
        eager.step()
    return chunk_measure(tag, eager, chunk, n, ran, n, gpu, config, s1, k,
                         **extra)


def chunk_phases(mesh_scene, outdir: str, gpu: str) -> dict:
    """Slice I on the card: each configuration renders n iterations as n
    eager step() calls and as step_many(n) (one eager iteration, the
    capture, n - 1 replays) from the same start, held bit for bit and
    measured by `chunk_measure`. The preview's wavefront render: while its
    loop runs, POST /orbit and a frame, each timed from request to reply;
    then the replays after the orbit against a fresh Renderer's eager
    steps at the new camera. Returns the kernels' measured launches and
    the records."""
    import threading
    import urllib.request
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    from project3_cuda_path_tracer_tpu_torch.app.preview import PreviewServer
    from project3_cuda_path_tracer_tpu_torch.parallel import sharding
    t_start = time.perf_counter()
    cornell = load_scene(SCENE)
    recs = {}
    recs["mesh"] = chunk_config(
        "mesh", lambda: Renderer(settings_of(mesh_scene, stratified=True),
                                 device="cuda"), 4, gpu,
        "mesh.txt 1024x1024 depth 8 --stratified")
    recs["mesh_sort_compact"] = chunk_config(
        "mesh_sort_compact", lambda: Renderer(settings_of(
            mesh_scene, stratified=True, sort_materials=True, compact=True),
            device="cuda"), 4, gpu,
        "mesh.txt 1024x1024 depth 8 --stratified --sort --compact")
    textured = load_scene(TEXTURED)
    recs["textured_env"] = chunk_config(
        "textured_env", lambda: Renderer(textured, device="cuda"), 3, gpu,
        "textured_env.txt 2048x2048 depth 8", s1=(8, 8))
    recs["cornell_nee"] = chunk_config(
        "cornell_nee", lambda: Renderer(nee_scene(SCENE, 800, 8, nee=True),
                                        device="cuda", route="wavefront"),
        4, gpu, "cornell.txt 800x800 depth 8 --nee (Philox draws)")
    recs["manylights_restir"] = chunk_config(
        "manylights_restir", lambda: Renderer(
            nee_scene(MANY, 800, 5, seed=3, restir=8), device="cuda"), 4,
        gpu, "manylights.txt 800x800 depth 5 --restir 8", s1=(0, 0))
    sdf = load_scene(os.path.join(ROOT, "scenes", "sdf.txt"))
    recs["sdf"] = chunk_config(
        "sdf", lambda: Renderer(sdf, device="cuda"), 3, gpu,
        "sdf.txt 800x800 depth 8", s1=(0, 0), k=2)
    # two replans (iterations 8 and 16) inside the chunk; the timed runs
    # cross the one at 24 in both forms
    made = []  # (renderer, its replans' host ms): the eager one, the chunk

    def adaptive():
        r = Renderer(settings_of(cornell, stratified=True, adaptive=True,
                                 adaptive_epoch=8), device="cuda")
        made.append((r, timed_replans(r)))
        return r
    recs["cornell_adaptive"] = chunk_config(
        "cornell_adaptive", adaptive, 20, gpu,
        "cornell.txt 800x800 depth 8 --adaptive --adaptive-epoch 8 "
        "--stratified", replans_in_chunk=2)
    chunk_r, chunk_replans = made[1]
    if len(chunk_replans) < 2 or not chunk_r._count.std() > 0:
        raise AssertionError("chunk cornell_adaptive: replans "
                             f"{chunk_replans}")

    sharding.init_distributed("nccl")
    try:
        recs["sharded_mesh"] = chunk_config(
            "sharded_mesh", lambda: sharding.ShardedRenderer(
                settings_of(mesh_scene, stratified=True), device="cuda"), 4,
            gpu, "mesh.txt 1024x1024 depth 8 --stratified, ShardedRenderer "
            "world 1 (NCCL)")
    finally:
        sharding.shutdown()

    # the preview over a wavefront render: an eager iteration, the capture
    # and replays, one at a time under the server's lock
    r = Renderer(settings_of(cornell), device="cuda", route="wavefront")
    srv = PreviewServer(r, port=0).start()

    def request(path, data=None) -> float:
        """ms from the request to the end of the reply."""
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}{path}", data=data,
            method="POST" if data is not None else "GET")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=60) as resp:
            resp.read()
        return (time.perf_counter() - t0) * 1e3
    loop_iters = 24
    try:
        srv.step_many(4)
        g = r.graph
        loop = threading.Thread(target=srv.step_many, args=(loop_iters,))
        loop.start()
        while r.iteration < 12 and loop.is_alive():
            time.sleep(0.001)
        orbit_ms = request("/orbit?dphi=0.35&dtheta=-0.1&dzoom=-1.5", b"")
        frame_ms = request("/frame.png")
        orbit_during_loop = loop.is_alive()
        loop.join()
        ran = measured_launches(lambda: srv.step_many(4))
    finally:
        srv.stop()
    fresh_scene = load_scene(SCENE)
    fresh_scene.camera = copy.deepcopy(r.scene.camera)
    fresh = Renderer(fresh_scene, device="cuda", route="wavefront")
    for _ in range(r.iteration):
        fresh.step()
    if r.graph is not g or g.replays != 3 + loop_iters + 4:
        raise AssertionError("preview: the orbit dropped the graph")
    recs["preview_orbit"] = chunk_measure(
        "preview_orbit", fresh, r, r.iteration, ran, 4, gpu,
        "cornell.txt 800x800 depth 8 on the wavefront route, through the "
        "preview after POST /orbit", (8, 0), orbit_ms=orbit_ms, frame_ms=frame_ms,
        orbit_during_loop=orbit_during_loop)
    out = {key: sum(v["launches"][key] for v in recs.values())
           for key in CHUNK_KERNELS}
    out["seconds"] = time.perf_counter() - t_start
    log(json.dumps(dict(metric="chunk_summary", **out, gpu=gpu)))
    return dict(out, records=recs)


def app_phases(mesh_scene, outdir: str, gpu: str) -> dict:
    """The train step through every scene (`train_textured_phases`), slice
    G (`sharding_phases`) and slice H (`preview_phase`), with their wall
    times; returns their launches for the `kernels` line."""
    t_start = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_start - sum(marks.values())
    train = train_textured_phases(gpu)
    mark("train_textured")
    shard = sharding_phases(mesh_scene, outdir, gpu)
    mark("sharding")
    prev = preview_phase(outdir, gpu)
    mark("preview")
    log(json.dumps(dict(metric="app_summary",
                        seconds=time.perf_counter() - t_start,
                        seconds_by_part=marks, gpu=gpu)))
    return dict(train=train, shard=shard, preview=prev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--outdir", default=os.path.join(ROOT, "out",
                                                     "chip_smoke"))
    ap.add_argument("--shard-worker", nargs=4, default=None,
                    metavar=("INIT", "RANK", "WORLD", "OUT"),
                    help="run one rank of the 2-rank gloo phase (the script "
                         "starts these itself)")
    args = ap.parse_args()
    if args.shard_worker:
        init, rank, world, out = args.shard_worker
        return shard_worker(init, int(rank), int(world), out)

    # ---- 1. a card, and the repository beside this script -----------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import project3_cuda_path_tracer_tpu_torch as port  # noqa: F401
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.utils import cuda_build
    for path in (SCENE, GLASS, GOLDEN, MESH, LIGHTS, MANY, MANY256, TEXTURED,
                 TEXTURED_PROC, *(os.path.join(ROOT, "scenes", n + ".txt")
                                  for n in ("sdf", "dispersion",
                                            "cornell_dof"))):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    kind = torch.cuda.get_device_name(0)
    log(f"gpu: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"nvidia-smi: {gpu}")
    os.makedirs(args.outdir, exist_ok=True)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = cuda_build.build_all(["megakernel", "bvh8", "bvh_binary",
                                 "gather", "extract_cost", "mat_grad",
                                 "prim_hit", "shade"])
    log(json.dumps(dict(phase="build", seconds=time.perf_counter() - t0,
                        libraries={k: os.path.relpath(v, ROOT)
                                   for k, v in libs.items()})))

    # ---- 3. kernel vs plain, injected uniforms ----------------------------
    kernel_vs_plain(sized(SCENE, 64, 8), "uniforms", 0, ATOL, FRAC,
                    "uniforms cornell 64x64 d8", seed_np=1)
    kernel_vs_plain(sized(GLASS, 64, 4), "uniforms", 0, GLASS_ATOL,
                    GLASS_FRAC, "uniforms glass 64x64 d4", seed_np=3)
    main_cmp = kernel_vs_plain(sized(SCENE, 800, 8), "uniforms", 0, ATOL,
                               FRAC, "uniforms cornell 800x800 d8",
                               seed_np=2)

    # ---- 4. kernel vs plain, stratified sampler ---------------------------
    kernel_vs_plain(sized(SCENE, 128, 8), "stratified", 3, ATOL, FRAC,
                    "stratified cornell 128x128 d8 it3")

    # ---- 5. Philox sampler ------------------------------------------------
    from project3_cuda_path_tracer_tpu_torch.render.integrator import \
        build_trace_config
    big = sized(SCENE, 800, 8)
    cfg = build_trace_config(big)
    dev = torch.device("cuda")
    table = mk.pack_scene(big, dev)

    def philox_accum(seed: int, spp: int, plain: bool = False):
        acc = torch.zeros((800, 800, 3), device=dev)
        fn = mk.iteration_plain if plain else mk.iteration
        for it in range(spp):
            fn(acc, table, cfg, it, seed, "philox")
        torch.cuda.synchronize()
        return acc

    a, b, c = philox_accum(7, 2), philox_accum(7, 2), philox_accum(8, 2)
    if not torch.equal(a, b):
        raise AssertionError("philox: same seed, different images")
    if torch.equal(a, c):
        raise AssertionError("philox: different seeds, same image")
    spp = 32
    k_mean = philox_accum(0, spp).mean(dim=(0, 1)).double().cpu().numpy()
    p_mean = philox_accum(0, spp, plain=True).mean(
        dim=(0, 1)).double().cpu().numpy()
    # Statistical, not lane-wise: the kernel draws Philox, the plain version
    # a torch CUDA Generator. The standard error of a 32-spp 800x800 image
    # mean is ~0.1% of it (per-iteration image means on cornell), so 1.5%
    # is >10 standard errors of the difference yet catches a biased lobe.
    rel = np.abs(k_mean - p_mean) / p_mean
    rel_all = abs(k_mean.mean() - p_mean.mean()) / p_mean.mean()
    log(json.dumps(dict(check="philox mean 800x800 d8 32spp",
                        kernel=k_mean.tolist(), plain=p_mean.tolist(),
                        rel_gap=rel.tolist(), rel_gap_all=rel_all,
                        limit=0.015)))
    if rel.max() > 0.015 or rel_all > 0.015:
        raise AssertionError(f"philox means differ: {rel} / {rel_all}")

    # ---- 5b. K1's two schedules, bit for bit ------------------------------
    schedules_equal()

    # ---- 6. the main path -------------------------------------------------
    zero_counts()
    r = Renderer(load_scene(SCENE), device="cuda")
    w, h = r.scene.camera.resolution
    r.step_many(16)
    torch.cuda.synchronize()
    ran = read_counts()
    launches, grid_launches = ran["k1"], ran["k1_grid"]
    if (w, h, r.cfg.trace_depth) != (800, 800, 8):
        raise AssertionError(f"cornell is {w}x{h} depth {r.cfg.trace_depth}")
    if launches != 16 or grid_launches:
        raise AssertionError(f"main path launched the kernel {launches} "
                             f"times for 16 iterations, {grid_launches} of "
                             "them in the grid schedule")
    img = r.accum.cpu().numpy()
    if img.shape != (800, 800, 3) or not np.isfinite(img).all() \
            or (img < 0).any():
        raise AssertionError("main-path image is not finite and >= 0")
    png = r.save(os.path.join(args.outdir, "cornell_800x800_16spp"))
    log(json.dumps(dict(phase="main path", scene="scenes/cornell.txt",
                        resolution=[w, h], depth=r.cfg.trace_depth,
                        iterations=r.iteration, launches=launches,
                        grid_launches=grid_launches,
                        mean=float(img.mean() / r.iteration), png=png)))

    # Against the JAX package's pinned golden accumulator (64x64, 8 spp,
    # tests/golden_cornell_64x64_8spp_seed123.npz): the golden is an 8-spp
    # estimate, so compare per-channel means within 4 of its standard
    # errors, estimated from the port's own per-iteration image means
    # (plus the port's own, much smaller, standard error).
    golden = np.load(GOLDEN)["accum"].astype(np.float64) / 8.0
    small = Renderer(sized(SCENE, 64, 8), device="cuda")
    per_it = []
    for _ in range(512):
        before = small.accum.mean(dim=(0, 1))
        small.step()
        per_it.append(small.accum.mean(dim=(0, 1)) - before)
    per_it = torch.stack(per_it).double().cpu().numpy()
    port_mean = per_it.mean(0)
    se_golden = per_it.std(0) / np.sqrt(8.0)
    se_gap = np.hypot(se_golden, per_it.std(0) / np.sqrt(len(per_it)))
    gap = np.abs(port_mean - golden.mean(axis=(0, 1)))
    mirrored = small.image()
    left, right = mirrored[24:40, 2:8], mirrored[24:40, 56:62]
    log(json.dumps(dict(check="golden 64x64", port=port_mean.tolist(),
                        golden=golden.mean(axis=(0, 1)).tolist(),
                        se_golden=se_golden.tolist())))
    if (gap > 4 * se_gap).any():
        raise AssertionError(f"port mean {port_mean} vs golden "
                             f"{golden.mean(axis=(0, 1))}")
    if not (left[..., 0].mean() > 1.5 * left[..., 2].mean()
            and right[..., 1].mean() > 1.5 * right[..., 0].mean()):
        raise AssertionError("walls are not red left / green right")

    cli = subprocess.run(
        [sys.executable, "-m", PKG, SCENE, "--iterations", "16",
         "--device", "cuda", "--metrics", "--outdir", args.outdir,
         "--out", "cornell_cli_16spp"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if cli.returncode != 0:
        raise AssertionError(f"CLI failed ({cli.returncode}):\n{cli.stderr}")
    metrics = json.loads(cli.stderr.strip().splitlines()[-1])
    if not os.path.exists(metrics["output"]):
        raise AssertionError("CLI wrote no PNG")
    log(json.dumps(dict(phase="cli", **metrics)))

    # wall seconds of each part of the run, printed before the results
    seconds = {"start_to_k1_timing": time.perf_counter() - t0}

    def mark(name):
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())

    # ---- 7. timing at 800x800, depth 8: the A/B of K1's schedules ---------
    k1 = k1_timing(gpu, table, cfg)
    mark("k1_timing")

    # ---- 8. the mesh path ---------------------------------------------------
    mesh, mesh_scene = mesh_phases(args.outdir, gpu)
    mark("mesh")

    # ---- 9. the train step --------------------------------------------------
    train_phases(gpu)
    mark("train")
    g1 = g1_phase(gpu)
    mark("g1")
    i1 = i1_phase(mesh_scene, gpu)
    mark("i1")
    s1 = s1_phase(mesh_scene, gpu)
    mark("s1")
    train_graph = train_graph_phases(gpu, r.accum / r.iteration)
    mark("train_graph")

    # ---- 9b. direct lighting: NEE, RIS, ReSTIR, many lights -----------------
    nee_phases(args.outdir, gpu)
    mark("nee")

    # ---- 9c. textures and environment lighting ------------------------------
    tex = textured_phases(args.outdir, gpu)
    mark("textured")

    # ---- 9d. the integrator features: sort, compaction, roulette, Sobol,
    # SDFs, dispersion, the first-bounce cache, the clamp ---------------------
    mesh[0].update(integrator_phases(mesh_scene, args.outdir, gpu))
    mark("integrator")

    # ---- 9e. the render services: adaptive sampling, the denoiser,
    # diagnostics, checkpoint and resume -------------------------------------
    mesh[0].update(services_phases(mesh_scene, args.outdir, gpu))
    mark("services")

    # ---- 9f. the train step through textured, SDF and dispersive scenes;
    # sharding (slice G); the preview (slice H) -------------------------------
    app = app_phases(mesh_scene, args.outdir, gpu)
    mark("app")

    # ---- 9g. the chunked render: replays of one captured iteration --------
    chunk = chunk_phases(mesh_scene, args.outdir, gpu)
    mark("chunk")
    # K2's launches over every path driven with the counts set to 0
    k2 = mesh[0]
    by_path = {"mesh": k2["launches"], "mesh --nee": k2.pop("nee_launches"),
               "textured_env and its proc twin": tex["k2_launches"],
               "mesh --sort --compact": k2["compacted_launches"],
               "mesh first-bounce cache": sum(k2["cached_launches"]),
               "mesh --adaptive": k2["adaptive_launches"],
               "mesh denoise G-buffer": k2["gbuffer_launches"],
               "textured_env train step": app["train"]["k2_launches"],
               "mesh sharded, world 1": app["shard"]["k2_launches"],
               "chunked renders (graph replays)": chunk["k2"],
               "textured_env 512 train scan (1 eager step, 2 replays)":
                   train_graph["k2_launches"]}
    k2.update(launches=sum(by_path.values()), launches_by_path=by_path,
              train_step_ms=[k["held_ms"] for k in app["train"]["k2"]])

    # ---- 10. the probes P1 and P2 -------------------------------------------
    probes = probe_phases(gpu)
    mark("probes")
    log(json.dumps(dict(metric="run_seconds", total=time.perf_counter() - t0,
                        seconds_by_part=seconds)))
    # P1's entry: its launches and times on the texture path (bounce 0's
    # fused-table indices), the probe's beside them
    p1 = tex["p1"][0]
    probe = probes[0]
    p1_train = app["train"]["p1"]
    probe.update(
        launches=(tex["launches"] + app["train"]["gather_launches"]
                  + chunk["p1"] + train_graph["gather_launches"]),
        launches_by_path={"textured_env": tex["launches"],
                          "textured_env train step":
                              app["train"]["gather_launches"],
                          "textured_env chunk (graph replays)":
                              chunk["p1"],
                          "textured_env 512 train scan (1 eager step, "
                          "2 replays)": train_graph["gather_launches"]},
        train_step_ms=[b["value"] for b in p1_train],
        train_step_library_ms=[b["library_ms"] for b in p1_train],
        ms=p1["value"], cold_ms=p1["cold_ms"],
        plain_ms=p1["plain_ms"], bound_ms=p1["bound_ms"],
        bound_by=p1["bound_by"], library_ms=p1["library_ms"],
        library_cold_ms=p1["library_cold_ms"], instance=p1["instance"],
        path="textured_env 2048x2048 d8, fused atlas+env table, bounce 0",
        bounce1_ms=tex["p1"][1]["value"],
        bounce1_cold_ms=tex["p1"][1]["cold_ms"],
        bounce1_library_ms=tex["p1"][1]["library_ms"],
        probe_launches=probe["launches"], probe_ms=probe["ms"],
        probe_cold_ms=probe["cold_ms"], probe_plain_ms=probe["plain_ms"],
        probe_bound_ms=probe["bound_ms"], probe_library_ms=probe["library_ms"])

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(gpu, flush=True)
    print(json.dumps({"kernels": [{
        "name": "megakernel", "route": "cuda",
        "source": f"{PKG}/csrc/megakernel.cu",
        "replaces": "project3_cuda_path_tracer_tpu/ops/megakernel.py:149",
        "launches": launches + app["preview"]["k1_launches"],
        "launches_by_path": {
            "cornell": launches,
            "preview after an orbit": app["preview"]["k1_launches"]},
        "max_abs_err": main_cmp["max_abs_err"],
        "library_ms": None, **k1}] + mesh + probes
        + [g1_entry(g1, train_graph), i1_entry(i1), s1_entry(s1)]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
