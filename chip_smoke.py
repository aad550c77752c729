#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--outdir DIR]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA kernel from csrc/, holds it against its plain
torch version at the main path's shapes, drives the main path (cornell,
800x800, depth 8, through `Renderer` and the CLI) and times kernel and plain
version. Every phase raises on failure, so any failure exits non-zero.
Without a card, or without the rest of the repository beside it, it exits
non-zero before printing any result.

Output, on stdout: progress lines, one JSON line per timing, the card's
name and power limit as nvidia-smi reports them, a `{"kernels": [...]}`
line, and last `{"ok": true, "device": {...}}`. The PNGs go to --outdir.
"""
from __future__ import annotations

import argparse
import json
import os
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

# Lane contract of tests/test_megakernel.py: kernel and plain version are
# separately compiled programs. nvcc contracts multiply-adds into FMAs and
# its rsqrtf differs from torch's rsqrt by ulps; near a decision threshold
# (nearest-hit ties, the SQRT_OF_ONE_THIRD frame pick, the Fresnel test)
# such an ulp flips a binary choice and the whole lane diverges. So: lanes
# agree to ATOL, at most FRAC of them diverge, image means within MEAN_TOL.
ATOL, FRAC, MEAN_TOL = 1e-4, 0.01, 0.05
# The glass sphere adds the transmitted path, with more thresholds.
GLASS_ATOL, GLASS_FRAC = 2e-4, 0.02


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
                  atol: float, frac: float) -> dict:
    g = got.reshape(-1, 3).double().cpu().numpy()
    w = want.reshape(-1, 3).double().cpu().numpy()
    if not (np.isfinite(g).all() and np.isfinite(w).all()):
        raise AssertionError(f"{tag}: non-finite values")
    err = np.abs(g - w)
    diverged = float((err > atol).any(axis=1).mean())
    mean_gap = float(np.abs(g.mean(0) - w.mean(0)).max())
    rec = dict(check=tag, lanes=int(g.shape[0]), atol=atol,
               diverged_frac=diverged, max_abs_err=float(err.max()),
               p99_abs_err=float(np.percentile(err.max(axis=1), 99)),
               mean_gap=mean_gap)
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


def time_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls, by CUDA events, after warm-up."""
    for _ in range(3):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--outdir", default=os.path.join(ROOT, "out",
                                                     "chip_smoke"))
    args = ap.parse_args()

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
    for path in (SCENE, GLASS, GOLDEN):
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
    lib_path = cuda_build.build("megakernel")
    log(json.dumps(dict(phase="build", seconds=time.perf_counter() - t0,
                        library=os.path.relpath(lib_path, ROOT))))

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

    # ---- 6. the main path -------------------------------------------------
    mk.LAUNCHES = 0
    r = Renderer(load_scene(SCENE), device="cuda")
    w, h = r.scene.camera.resolution
    r.step_many(16)
    torch.cuda.synchronize()
    launches = mk.LAUNCHES
    if (w, h, r.cfg.trace_depth) != (800, 800, 8):
        raise AssertionError(f"cornell is {w}x{h} depth {r.cfg.trace_depth}")
    if launches != 16:
        raise AssertionError(f"main path launched the kernel {launches} "
                             "times for 16 iterations")
    img = r.accum.cpu().numpy()
    if img.shape != (800, 800, 3) or not np.isfinite(img).all() \
            or (img < 0).any():
        raise AssertionError("main-path image is not finite and >= 0")
    png = r.save(os.path.join(args.outdir, "cornell_800x800_16spp"))
    log(json.dumps(dict(phase="main path", scene="scenes/cornell.txt",
                        resolution=[w, h], depth=r.cfg.trace_depth,
                        iterations=r.iteration, launches=launches,
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

    # ---- 7. timing at 800x800, depth 8 ------------------------------------
    acc = torch.zeros((800, 800, 3), device=dev)

    def kernel_step():
        mk.iteration(acc, table, cfg, 0, 0, "philox")

    def plain_step():
        mk.iteration_plain(acc, table, cfg, 0, 0, "philox")

    # plain, kernel, kernel, plain: both versions see the same card state
    plain_ms = [time_ms(plain_step, 20)]
    kernel_ms = [time_ms(kernel_step, 100), time_ms(kernel_step, 100)]
    plain_ms.append(time_ms(plain_step, 20))
    k_ms, p_ms = float(np.mean(kernel_ms)), float(np.mean(plain_ms))
    segs = 800 * 800 * 8
    for name, ms, runs in (("kernel", k_ms, kernel_ms),
                           ("plain", p_ms, plain_ms)):
        log(json.dumps(dict(
            metric=f"{name}_ms_per_iteration", value=ms, runs=runs,
            path_segments_per_s=segs / (ms / 1e3),
            config="cornell 800x800 depth 8", gpu=gpu)))

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(gpu, flush=True)
    print(json.dumps({"kernels": [{
        "name": "megakernel", "route": "cuda",
        "source": f"{PKG}/csrc/megakernel.cu",
        "replaces": "project3_cuda_path_tracer_tpu/ops/megakernel.py:149",
        "launches": launches, "max_abs_err": main_cmp["max_abs_err"],
        "ms": k_ms, "plain_ms": p_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
