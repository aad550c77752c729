"""Headless CLI: `python -m project3_cuda_path_tracer_tpu_torch SCENE.txt`.

Counterpart of project3_cuda_path_tracer_tpu/app/cli.py (reference
semantics: src/main.cpp:33-97): progressive render to the scene's
ITERATIONS budget, save `<outdir>/<FILE>.png` and exit. The flags are the
JAX CLI's that the ported slice covers, plus `--device`. Every other JAX
flag exits with code 2 and names the ROADMAP slice that will port it; none
is silently ignored.
"""
from __future__ import annotations

import argparse
import os
import sys

_SLICE_H = "slice H (the app)"
# JAX CLI flag -> why the port does not take it yet
UNPORTED_FLAGS = {
    "--sharded": "slice G (sharding)",
    "--preview": _SLICE_H, "--snapshot-every": _SLICE_H,
    "--timestamp-name": _SLICE_H, "--debug-nans": _SLICE_H,
    "--no-bake": "no slice: XLA constant baking has no counterpart (the "
                 "scene table is a kernel input)",
    "--megakernel": "no slice: the renderer already takes the CUDA "
                    "megakernel for every scene it supports",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m project3_cuda_path_tracer_tpu_torch",
        description="Path tracer, PyTorch + CUDA port (primitive, SDF, "
                    "mesh and textured scenes)")
    p.add_argument("scene", help="scene file (reference text format)")
    p.add_argument("--iterations", type=int, default=None,
                   help="override the scene's ITERATIONS")
    p.add_argument("--depth", type=int, default=None,
                   help="override the scene's DEPTH (trace depth)")
    p.add_argument("--out", default=None,
                   help="output basename (default: scene FILE field)")
    p.add_argument("--outdir", default=".", help="output directory")
    p.add_argument("--hdr", action="store_true", help="write Radiance .hdr")
    p.add_argument("--no-antialias", action="store_true",
                   help="disable stochastic AA jitter")
    p.add_argument("--sort", action="store_true",
                   help="material-key sort paths before shading")
    p.add_argument("--compact", action="store_true",
                   help="compact terminated paths each bounce")
    p.add_argument("--russian-roulette", action="store_true",
                   help="unbiased stochastic termination from bounce 3")
    p.add_argument("--stratified", action="store_true",
                   help="stratified sampling (per-pixel rotated "
                        "low-discrepancy camera/NEE/BSDF sequences)")
    p.add_argument("--sampler", choices=("lattice", "sobol"),
                   default="lattice",
                   help="stratified-sampling implementation: lattice "
                        "(default) or Owen-scrambled sobol (best "
                        "per-sample RMSE, more integer work a draw)")
    p.add_argument("--bilinear", action="store_true",
                   help="bilinear texture/env filtering (4 corner "
                        "fetches)")
    p.add_argument("--bilinear-fast", action="store_true",
                   help="bilinear filtering through the pair planes (2 "
                        "fetches, RGB565 atlas texels; implies "
                        "--bilinear)")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation: one light sample a bounce "
                        "(area lights, the env map or both) with "
                        "one-sample MIS")
    p.add_argument("--nee-ris", type=int, default=0, metavar="M",
                   help="RIS direct lighting: one shadow ray resampled "
                        "from M light candidates (implies --nee)")
    p.add_argument("--restir", type=int, default=0, metavar="M",
                   help="temporal ReSTIR at depth 0 over M fresh "
                        "candidates a frame (implies --nee)")
    p.add_argument("--restir-cap", type=float, default=20.0,
                   help="ReSTIR reservoir count cap, in units of M")
    p.add_argument("--clamp", type=float, default=0.0, metavar="R",
                   help="per-sample radiance clamp (firefly suppression; "
                        "biased, opt-in)")
    p.add_argument("--gamma", type=float, default=0.0, metavar="G",
                   help="apply 1/G display gamma to the saved PNG "
                        "(reference default: none, linear)")
    p.add_argument("--aces", action="store_true",
                   help="ACES filmic tonemap on the saved PNG "
                        "(Narkowicz 2015 fit; .hdr output stays linear)")
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive sampling: re-allocate the per-iteration "
                        "path budget to high-variance pixels every "
                        "--adaptive-epoch iterations (host planner; "
                        "unbiased per-pixel means)")
    p.add_argument("--adaptive-epoch", type=int, default=32,
                   help="iterations between adaptive re-plans (default 32; "
                        "the first epoch is a uniform warm-up)")
    p.add_argument("--denoise", action="store_true",
                   help="edge-avoiding a-trous wavelet denoise at save "
                        "time (Dammertz et al. 2010)")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="write a resume checkpoint <out>.ckpt.npz every N "
                        "iterations")
    p.add_argument("--resume", action="store_true",
                   help="resume from <out>.ckpt.npz if present")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics", action="store_true",
                   help="emit a JSON-line metrics record to stderr")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to render (default cuda; never chosen for "
                        "you: cuda without a card is an error)")
    return p


def main(argv=None) -> int:
    args, rest = build_parser().parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            print(f"{flag} is not ported to the torch package yet: "
                  f"{UNPORTED_FLAGS[flag]} (ROADMAP.md Queue 1); use "
                  "python -m project3_cuda_path_tracer_tpu for it",
                  file=sys.stderr)
            return 2
    if rest:
        build_parser().error(f"unrecognized arguments: {' '.join(rest)}")
    if args.adaptive and (args.sort or args.compact):
        print("--adaptive is incompatible with --megakernel/--sort/"
              "--compact", file=sys.stderr)
        return 2
    if args.restir and (args.sort or args.compact or args.adaptive):
        print("--restir is incompatible with --megakernel/--sort/"
              "--compact/--adaptive/--sharded (identity single-device "
              "path order required)", file=sys.stderr)
        return 2

    import torch

    from ..render import checkpoint as ckpt
    from ..render.integrator import Renderer
    from ..scene.parser import load_scene
    from ..utils.device import synchronize
    from ..utils.metrics import RenderMetrics

    scene = load_scene(args.scene)
    st = scene.settings
    if args.iterations is not None:
        st.iterations = args.iterations
    if args.depth is not None:
        st.trace_depth = args.depth
    st.antialias = not args.no_antialias
    st.sort_materials = args.sort
    st.compact = args.compact
    st.russian_roulette = args.russian_roulette
    st.stratified = args.stratified
    st.strat_impl = args.sampler
    st.clamp = args.clamp
    st.bilinear = args.bilinear or args.bilinear_fast
    st.bilinear_fast = args.bilinear_fast
    st.seed = args.seed
    st.nee = args.nee or args.nee_ris >= 2 or args.restir >= 1
    st.nee_ris = args.nee_ris
    st.restir = args.restir
    st.restir_cap = args.restir_cap
    st.adaptive = args.adaptive
    st.adaptive_epoch = args.adaptive_epoch
    os.makedirs(args.outdir, exist_ok=True)
    base = os.path.join(args.outdir, args.out or st.image_name)

    renderer = Renderer(scene, device=args.device)
    start_iter = 0
    if args.resume:
        found = ckpt.find_checkpoint(base)
        if found:
            accum, start_iter, seed = ckpt.load_checkpoint(found, args.scene)
            renderer.accum.copy_(torch.from_numpy(accum))
            renderer.iteration = start_iter
            renderer.seed = seed
            renderer.restore_extras(ckpt.load_extras(found))
            print(f"resumed from {found} at iteration {start_iter}",
                  file=sys.stderr)
    w, h = scene.camera.resolution
    metrics = RenderMetrics(width=w, height=h, trace_depth=st.trace_depth)
    print(f"rendering {args.scene}: {w}x{h}, {st.iterations} iterations, "
          f"depth {st.trace_depth}, device={renderer.device}, "
          f"route={renderer.route}", file=sys.stderr)
    metrics.start()
    done = start_iter
    while done < st.iterations:
        # advance to the next checkpoint boundary
        nxt = st.iterations
        if args.checkpoint_every:
            nxt = min(nxt, (done // args.checkpoint_every + 1)
                      * args.checkpoint_every)
        renderer.step_many(nxt - done)
        done = nxt
        if args.checkpoint_every and done % args.checkpoint_every == 0:
            ckpt.save_checkpoint(base + ".ckpt.npz",
                                 renderer.accum.cpu().numpy(), done,
                                 renderer.seed, args.scene,
                                 extras=renderer.checkpoint_extras())
    synchronize(renderer.device)
    metrics.stop(max(st.iterations - start_iter, 0))
    out = renderer.save(base, hdr=args.hdr, denoise=args.denoise,
                        gamma=args.gamma, aces=args.aces)
    print(f"saved {out}", file=sys.stderr)
    if args.metrics:
        metrics.emit(final=True, output=out, device=str(renderer.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
