"""Headless CLI: `python -m project3_cuda_path_tracer_tpu_torch SCENE.txt`.

Counterpart of project3_cuda_path_tracer_tpu/app/cli.py (reference
semantics: src/main.cpp:33-97): progressive render to the scene's
ITERATIONS budget, save `<outdir>/<FILE>.png` (with `--timestamp-name`,
`{FILE}.{timestamp}.{N}samp.png`, src/main.cpp:91-97) and exit. The flags
are the JAX CLI's, plus `--device`; the two JAX flags that have no
counterpart here exit with code 2 and say why, so none is silently
ignored.

`--sharded` renders through parallel/sharding.py: in one process a world
of one; under `torchrun --nproc-per-node K` each rank renders its block of
rows and rank 0 writes the files. The backend follows `--device`: nccl on
the card, gloo on the CPU. `--preview PORT` serves the HTTP preview
(app/preview.py) while the render runs.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

# JAX CLI flag -> why the port does not take it
UNPORTED_FLAGS = {
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
    p.add_argument("--sharded", action="store_true",
                   help="shard pixel rows over the ranks of "
                        "torch.distributed (one process: a world of one; "
                        "launch with torchrun for more)")
    p.add_argument("--preview", type=int, default=0, metavar="PORT",
                   help="serve a live HTTP preview on 127.0.0.1:PORT")
    p.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                   help="write a progressive PNG every N iterations")
    p.add_argument("--timestamp-name", action="store_true",
                   help="reference-style {FILE}.{timestamp}.{N}samp name")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast: check the accumulator after every "
                        "iteration and exit non-zero at the first NaN or "
                        "Inf, naming the iteration")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics", action="store_true",
                   help="emit a JSON-line metrics record to stderr; the "
                        "final one adds the program's spans (count and "
                        "total ms by name) and each captured graph's "
                        "nodes")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to render (default cuda; never chosen for "
                        "you: cuda without a card is an error)")
    return p


def main(argv=None) -> int:
    args, rest = build_parser().parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            print(f"{flag} is not taken by the torch package: "
                  f"{UNPORTED_FLAGS[flag]} (ROADMAP.md, not ported by "
                  "decision)", file=sys.stderr)
            return 2
    if rest:
        build_parser().error(f"unrecognized arguments: {' '.join(rest)}")
    if args.adaptive and (args.sort or args.compact):
        print("--adaptive is incompatible with --megakernel/--sort/"
              "--compact", file=sys.stderr)
        return 2
    if args.restir and (args.sort or args.compact or args.adaptive
                        or args.sharded):
        print("--restir is incompatible with --megakernel/--sort/"
              "--compact/--adaptive/--sharded (identity single-device "
              "path order required)", file=sys.stderr)
        return 2

    from ..render.integrator import Renderer
    from ..scene.parser import load_scene

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

    rank = 0
    if args.sharded:
        from ..parallel import sharding
        sharding.init_distributed("nccl" if args.device == "cuda"
                                  else "gloo")
        renderer = sharding.ShardedRenderer(scene, device=args.device)
        rank = renderer.rank
        if args.preview and renderer.world > 1:
            print("--preview with --sharded needs a world of one (the "
                  "frame gather is a collective)", file=sys.stderr)
            return 2
    else:
        renderer = Renderer(scene, device=args.device)

    def say(msg):
        if rank == 0:
            print(msg, file=sys.stderr)

    preview_srv = None
    if args.preview:
        from .preview import PreviewServer
        preview_srv = PreviewServer(renderer, port=args.preview).start()
        say(f"live preview at http://127.0.0.1:{preview_srv.port}/")
    from ..utils import profiling
    if args.metrics:
        profiling.clear()
    try:
        with (profiling.recording() if args.metrics
              else contextlib.nullcontext()):
            return _render(args, scene, renderer, base, rank, say,
                           preview_srv)
    finally:
        if preview_srv is not None:
            preview_srv.stop()


def _nonfinite(renderer, sharded: bool) -> bool:
    """Whether some rank's accumulator holds a NaN or Inf (every rank gets
    the same answer, so all of them stop together)."""
    import torch
    bad = ~torch.isfinite(renderer.accum).all()
    if sharded and renderer.world > 1:
        import torch.distributed as dist
        flag = bad.to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())
    return bool(bad)


def _render(args, scene, renderer, base, rank, say, preview_srv) -> int:
    """The render loop of `main`, to the scene's ITERATIONS: snapshots,
    checkpoints and the NaN check at their boundaries; then the save."""
    import torch

    from ..render import checkpoint as ckpt
    from ..utils.device import synchronize
    from ..utils.metrics import RenderMetrics

    st = scene.settings
    start_iter = 0
    if args.resume:
        found = ckpt.find_checkpoint(base)
        if found:
            accum, start_iter, seed = ckpt.load_checkpoint(found, args.scene)
            if args.sharded:
                renderer.load_accum(accum)
            else:
                renderer.accum.copy_(torch.from_numpy(accum))
            renderer.iteration = start_iter
            renderer.seed = seed
            renderer.restore_extras(ckpt.load_extras(found))
            say(f"resumed from {found} at iteration {start_iter}")
    w, h = scene.camera.resolution
    metrics = RenderMetrics(width=w, height=h, trace_depth=st.trace_depth)
    world = getattr(renderer, "world", 1)
    say(f"rendering {args.scene}: {w}x{h}, {st.iterations} iterations, "
        f"depth {st.trace_depth}, device={renderer.device}, "
        f"route={renderer.route}"
        + (f", sharded over {world} rank(s)" if args.sharded else ""))
    step_many = (preview_srv.step_many if preview_srv is not None
                 else renderer.step_many)
    metrics.start()
    done = start_iter
    while done < st.iterations:
        # advance to the next snapshot or checkpoint boundary (one
        # iteration at a time under --debug-nans)
        nxt = st.iterations
        for every in (args.snapshot_every, args.checkpoint_every,
                      1 if args.debug_nans else 0):
            if every:
                nxt = min(nxt, (done // every + 1) * every)
        step_many(nxt - done)
        done = nxt
        if args.debug_nans and _nonfinite(renderer, args.sharded):
            say(f"debug-nans: the accumulator holds a NaN or Inf after "
                f"iteration {done - 1} (0-based)")
            return 1
        if args.snapshot_every and done % args.snapshot_every == 0:
            synchronize(renderer.device)
            metrics.stop(done - start_iter - metrics._iters)
            out = renderer.save(f"{base}.snap{done}")
            say(f"[{done}/{st.iterations}] snapshot {out}")
            if args.metrics and rank == 0:
                metrics.emit(iteration=done)
            metrics.start()
        if args.checkpoint_every and done % args.checkpoint_every == 0:
            accum = (renderer.full_accum() if args.sharded
                     else renderer.accum).cpu().numpy()
            extras = renderer.checkpoint_extras()
            if rank == 0:
                ckpt.save_checkpoint(base + ".ckpt.npz", accum, done,
                                     renderer.seed, args.scene,
                                     extras=extras)
    synchronize(renderer.device)
    if metrics._t0 is not None:
        metrics.stop(max(st.iterations - start_iter - metrics._iters, 0))
    out_base = base
    if args.timestamp_name:
        # {FILE}.{timestamp}.{N}samp (reference: src/main.cpp:91-97)
        ts = time.strftime("%Y-%m-%d_%H-%M-%SZ", time.gmtime())
        out_base = f"{base}.{ts}.{renderer.iteration}samp"
    out = renderer.save(out_base, hdr=args.hdr, denoise=args.denoise,
                        gamma=args.gamma, aces=args.aces)
    say(f"saved {out}")
    if args.metrics and rank == 0:
        metrics.emit(final=True, output=out, device=str(renderer.device),
                     **_program_record())
    return 0


def _program_record() -> dict:
    """The final metrics line's reading of the program's recorder
    (utils/profiling): `spans`, each span's count and total ms by name,
    and `graph_nodes`, each captured graph's nodes and kernel nodes by
    graph name; and the hand kernels' counts (utils/launches):
    `launches`, the wrappers' counters, and `device_launches`, the
    kernels' own tallies on the card (graph replays included; K1's live
    segments and lane slots under `k1_segments` and `k1_slots`)."""
    from ..utils import launches, profiling
    c = profiling.counters()
    graphs = sorted(k[:-len(".graph_nodes")] for k in c
                    if k.endswith(".graph_nodes"))
    return dict(
        spans={n: dict(count=k, ms=1e3 * t) for n, (k, t) in
               sorted(profiling.span_totals().items())},
        graph_nodes={g: dict(nodes=c[g + ".graph_nodes"],
                             kernel_nodes=c.get(g + ".kernel_nodes"))
                     for g in graphs},
        launches=launches.launch_counts(),
        device_launches=launches.device_launches())


if __name__ == "__main__":
    sys.exit(main())
