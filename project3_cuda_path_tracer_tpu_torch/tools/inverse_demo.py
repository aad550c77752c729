"""Inverse-rendering demo: recover a perturbed wall albedo by gradient
descent through the renderer (the counterpart of the repository's
tools/inverse_demo.py).

Renders a target Cornell image with the true materials, perturbs the white
walls' albedo, then fits it back through `InverseRenderer` (models/
inverse.py) with the unbiased two-render MSE gradient, or with the
one-render history-residual loss and an optional two-render polish tail,
the steps of `fit` taken one at a time. Only the albedo table trains;
every other leaf is frozen. On the card each loss form's steps replay one
captured graph of the train step. Prints one JSON line per log step, the
wall ms a step (on the device named beside it) and the recovered albedo
(the mean over a tail window of the iterates), and saves target / initial
/ recovered PNGs.

Usage: python -m project3_cuda_path_tracer_tpu_torch.tools.inverse_demo
           [--res 64] [--steps 300] [--device cuda|cpu] [--outdir renders]
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "scenes", "cornell.txt"))
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--outdir", default="renders")
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--history", action="store_true",
                    help="the one-render history-residual loss instead of "
                         "the two-render unbiased loss")
    ap.add_argument("--polish", type=int, default=0,
                    help="with --history: the last N steps take the "
                         "two-render unbiased loss")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train (default cuda; never chosen for "
                         "you)")
    args = ap.parse_args(argv)

    import time

    import numpy as np
    import torch

    from ..models import inverse as inv
    from ..ops import texfetch
    from ..render import integrator as integ
    from ..scene.parser import load_scene
    from ..utils.device import resolve_device, synchronize
    from ..utils.image import write_png

    dev = resolve_device(args.device)
    s = load_scene(args.scene)
    s.camera.resolution = (args.res, args.res)
    s.camera.derive()
    s.settings.antialias = False
    cfg = inv.train_config(s, args.depth)
    tables = (integ.to_device(s.geoms, dev), integ.to_device(s.meshes, dev),
              texfetch.fuse(integ.to_device(s.textures, dev)))
    packed = tuple(integ.to_device(p, dev) for p in s.packed_meshes)

    def render(params, seed, i):
        with torch.no_grad():
            return inv.render_image(params, *tables,
                                    inv.step_generator(seed, i, dev), cfg,
                                    packed)

    true_params = inv.params_from_scene(s, dev)
    target = torch.stack([render(true_params, 0, i)
                          for i in range(8)]).mean(0)
    true_albedo = s.materials.color[1].tolist()
    s.materials.color[1] = torch.tensor([0.2, 0.6, 0.3])
    # InverseRenderer.fit's steps one at a time, to log the albedo: on the
    # card each form's steps replay its captured train-step graph
    ir = inv.InverseRenderer(s, target.cpu().numpy(), learning_rate=args.lr,
                             trace_depth=args.depth, seed=11,
                             history=args.history, device=args.device)
    params = ir.params
    for leaf in inv.param_leaves(params):
        if leaf is not params.materials.color:
            leaf.requires_grad_(False)
    initial_img = render(params, 0, 0)

    polish_from = args.steps - (args.polish if args.history else 0)
    tail_start = (args.steps - max(10, args.polish - 15)
                  if args.history and args.polish else args.steps * 3 // 5)
    tail = []
    synchronize(dev)
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss = ir.step(polish=i >= polish_from)
        albedo = params.materials.color[1].detach().cpu().numpy()
        if i >= tail_start:
            tail.append(albedo)
        if i % 50 == 0 or i == args.steps - 1:
            print(json.dumps({"step": i, "loss": round(loss, 6),
                              "albedo": [round(float(v), 4)
                                         for v in albedo]}), flush=True)
    synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / max(args.steps, 1)
    print(json.dumps({"ms_per_step": ms, "device": (
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        "res": args.res, "depth": args.depth,
        "graph_replays": {k: g.replays if g is not None else 0
                          for k, g in ir.graphs.items()}}), flush=True)

    recovered = np.stack(tail).mean(0)
    print(json.dumps({
        "true_albedo": [round(float(v), 4) for v in true_albedo],
        "start_albedo": [0.2, 0.6, 0.3],
        "recovered_albedo": [round(float(v), 4) for v in recovered]}))

    os.makedirs(args.outdir, exist_ok=True)

    def save(name, img):
        arr = np.clip(img.cpu().numpy()[:, ::-1, :], 0, 1)
        write_png(os.path.join(args.outdir, name),
                  (arr * 255).astype(np.uint8))

    save("inverse_target.png", target)
    save("inverse_initial.png", initial_img)
    save("inverse_recovered.png", render(params, 0, 0))
    print(f"saved target/initial/recovered to {args.outdir}/",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
