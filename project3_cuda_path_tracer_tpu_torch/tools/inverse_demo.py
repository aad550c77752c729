"""Inverse-rendering demo: recover a perturbed wall albedo by gradient
descent through the renderer (the counterpart of the repository's
tools/inverse_demo.py).

Renders a target Cornell image with the true materials, perturbs the white
walls' albedo, then fits it back with the unbiased two-render MSE gradient
(models/inverse.py), or with the one-render history-residual loss and an
optional two-render polish tail. Only the albedo table trains; every other
leaf is frozen. Prints one JSON line per log step and the recovered albedo
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

    import numpy as np
    import torch

    from ..models import inverse as inv
    from ..models import optim
    from ..render import integrator as integ
    from ..scene.parser import load_scene
    from ..utils.device import resolve_device
    from ..utils.image import write_png

    dev = resolve_device(args.device)
    s = load_scene(args.scene)
    s.camera.resolution = (args.res, args.res)
    s.camera.derive()
    cfg = integ.TraceConfig(
        width=args.res, height=args.res, trace_depth=args.depth,
        antialias=False, geom_types=tuple(int(t) for t in
                                          s.geoms.type.tolist()),
        glossy=False)
    geoms = integ.to_device(s.geoms, dev)
    meshes = integ.to_device(s.meshes, dev)
    textures = integ.to_device(s.textures, dev)

    def render(params, seed, i):
        with torch.no_grad():
            return inv.render_image(params, geoms, meshes, textures,
                                    inv.step_generator(seed, i, dev), cfg)

    true_params = inv.params_from_scene(s, dev)
    target = torch.stack([render(true_params, 0, i)
                          for i in range(8)]).mean(0)
    params = inv.params_from_scene(s, dev)
    with torch.no_grad():
        params.materials.color[1] = torch.tensor([0.2, 0.6, 0.3])
    for leaf in inv.param_leaves(params):
        if leaf is not params.materials.color:
            leaf.requires_grad_(False)
    initial_img = render(params, 0, 0)

    step = inv.make_train_step(geoms, meshes, textures, cfg, args.lr)
    hstep = inv.make_train_step(geoms, meshes, textures, cfg, args.lr,
                                history=True)
    opt_state = optim.init(inv.param_leaves(params))
    hist = render(params, 777, 0) if args.history else None
    polish_from = args.steps - (args.polish if args.history else 0)
    tail_start = (args.steps - max(10, args.polish - 15)
                  if args.history and args.polish else args.steps * 3 // 5)
    tail = []
    for i in range(args.steps):
        gen = inv.step_generator(11, i, dev)
        if args.history and i < polish_from:
            params, opt_state, hist, loss = hstep(params, opt_state, hist,
                                                  gen, target)
        else:
            params, opt_state, loss = step(params, opt_state, gen, target)
        albedo = params.materials.color[1].detach().cpu().numpy()
        if i >= tail_start:
            tail.append(albedo)
        if i % 50 == 0 or i == args.steps - 1:
            print(json.dumps({"step": i, "loss": round(float(loss), 6),
                              "albedo": [round(float(v), 4)
                                         for v in albedo]}), flush=True)

    recovered = np.stack(tail).mean(0)
    print(json.dumps({
        "true_albedo": [round(float(v), 4) for v in
                        s.materials.color[1].tolist()],
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
