"""Adaptive sampling's image mean against the uniform render's, in the JAX
package and in the torch port, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_adaptive_bias.py [--res 128]
        [--spp 32] [--seeds 1 2 3 4]

The per-pixel estimate accum / count of render/adaptive.py divides by a
count that depends on the pixel's own earlier samples, so at low spp its
image mean reads below the uniform render's. This script measures that gap
in both packages on scenes/cornell.txt (depth 8, --adaptive-epoch 8, the
pseudo-random draws, one run per seed): each run's channel means relative
to a 512-spp reference of the port's uniform render (K1's plain version),
beside each package's uniform render at the same spp and seed, and the
same for the central quarter of the image (the back wall around the
mirror sphere, where the adaptive plan puts most samples). One JSON line a
seed and package, then the means over the seeds.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene  # noqa: E402
from project3_cuda_path_tracer_tpu.render.integrator import \
    Renderer as JaxRenderer  # noqa: E402
from project3_cuda_path_tracer_tpu.scene import types as JT  # noqa: E402
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene  # noqa: E402

CORNELL = os.path.join(REPO, "scenes", "cornell.txt")


def _means(img: np.ndarray) -> np.ndarray:
    """[2, 3]: the image's channel means, and those of its central
    quarter."""
    h, w = img.shape[:2]
    centre = img[3 * h // 8:5 * h // 8, 3 * w // 8:5 * w // 8]
    return np.stack([img.mean(axis=(0, 1)), centre.mean(axis=(0, 1))])


def port_mean(res: int, spp: int, **settings) -> np.ndarray:
    s = load_scene(CORNELL)
    s.camera.resolution = (res, res)
    s.camera.derive()
    for k, v in settings.items():
        setattr(s.settings, k, v)
    r = Renderer(s, device="cpu")
    r.render(spp)
    return _means(r._mean().double().numpy())


def jax_mean(res: int, spp: int, **settings) -> np.ndarray:
    s = jax_load_scene(CORNELL)
    s.camera.resolution = (res, res)
    s.camera.derive()
    r = JaxRenderer(s, settings=JT.RenderSettings(
        **{**s.settings.__dict__, **settings}))
    r.render(spp)
    return _means(np.asarray(r.accum, np.float64)
                  / np.maximum(r.count, 1.0)[..., None])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    args = ap.parse_args()
    truth = port_mean(args.res, 512, seed=99)
    gaps = {}
    for seed in args.seeds:
        for pkg, fn in (("jax", jax_mean), ("port", port_mean)):
            rel = {mode: (fn(args.res, args.spp, seed=seed, **kw) - truth)
                   / truth for mode, kw in (
                       ("uniform", {}),
                       ("adaptive", dict(adaptive=True, adaptive_epoch=8)))}
            gap = rel["adaptive"] - rel["uniform"]
            gaps.setdefault(pkg, []).append(gap)
            print(json.dumps(dict(
                package=pkg, seed=seed, res=args.res, spp=args.spp,
                uniform_vs_reference=rel["uniform"][0].tolist(),
                adaptive_vs_reference=rel["adaptive"][0].tolist(),
                adaptive_minus_uniform=gap[0].tolist(),
                centre_adaptive_minus_uniform=gap[1].tolist())), flush=True)
    print(json.dumps({pkg: dict(
        mean_adaptive_minus_uniform=np.mean(g, axis=0)[0].tolist(),
        centre_mean_adaptive_minus_uniform=np.mean(g, axis=0)[1].tolist(),
        seeds=len(g)) for pkg, g in gaps.items()}))


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
