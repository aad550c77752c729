"""The history-residual train step in plain PyTorch: render, surrogate
loss, autograd, Adam.

A step renders the image once from its own generator stream, takes the loss
2 * mean((hist - target) * image) against the detached history of the
previous render, differentiates it with torch.autograd into every material
and camera leaf, applies optax's Adam (b1 0.9, b2 0.999, eps 1e-8, one step
count for the whole tree, a leaf without a gradient taking a zero one), and
makes the detached image the next step's history.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import tracer as R
from .scene import Scene

B1, B2, EPS = 0.9, 0.999, 1e-8


def render(tab: R.Tables, gen_seed: int) -> torch.Tensor:
    """One sample a pixel of the whole frame, [H,W,3], its draws from a
    generator on the tables' device seeded `gen_seed` (camera: AA, lens,
    shutter; then four a bounce)."""
    sc = tab.scene
    n = sc.width * sc.height
    g = torch.Generator(device=tab.dev)
    g.manual_seed(int(gen_seed))
    pix = torch.arange(n, dtype=torch.int64, device=tab.dev)
    rad = R.trace(tab, pix, R.StreamDraws(g, n, tab.dev), sc.depth,
                  antialias=True, dof=True, motion=True)
    return rad.reshape(sc.height, sc.width, 3)


def train(scene: Scene, device, hist_seed: int, step_seeds: Sequence[int],
          lr: float = 1e-2, dtype=torch.float32) -> dict:
    """Steps from the scene's own values, the history seeded by a render
    from `hist_seed`, step k drawing from `step_seeds[k]`, toward a black
    target. Returns {"losses": [float], "grads": [{leaf: tensor}] of every
    step, "params": [{leaf: tensor}] after every step, "start": {leaf:
    tensor}}, all float64 on the host."""
    base = R.Tables(scene, device, dtype)
    leaves = {**{"materials." + k: v.clone().requires_grad_(True)
                 for k, v in base.materials.items()},
              **{"cam." + k: v.clone().requires_grad_(True)
                 for k, v in base.camera.items()}}
    tab = R.Tables(scene, device, dtype,
                   materials={k[10:]: v for k, v in leaves.items()
                              if k.startswith("materials.")},
                   camera={k[4:]: v for k, v in leaves.items()
                           if k.startswith("cam.")})

    def host(d):
        return {k: v.detach().double().cpu() for k, v in d.items()}

    out = dict(losses=[], grads=[], params=[], start=host(leaves))
    with torch.no_grad():
        hist = render(tab, hist_seed)
    target = torch.zeros_like(hist)
    mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
    nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for count, seed in enumerate(step_seeds, start=1):
        img = render(tab, seed)
        loss = 2.0 * torch.mean((hist.detach() - target) * img)
        names = list(leaves)
        got = torch.autograd.grad(loss, [leaves[k] for k in names],
                                  allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(names, got)}
        bc1 = 1.0 - B1 ** count
        bc2 = 1.0 - B2 ** count
        with torch.no_grad():
            for k, p in leaves.items():
                g = grads[k]
                mu[k] = (1 - B1) * g + B1 * mu[k]
                nu[k] = (1 - B2) * (g * g) + B2 * nu[k]
                p.add_(-lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS))
        hist = img.detach()
        out["losses"].append(float(loss.detach()))
        out["grads"].append(host(grads))
        out["params"].append(host(leaves))
        del img, loss, got
    return out
