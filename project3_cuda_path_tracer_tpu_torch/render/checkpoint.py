"""Checkpoint and resume of progressive renders.

Counterpart of project3_cuda_path_tracer_tpu/render/checkpoint.py, kept as
its own copy (the port imports nothing of the JAX package). The state is
(accumulator, iteration, seed, scene-file hash); the hash guards against
resuming onto a different scene. The `.ckpt.npz` keys are the JAX
package's (`accum`, `iteration`, `seed`, `scene_hash`, and the renderer's
extras under an `x_` prefix), so a file written by either package loads in
the other.

A file loads across packages, but the sample stream does not carry over:
the seed drives jax.random in the JAX package and a torch generator (or the
kernels' Philox) here, so a JAX checkpoint resumed in the port continues
with different samples from the ones the JAX render would have drawn.
Resuming within one package continues the same stream.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np


def scene_hash(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def save_checkpoint(path: str, accum: np.ndarray, iteration: int,
                    seed: int, scene_path: str,
                    extras: Optional[dict] = None) -> None:
    """`extras` holds renderer state beyond the (accum, iteration) pair,
    e.g. adaptive sampling's per-pixel counts and luminance^2 sums or the
    ReSTIR reservoir, stored under an `x_` prefix."""
    xs = {f"x_{k}": np.asarray(v) for k, v in (extras or {}).items()}
    np.savez_compressed(
        path, accum=np.asarray(accum), iteration=np.int64(iteration),
        seed=np.int64(seed),
        scene_hash=np.frombuffer(
            scene_hash(scene_path).encode(), dtype=np.uint8), **xs)


def load_checkpoint(path: str, scene_path: str
                    ) -> Tuple[np.ndarray, int, int]:
    """Returns (accum, iteration, seed); raises if the scene changed."""
    with np.load(path) as z:
        stored = bytes(z["scene_hash"]).decode()
        current = scene_hash(scene_path)
        if stored != current:
            raise ValueError(
                f"checkpoint was created for a different scene "
                f"(hash {stored} != {current})")
        return (np.asarray(z["accum"]), int(z["iteration"]), int(z["seed"]))


def load_extras(path: str) -> dict:
    """The `x_`-prefixed extras a checkpoint carries (empty for a plain
    uniform render's)."""
    with np.load(path) as z:
        return {k[2:]: np.asarray(z[k]) for k in z.files
                if k.startswith("x_")}


def find_checkpoint(base: str) -> Optional[str]:
    p = base + ".ckpt.npz"
    return p if os.path.exists(p) else None
