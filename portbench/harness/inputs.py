"""Everything a run's seed decides, made by the benchmark and handed alike
to the program and to the reference.

The seed perturbs the colours of the materials that emit nothing and draws
the pixels the comparison samples and the train step's per-call seeds. It
never changes geometry, camera, resolution, depth, material kinds or the
light, so every seed does the same work."""
from __future__ import annotations

import os
import re
from typing import List

import numpy as np

from .spec import BENCH_DIR

WORK_DIR = os.path.join(BENCH_DIR, ".work")
_MASK64 = (1 << 64) - 1


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream `stream` of the run's seed."""
    return np.random.default_rng([int(seed) & _MASK64, int(stream)])


def scene_text(config: dict, seed: int) -> str:
    """The configuration's scene with each non-emissive material's RGB
    scaled by a factor in [0.85, 1) drawn from the seed (written as float32
    values, so both parsers read the same numbers), and each mesh file named
    by its path under the benchmark."""
    draws = rng(seed, 1)
    out, block, emissive, rgb_at = [], [], False, None

    def flush():
        if rgb_at is not None and not emissive:
            vals = [float(x) for x in block[rgb_at].split()[1:4]]
            f = 0.85 + 0.15 * draws.random(3)
            block[rgb_at] = "RGB " + " ".join(
                repr(float(np.float32(v * k))) for v, k in zip(vals, f))
        out.extend(block)

    in_mat = False
    for line in config["scene"]:
        tok = line.split()
        if tok and tok[0] == "MATERIAL":
            in_mat, block, emissive, rgb_at = True, [line], False, None
            continue
        if in_mat:
            if not tok:
                flush()
                in_mat = False
                out.append(line)
                continue
            if tok[0] == "RGB":
                rgb_at = len(block)
            if tok[0] == "EMITTANCE" and float(tok[1]) > 0:
                emissive = True
            block.append(line)
            continue
        if tok and tok[0] == "mesh":
            line = "mesh " + os.path.join(BENCH_DIR, config["meshes"][tok[1]])
        out.append(line)
    if in_mat:
        flush()
    return "\n".join(out) + "\n"


def write_scene(config: dict, seed: int) -> str:
    """The seeded scene written to the benchmark's work directory (a fixed
    path a configuration); returns the path."""
    os.makedirs(WORK_DIR, exist_ok=True)
    path = os.path.join(WORK_DIR, re.sub(r"[^\w.-]", "_", config["name"])
                        + ".txt")
    with open(path, "w") as f:
        f.write(scene_text(config, seed))
    return path


def pixel_sample(seed: int, pixels: int, k: int) -> np.ndarray:
    """`k` distinct pixel indices drawn from the seed, sorted."""
    return np.sort(rng(seed, 2).choice(pixels, size=min(k, pixels),
                                       replace=False))


def call_seeds(seed: int, n: int) -> List[int]:
    """The seeds of the train window's calls 0..n-1 (below 2^31)."""
    return [int(x) for x in rng(seed, 3).integers(0, 2 ** 31, size=n)]


def history_seed(seed: int) -> int:
    return int(rng(seed, 4).integers(0, 2 ** 31))


def seed32(seed: int, i: int) -> int:
    """The generator seed the program's train scan gives step i of a call
    seeded `seed` (models/inverse.step_generator's documented rule)."""
    return (int(seed) * 2654435761 + int(i)) & 0x7FFFFFFF
