"""The inputs on which the material gather's backward (ops/matgrad.py) is
held, on the CPU against a float64 sum and on the card (kernel G1)
against its plain version (not a test file; imports torch alone).

Each case is (material count M, planes C, lanes N, kind): the cornell
step's 640,000 lanes over 5 materials, one material, 258 (manylights256),
one past the kernel's widest tile of materials (48 / C: a second tile),
lane counts that are no multiple of a block (2,048 lanes) and one of more
than 256 blocks (a second round of pass 2), every lane on one material,
a plane without a gradient (None)."""
import numpy as np
import torch

CASES = [
    (5, 3, 640_000, "random"),
    (5, 1, 640_000, "random"),
    (1, 1, 3 * 2048 + 77, "random"),
    (1, 3, 2049, "random"),
    (258, 3, 20_011, "random"),
    (258, 1, 20_011, "random"),
    (17, 3, 9_000, "random"),
    (49, 1, 9_000, "random"),
    (5, 3, 256 * 2048 + 1, "random"),
    (5, 3, 640_000, "one material"),
    (5, 3, 50_003, "none plane"),
    (5, 1, 0, "random"),
]
IDS = [f"m{m}-c{c}-n{n}-{kind.replace(' ', '_')}"
       for m, c, n, kind in CASES]


def make(case, device="cpu", seed=0):
    """(mat_id [N] int64, C gradient planes [N] float32 or None, M)."""
    m, c, n, kind = case
    rng = np.random.default_rng(seed)
    ids = (np.full(n, 3) if kind == "one material"
           else rng.integers(0, m, n))
    planes = [torch.from_numpy(rng.standard_normal(n, np.float32)).to(device)
              for _ in range(c)]
    if kind == "none plane":
        planes[1] = None
    return torch.from_numpy(ids.astype(np.int64)).to(device), planes, m
