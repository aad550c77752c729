"""Texture-fetch probe P1 on the card: how fast are 4M arbitrary texel
fetches, one packed u32 gather against three f32 gathers?

    python -m project3_cuda_path_tracer_tpu_torch.tools.exp_gather

Counterpart of tools/exp_gather.py (the JAX probe, whose Pallas kernel
`dgather` gathers rows of a lane-replicated [P, 128] u32 table). Here:
  cuda_gather_u32  the hand kernel csrc/gather.cu (`ops.texfetch.gather`,
                   the instance the table's size picks);
  plain_index_u32  its plain version, `table[idx.long()]`;
  torch_take_u32   torch.take of the packed table (the JAX `xla_take_u32`);
  torch_take_f32x3 three torch.take of an f32 table (`xla_take_f32x3`);
for 128x128 and 256x256 atlases (64 KB and 256 KB), N = 4,194,304 fetches.
It prints one JSON line per primitive and size, with ms per call (CUDA
events) and M elements/s, and needs a CUDA card.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..ops.texfetch import gather, gather_plain
from ..utils.device import time_ms

N = 1 << 22          # 4M fetches (one 2048x2048 bounce)
SIDES = (128, 256)   # atlas sides
SKY = (512, 256)     # scenes/assets/sky.hdr: 131,072 texels, 512 KB packed


def inputs(side, n: int = N, seed: int = 0, device="cuda"):
    """The probe's tables and indices: a random u32 atlas of side x side
    texels (side an int, or a (width, height) pair), an f32 one, and n
    random int32 indices into them."""
    rng = np.random.default_rng(seed)
    p = side * side if isinstance(side, int) else side[0] * side[1]
    table = torch.from_numpy(rng.integers(0, 2 ** 32, p, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(device)
    flat_f32 = torch.from_numpy(rng.random(p, dtype=np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, p, n).astype(np.int32)).to(device)
    return table.view(torch.uint32), flat_f32, idx


def measure(side: int, n: int = N) -> list:
    """One record per primitive at one atlas size, on the card: the kernel
    and its plain version timed in turns (plain, kernel, kernel, plain)."""
    table, flat_f32, idx = inputs(side, n)
    want = gather_plain(table, idx)
    got = gather(table, idx)
    torch.cuda.synchronize()
    correct = torch.equal(got.view(torch.int32), want.view(torch.int32))
    idx64 = idx.long()
    t_i32 = table.view(torch.int32)
    prims = {
        "plain_index_u32": (lambda: gather_plain(table, idx), 1),
        "cuda_gather_u32": (lambda: gather(table, idx), 1),
        "torch_take_u32": (lambda: torch.take(t_i32, idx64), 1),
        "torch_take_f32x3": (lambda: (torch.take(flat_f32, idx64),
                                      torch.take(flat_f32, idx64),
                                      torch.take(flat_f32, idx64)), 3),
    }
    runs = {k: [] for k in prims}
    for name in ("plain_index_u32", "cuda_gather_u32", "cuda_gather_u32",
                 "plain_index_u32", "torch_take_u32", "torch_take_f32x3"):
        runs[name].append(time_ms(prims[name][0], 20, warm=3))
    out = []
    for name, (_, fetches) in prims.items():
        ms = float(np.mean(runs[name]))
        rec = {"prim": name, "P": side * side, "ms": ms, "runs": runs[name],
               "m_elem_s": fetches * n / (ms * 1e-3) / 1e6}
        if name == "cuda_gather_u32":
            rec["correct"] = bool(correct)
        out.append(rec)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("exp_gather: needs a CUDA card")
    print("device:", torch.cuda.get_device_name(0), flush=True)
    for side in SIDES:
        for rec in measure(side):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
