"""Dependent-load probe P2 on the card: what does one step of a chain
load row -> fold scalars -> reduce -> next row cost, the chain a BVH
traversal walks per pop?

    python -m project3_cuda_path_tracer_tpu_torch.tools.exp_extract_cost

Counterpart of tools/exp_extract_cost.py (the JAX probe, whose Pallas
kernels `make(kind)` run the chain in a Mosaic while loop). Three kinds over
a [4096, 72] f32 table and a [16, 128] f32 state, 4,096 dependent steps:
extract6 and extract48 fold 6 or 48 scalars of the row into the whole
state, vector8 folds the row's [8, 9] block row-wise into the state's
first 8 rows (csrc/extract_cost.cu states the arithmetic). It prints one
JSON line per kind with the kernel's ns per step (CUDA events) and the
plain version's on a shorter loop, and needs a CUDA card.

`chain_terms` measures on the card what one step of the chain must take at
least, term by term (a dependent row load, a dependent FP32 operation, a
dependent shuffle), and `chain_floor_ns` adds them up for a kind.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import time_ms

ROWS = 4096          # node-table rows
STEPS = 4096         # dependent loop steps
SUB = 16
LANES = 128
ROW = 72
KINDS = {"extract6": 0, "extract48": 1, "vector8": 2}
ROW0_SCALARS = {"extract6": 6, "extract48": 48, "vector8": 6}  # into row 0
PLAIN_STEPS = 256    # the plain version's loop on the card (eager ops)
# SHA-256 of the state's bytes after STEPS steps from `inputs()`: the
# output of the first port's one-block kernel (commit 6e06402, run on the
# card), which the plain version also gives.
SHA256_STEPS = {
    "extract6":
        "599fb960535812908244f97418ea3707c188448982d8c05febbc58f658399c24",
    "extract48":
        "61da9583952404c0741e0eb06eb8ed2508b5d45963f8887ccaf8660cbb6d6616",
    "vector8":
        "d979c4dab8fad05818c38eceef1a2516cdfbadb6fbc4f0f52becd16149e5df0b",
}
LAUNCHES = 0


def _check(table: torch.Tensor, state: torch.Tensor, kind: str,
           steps: int) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {tuple(KINDS)}, got {kind!r}")
    if steps < 0:
        raise ValueError("steps must be >= 0")
    for name, t, shape in (("table", table, None), ("state", state,
                                                     (SUB, LANES))):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous float32 tensor")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}")
    if table.ndim != 2 or table.shape[1] != ROW or table.shape[0] < 1:
        raise ValueError(f"table must have shape [rows, {ROW}]")
    if table.device != state.device:
        raise ValueError("table and state must be on one device")
    if table.device.type == "cuda" and table.data_ptr() % 16:
        raise ValueError("the kernel reads rows as 16-byte vectors: the "
                         "table must be 16-byte aligned")


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of 128 lanes as pairwise halvings, x[:h] + x[h:2h] for h = 64,
    32, ..., 1: the kernel's fixed tree, so both round alike."""
    h = x.shape[0] // 2
    while h:
        x = x[:h] + x[h:2 * h]
        h //= 2
    return x[0]


def extract_cost_plain(table: torch.Tensor, state: torch.Tensor, kind: str,
                       steps: int) -> torch.Tensor:
    """The probe's loop in torch ops. The row index stays a one-element
    tensor on the table's device and is read by index_select (indexing
    with a 0-dim tensor would read it on the host): no host sync per
    step."""
    rows = table.shape[0]
    st = state.clone()
    idx = torch.zeros((1,), dtype=torch.int64, device=table.device)
    for step in range(steps):
        row = table.index_select(0, idx)[0]
        if kind == "vector8":
            v = row.reshape(8, 9)
            a = st[:8]
            for j in range(6):
                a = a * 0.999 + v[:, j:j + 1]
            st = torch.cat([a, st[8:]])
        else:
            for k in range(48 if kind == "extract48" else 6):
                st = st * 0.999 + row[k]
        nxt = _lane_sum(st[0]).to(torch.int32) + step
        idx = torch.remainder(nxt, rows).to(torch.int64).reshape(1)
    return st


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load("extract_cost")
    lib.extract_cost_run.restype = ctypes.c_int
    lib.extract_cost_run.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.extract_cost_floor.restype = ctypes.c_int
    lib.extract_cost_floor.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_void_p]
    lib.extract_cost_error_string.restype = ctypes.c_char_p
    lib.extract_cost_error_string.argtypes = [ctypes.c_int]
    return lib


def extract_cost(table: torch.Tensor, state: torch.Tensor, kind: str,
                 steps: int) -> torch.Tensor:
    """The state after `steps` steps of the probe's loop. CPU tensors take
    `extract_cost_plain`; CUDA tensors launch csrc/extract_cost.cu (61
    warps, each deriving the row sequence itself) on the current stream,
    counted in LAUNCHES."""
    global LAUNCHES
    _check(table, state, kind, steps)
    if table.device.type == "cpu":
        return extract_cost_plain(table, state, kind, steps)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    out = torch.empty_like(state)
    lib = _kernel_lib()
    with torch.cuda.device(table.device):
        rc = lib.extract_cost_run(table.data_ptr(), table.shape[0],
                                  state.data_ptr(), out.data_ptr(), steps,
                                  KINDS[kind],
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("extract_cost launch failed: "
                           + lib.extract_cost_error_string(rc).decode())
    LAUNCHES += 1
    return out


FLOOR_ENTRIES = {"chase": 0, "fold": 1, "shuffle": 2}


def _floor_launch(which: str, table: torch.Tensor, n: int,
                  sink: torch.Tensor) -> None:
    """One warp of one of the chain floor's entries in csrc/extract_cost.cu:
    `chase` n dependent row loads over `table`, `fold` n dependent folds
    (2n FP32 operations), `shuffle` n dependent shuffles."""
    lib = _kernel_lib()
    with torch.cuda.device(table.device):
        rc = lib.extract_cost_floor(FLOOR_ENTRIES[which], table.data_ptr(),
                                    table.shape[0], n, sink.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("extract_cost_floor launch failed: "
                           + lib.extract_cost_error_string(rc).decode())


def chain_terms(table: torch.Tensor, steps: int = STEPS) -> dict:
    """On the card, the latency of each term of one step of the chain, in
    ns: `chase_ns` a dependent row load over `table` with the kernel's index
    arithmetic (plus one shuffle and one multiply of its own), `fop_ns` a
    dependent __fmul_rn or __fadd_rn, `shfl_ns` a dependent shuffle; from
    chains of `steps`, 48 x `steps` folds and 8 x `steps` shuffles, timed
    with the stream held."""
    _check(table, torch.empty((SUB, LANES), device=table.device), "extract6",
           steps)
    sink = torch.empty((32,), dtype=torch.int32, device=table.device)
    n = {"chase": steps, "fold": steps * 48, "shuffle": steps * 8}
    ms = {k: time_ms(lambda k=k: _floor_launch(k, table, n[k], sink), 5)
          for k in n}
    return {"chase_ns": ms["chase"] * 1e6 / n["chase"],
            "fop_ns": ms["fold"] * 1e6 / (2 * n["fold"]),
            "shfl_ns": ms["shuffle"] * 1e6 / n["shuffle"]}


def chain_floor_ns(terms: dict, kind: str) -> float:
    """The least ns a step of `kind` can take on its chain: one dependent row
    load with the index arithmetic (the chase, less its own multiply and
    shuffle), 2K dependent FP32 operations folding K scalars into row 0,
    the sum's 2 register adds, and its 5 shuffles."""
    k = ROW0_SCALARS[kind]
    return (terms["chase_ns"] + (2 * k + 2 - 1) * terms["fop_ns"]
            + (5 - 1) * terms["shfl_ns"])


def sha256(state: torch.Tensor) -> str:
    """SHA-256 of a state's float32 bytes (compare with SHA256_STEPS)."""
    return hashlib.sha256(state.detach().cpu().numpy().tobytes()).hexdigest()


def inputs(rows: int = ROWS, seed: int = 0, device="cuda"):
    """The JAX probe's table (uniform in [0.5, 1.5)) and initial state."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.random((rows, ROW), np.float32) + 0.5)
    state = torch.from_numpy(rng.random((SUB, LANES), np.float32))
    return table.to(device), state.to(device)


def measure(kind: str, steps: int = STEPS,
            plain_steps: int = PLAIN_STEPS) -> dict:
    """On the card: kernel against plain version at `plain_steps` (bit for
    bit), then the time of each, in turns (plain, kernel, kernel, plain):
    both at `plain_steps`, and the kernel alone at `steps`, whose ns per
    step is the probe's answer."""
    table, state = inputs()
    got = extract_cost(table, state, kind, plain_steps)
    want = extract_cost_plain(table, state, kind, plain_steps)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())

    def plain():
        extract_cost_plain(table, state, kind, plain_steps)

    def short():
        extract_cost(table, state, kind, plain_steps)

    def full():
        extract_cost(table, state, kind, steps)

    plain_ms = [time_ms(plain, 1)]
    short_ms = [time_ms(short, 5)]
    full_ms = [time_ms(full, 5), time_ms(full, 5)]
    short_ms.append(time_ms(short, 5))
    plain_ms.append(time_ms(plain, 1))
    f_ms = float(np.mean(full_ms))
    return {"kind": kind, "steps": steps, "ms_full": f_ms,
            "ns_per_step": f_ms * 1e6 / steps, "full_runs": full_ms,
            "plain_steps": plain_steps, "ms": float(np.mean(short_ms)),
            "kernel_runs": short_ms, "plain_ms": float(np.mean(plain_ms)),
            "plain_ns_per_step": float(np.mean(plain_ms)) * 1e6
            / plain_steps, "plain_runs": plain_ms, "max_abs_err": err,
            "bitwise": bool(torch.equal(got, want))}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("exp_extract_cost: needs a CUDA card")
    print("device:", torch.cuda.get_device_name(0), flush=True)
    for kind in KINDS:
        print(json.dumps(measure(kind)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
