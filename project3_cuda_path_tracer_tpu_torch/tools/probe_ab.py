"""Same-call A/B of the probe kernels P1 (csrc/gather.cu) and P2
(csrc/extract_cost.cu) against a baseline checkout's, on the card.

    mkdir -p out/base && git archive 6e06402 | tar -x -C out/base
    python -m project3_cuda_path_tracer_tpu_torch.tools.probe_ab \\
        --baseline out/base

The baseline is the first port's pair: P1 one thread per index reading the
table through __ldg (C entry gather_u32(table, P, idx, out, n, stream)),
P2 one block of 128 threads with a shared-memory tree and barriers every
step (extract_cost_run(table, rows, state0, out, steps, kind, stream)).
P1, on the probe's 64 KB and 256 KB atlases and the 512 KB sky table: the
baseline's output equal to this tree's bit for bit, then both timed in
turns (this tree, baseline, baseline, this tree), warm with the stream held
and cold (each call after a 128 MB write). P2, each kind at 4,096 steps:
both outputs equal bit for bit and the baseline's SHA-256, then ns per step
in turns. One JSON line per size or kind, then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import time_cold_ms, time_ms
from . import exp_extract_cost as P2
from . import exp_gather as P1

ENTRIES = {"gather": "gather_u32(const uint32_t* table",
           "extract_cost": "extract_cost_run(const float* table"}


def build_baseline(root: str, name: str) -> ctypes.CDLL:
    """Compile the baseline's csrc/<name>.cu into this package's build
    directory and load it; raises unless it has the C entry this A/B
    binds."""
    src = os.path.join(root, "project3_cuda_path_tracer_tpu_torch", "csrc",
                       name + ".cu")
    with open(src) as f:
        if ENTRIES[name] not in f.read():
            raise ValueError(f"{src} has no {ENTRIES[name].split('(')[0]} "
                             "entry to bind")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(cuda_build.BUILD_DIR, f"lib{name}_baseline.so")
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                           "-o", lib, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src}:\n{proc.stderr}")
    dll = ctypes.CDLL(lib)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "gather":
        dll.gather_u32.argtypes = [ptr, i32, ptr, ptr, ctypes.c_longlong, ptr]
        dll.gather_u32.restype = i32
    else:
        dll.extract_cost_run.argtypes = [ptr, i32, ptr, ptr, i32, i32, ptr]
        dll.extract_cost_run.restype = i32
    return dll


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def base_gather(lib, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(idx).view(torch.uint32)
    rc = lib.gather_u32(table.data_ptr(), table.numel(), idx.data_ptr(),
                        out.data_ptr(), idx.numel(), _stream())
    if rc != 0:
        raise RuntimeError(f"baseline gather launch failed: {rc}")
    return out


def base_extract(lib, table, state, kind: str, steps: int) -> torch.Tensor:
    out = torch.empty_like(state)
    rc = lib.extract_cost_run(table.data_ptr(), table.shape[0],
                              state.data_ptr(), out.data_ptr(), steps,
                              P2.KINDS[kind], _stream())
    if rc != 0:
        raise RuntimeError(f"baseline extract_cost launch failed: {rc}")
    return out


def turns(fns: dict, timer) -> dict:
    """Each of the two fns timed by `timer` in turns: a, b, b, a."""
    a, b = fns
    runs = {a: [], b: []}
    for k in (a, b, b, a):
        runs[k].append(timer(fns[k]))
    return runs


def p1_ab(lib) -> None:
    for side in (*P1.SIDES, P1.SKY):
        table, _, idx = P1.inputs(side)
        new, base = P1.gather(table, idx), base_gather(lib, table, idx)
        torch.cuda.synchronize()
        if not torch.equal(new.view(torch.int32), base.view(torch.int32)):
            raise AssertionError(f"P1 at {table.numel()} texels: the "
                                 "baseline differs")
        fns = {"new": lambda: P1.gather(table, idx),
               "baseline": lambda: base_gather(lib, table, idx)}
        warm = turns(fns, lambda f: time_ms(f, 20, warm=3))
        cold = turns(fns, lambda f: float(np.median(time_cold_ms(f, 10))))
        print(json.dumps(dict(
            probe="P1", texels=table.numel(), table_bytes=table.numel() * 4,
            instance=P1.INSTANCES[P1.instance_for(table.numel() * 4)],
            bitwise=True, ms={k: float(np.mean(v)) for k, v in warm.items()},
            cold_ms={k: float(np.mean(v)) for k, v in cold.items()},
            runs=warm, cold_runs=cold)), flush=True)


def p2_ab(lib) -> None:
    table, state = P2.inputs()
    for kind in P2.KINDS:
        new = P2.extract_cost(table, state, kind, P2.STEPS)
        base = base_extract(lib, table, state, kind, P2.STEPS)
        torch.cuda.synchronize()
        if not torch.equal(new, base):
            raise AssertionError(f"P2 {kind}: the baseline differs")
        fns = {"new": lambda: P2.extract_cost(table, state, kind, P2.STEPS),
               "baseline": lambda: base_extract(lib, table, state, kind,
                                                P2.STEPS)}
        runs = turns(fns, lambda f: time_ms(f, 5))
        print(json.dumps(dict(
            probe="P2", kind=kind, steps=P2.STEPS, bitwise=True,
            baseline_sha256=hashlib.sha256(
                base.cpu().numpy().tobytes()).hexdigest(),
            ns_per_step={k: float(np.mean(v)) * 1e6 / P2.STEPS
                         for k, v in runs.items()}, runs=runs)), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="root of the baseline checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_ab: needs a CUDA card")
    p1_ab(build_baseline(args.baseline, "gather"))
    p2_ab(build_baseline(args.baseline, "extract_cost"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
