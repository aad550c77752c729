"""Same-call A/B of the binary-tree traversals K3 and K4 against a baseline
checkout's csrc/bvh_binary.cu, on the card.

    mkdir -p out/base && git archive <commit> | tar -x -C out/base
    python -m project3_cuda_path_tracer_tpu_torch.tools.k3_ab \\
        --baseline out/base

The baseline is the first port's kernel: one thread per ray, the rays
stacked into two [3, N] blocks by its wrapper, two rows a node step
(nodes_f and nodes_i); its C entry is bvh_binary_traverse(qo, qd,
t_bound, n, nodes_f, nodes_i, tris, sub, out, tri, stream). On the
wavefront of every bounce of one `pack_all` iteration of scenes/mesh.txt
(the renderer's 8 K3 launches), it holds the baseline's K3 against this
tree's grid instance bit for bit (t, normal, uv, tri), reports how many
lanes' tri the baseline's K4 shares, then times, with the stream held and
in turns (in order, then reversed): this tree's K3 grid and persistent
instances and K4; the baseline's K3 through its wrapper (stacking copies
included) and on rays stacked beforehand (its kernel alone); the
baseline's K4 through its wrapper. One JSON line per bounce, then the
sums and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import pallas_bvh as PB
from ..utils import cuda_build
from ..utils.device import time_ms

ENTRY = "bvh_binary_traverse(const float* qo, const float* qd,"
MESH = os.path.join(os.path.dirname(cuda_build.PKG_DIR), "scenes", "mesh.txt")
ITERS = 20  # timed calls a turn, as chip_smoke.py times K3


def build_baseline(root: str) -> ctypes.CDLL:
    """Compile the baseline's csrc/bvh_binary.cu (its own headers) into
    this package's build directory and load it."""
    csrc = os.path.join(root, "project3_cuda_path_tracer_tpu_torch", "csrc")
    src = os.path.join(csrc, "bvh_binary.cu")
    with open(src) as f:
        if ENTRY not in f.read():
            raise ValueError(f"{src} is not the stacked-ray kernel this "
                             "A/B binds")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(cuda_build.BUILD_DIR, "libbvh_binary_baseline.so")
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                           "-o", lib, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src}:\n{proc.stderr}")
    dll = ctypes.CDLL(lib)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dll.bvh_binary_traverse.argtypes = ([ptr] * 3 + [i32] + [ptr] * 3
                                        + [i32] + [ptr] * 3)
    dll.bvh_binary_traverse.restype = i32
    return dll


def baseline(lib, qo, qd, pb, tb, sub: bool, stacked=None):
    """The baseline's wrapper: stack the planes (unless `stacked` holds
    them already), then launch on the current stream."""
    n = qo[0].shape[0]
    o, d = stacked if stacked is not None else (torch.stack(list(qo)),
                                                torch.stack(list(qd)))
    out = torch.empty((6, n), device=o.device)
    tri = torch.empty((n,), dtype=torch.int32, device=o.device)
    rc = lib.bvh_binary_traverse(
        o.data_ptr(), d.data_ptr(), tb.data_ptr(), n, pb.nodes_f.data_ptr(),
        pb.nodes_i.data_ptr(), pb.tris.data_ptr(), int(sub), out.data_ptr(),
        tri.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"baseline bvh_binary launch failed: {rc}")
    return PB.unpack_out(out, tri)


def same_bits(a, b) -> bool:
    """(t, normal, u, v, tri) of two traversals equal bit for bit."""
    fa = torch.stack([a[0], *a[1], a[2], a[3]]).view(torch.int32)
    fb = torch.stack([b[0], *b[1], b[2], b[3]]).view(torch.int32)
    return torch.equal(fa, fb) and torch.equal(a[4], b[4])


def bounce_waves(r) -> list:
    """(qo, qd, t_bound) of each K3 launch of one iteration of `r`."""
    kernel, waves = PB.traverse, []

    def capture(qo, qd, packed, t_bound=None, **kwargs):
        waves.append((tuple(c.clone() for c in qo),
                      tuple(c.clone() for c in qd), t_bound.clone()))
        return kernel(qo, qd, packed, t_bound=t_bound, **kwargs)

    PB.traverse = capture
    try:
        r.step()
    finally:
        PB.traverse = kernel
    torch.cuda.synchronize()
    return waves


def main(argv=None) -> int:
    from .. import Renderer, load_scene
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="root of the baseline checkout")
    args = ap.parse_args(argv)
    lib = build_baseline(args.baseline)
    scene = load_scene(MESH)
    r = Renderer(dataclasses.replace(
        scene, packed_meshes=PB.pack_all(scene.meshes)), device="cuda")
    pb = r.packed_meshes[0]
    total = {}
    for b, (qo, qd, tb) in enumerate(bounce_waves(r)):
        stacked = (torch.stack(list(qo)), torch.stack(list(qd)))
        grid = PB._launch("grid", qo, qd, pb, tb)
        base = baseline(lib, qo, qd, pb, tb, False)
        base_k4 = baseline(lib, qo, qd, pb, tb, True)
        torch.cuda.synchronize()
        if not same_bits(grid, base):
            raise AssertionError(f"bounce {b}: the baseline's K3 differs "
                                 "from the grid instance")
        fns = {
            "grid": lambda: PB._launch("grid", qo, qd, pb, tb),
            "persistent": lambda: PB._launch("persistent", qo, qd, pb, tb),
            "K4": lambda: PB._launch("packet", qo, qd, pb, tb),
            "baseline K3": lambda: baseline(lib, qo, qd, pb, tb, False),
            "baseline K3 kernel": lambda: baseline(lib, qo, qd, pb, tb,
                                                   False, stacked),
            "baseline K4": lambda: baseline(lib, qo, qd, pb, tb, True),
        }
        names = list(fns)
        held = {k: [] for k in names}
        for k in names + names[::-1]:
            held[k].append(time_ms(fns[k], ITERS, warm=3))
        rec = {k: float(np.mean(v)) for k, v in held.items()}
        for k, v in rec.items():
            total[k] = total.get(k, 0.0) + v
        print(json.dumps(dict(
            bounce=b, rays=int(tb.numel()),
            dead_share=float((~(tb > 0)).float().mean()),
            baseline_k3_bitwise=True,
            baseline_k4_tri_agree=float((base_k4[4] == grid[4]).float()
                                        .mean()),
            ms=rec, runs=held)), flush=True)
    print(json.dumps(dict(sums=total)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
