"""Texture-fetch probe P1 on the card: how fast are 4M arbitrary texel
fetches, one packed u32 gather against three f32 gathers?

    python -m project3_cuda_path_tracer_tpu_torch.tools.exp_gather

Counterpart of tools/exp_gather.py (the JAX probe, whose Pallas kernel
`dgather` gathers rows of a lane-replicated [P, 128] u32 table). Here:
  cuda_gather_u32  the hand kernel csrc/gather.cu (`gather`);
  plain_index_u32  its plain version, `table[idx.long()]`;
  torch_take_u32   torch.take of the packed table (the JAX `xla_take_u32`);
  torch_take_f32x3 three torch.take of an f32 table (`xla_take_f32x3`);
for 128x128 and 256x256 atlases (64 KB and 256 KB), N = 4,194,304 fetches.
It prints one JSON line per primitive and size, with ms per call (CUDA
events) and M elements/s, and needs a CUDA card.

The kernel has four instances: the table staged in each block's shared
memory (`block`, k = 1), split across a thread block cluster of k = 2 or 4
blocks and read through distributed shared memory (`cluster2`,
`cluster4`), or read through L2 (`l2`, k = 0). `gather` picks one by the
table's size alone, before the launch (`instance_for`: `block` up to
SLICE_BYTES, `l2` above); `_gather_instance` launches any instance that
can hold the table, for the A/B and the bitwise checks only.
"""
from __future__ import annotations

import ctypes
import functools
import json
from typing import Optional

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import time_ms
from ..utils.launches import tally_address

N = 1 << 22          # 4M fetches (one 2048x2048 bounce)
SIDES = (128, 256)   # atlas sides
SKY = (512, 256)     # scenes/assets/sky.hdr: 131,072 texels, 512 KB packed
# Bytes of table one block holds in shared memory (csrc/gather.cu's
# SLICE_MAX).
SLICE_BYTES = 200 * 1024
INSTANCES = {1: "block", 2: "cluster2", 4: "cluster4", 0: "l2"}
LAUNCHES = 0
LAUNCHES_AB = 0  # _gather_instance, the A/B entry


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dtype not in (torch.uint32, torch.int32) or table.ndim != 1:
        raise TypeError("table must be a 1-D uint32 (or int32) tensor")
    if idx.dtype != torch.int32:
        raise TypeError("idx must be int32")
    if table.device != idx.device:
        raise ValueError("table and idx must be on one device")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if not 0 < table.numel() < 2 ** 31:
        raise ValueError("the table needs 1 to 2**31 - 1 entries")


def slice_bytes(texels: int, k: int) -> int:
    """Shared-memory bytes a block of a k-block cluster holds for a table of
    `texels` words: its slice rounded up to 16 bytes (0 for k = 0)."""
    if k == 0:
        return 0
    return (-(-texels // k) + 3) // 4 * 16


def instance_for(table_bytes: int) -> int:
    """The instance for a table of `table_bytes` (4 a texel): the block
    instance (1) while the table fits one block's shared memory, else the
    L2 instance (0). The cluster instances (2, 4) read a neighbour's slice
    slower than L2 serves a random read on an H100 (PERF.md, P1), so only
    `_gather_instance` reaches them."""
    return 1 if slice_bytes(table_bytes // 4, 1) <= SLICE_BYTES else 0


def gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out = table[idx] in torch ops (the int32 view carries the bits:
    torch indexes uint32 tensors only on some devices)."""
    return table.view(torch.int32)[idx.long()].view(table.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load("gather")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gather_plan.restype = i32
    lib.gather_plan.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.gather_launch.restype = i32
    lib.gather_launch.argtypes = [i32, i32, ptr, i32, i32, ptr, ptr,
                                  ctypes.c_longlong, i32, ptr, ptr]
    lib.gather_error_string.restype = ctypes.c_char_p
    lib.gather_error_string.argtypes = [i32]
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"gather {what} failed: "
                           + _kernel_lib().gather_error_string(rc).decode())


@functools.lru_cache(maxsize=None)
def plan(device_index: int, k: int, texels: int) -> tuple:
    """(grid, blocks per SM or active clusters) of instance k's persistent
    grid for a table of `texels` words on the device, from the occupancy
    calculator (at most one block an SM for k <= 1), worked out once per
    device, instance and size."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        _raise_on(_kernel_lib().gather_plan(k, texels, out), "plan")
    return out[0], out[1]


def _launch(k: int, table: torch.Tensor, idx: torch.Tensor,
            launches: Optional[int] = None) -> torch.Tensor:
    """Instance k of csrc/gather.cu on the current stream; `launches`, the
    address of a device tally the kernel adds one to, or None."""
    if slice_bytes(table.numel(), k) > SLICE_BYTES:
        raise ValueError(f"a {table.numel() * 4}-byte table does not fit "
                         f"instance {INSTANCES[k]}")
    out = torch.empty(idx.shape, dtype=table.dtype, device=table.device)
    grid, _ = plan(table.device.index, k, table.numel())
    with torch.cuda.device(table.device):
        rc = _kernel_lib().gather_launch(
            k, grid, table.data_ptr(), table.numel(),
            int(table.data_ptr() % 16 == 0), idx.data_ptr(), out.data_ptr(),
            idx.numel(), int(idx.data_ptr() % 16 == 0), launches,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, f"{INSTANCES[k]} launch")
    return out


def _need_cuda(table: torch.Tensor) -> None:
    if table.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, not {table.device}")


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a flat 32-bit table and int32 indices of any shape.
    CPU tensors take `gather_plain`; CUDA tensors launch csrc/gather.cu on
    the current stream, the instance that `instance_for` picks for the
    table's size (counted in LAUNCHES, and on the card in the `p1` tally
    of utils/launches.py), where an index outside the table reads 0."""
    global LAUNCHES
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_plain(table, idx)
    _need_cuda(table)
    out = _launch(instance_for(table.numel() * 4), table, idx,
                  tally_address(table.device, "p1"))
    LAUNCHES += 1
    return out


def _gather_instance(k: int, table: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """Instance k (a key of INSTANCES) on CUDA tensors, whatever the
    table's size would pick: the A/B and the bitwise checks (counted in
    LAUNCHES_AB)."""
    global LAUNCHES_AB
    if k not in INSTANCES:
        raise ValueError(f"instance must be one of {tuple(INSTANCES)}")
    _check(table, idx)
    _need_cuda(table)
    out = _launch(k, table, idx)
    LAUNCHES_AB += 1
    return out


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
