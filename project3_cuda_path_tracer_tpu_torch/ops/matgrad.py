"""The per-lane material gather with a hand-written backward (G1).

`select(table, mat_id)` is `table[mat_id]` for an [M] or [M,3] table, the
[M,3] rows handed out as three planes, as ops/wavefront._mat_select reads
every material field on every bounce. Its forward is that gather; its
backward, the per-material sum of the lanes' gradients,

    grad_table[m, c] = sum over lanes i with mat_id[i] == m of g_c[i],

is `mat_grad`: on CUDA tensors the kernel csrc/mat_grad.cu (two passes, no
atomic on a value, a fixed order of summation, so two runs agree bit for
bit), on CPU tensors `mat_grad_plain`, which repeats the kernel's partition
of the lanes and its order of summation in torch ops and gives the same
bits. It replaces index_put_(accumulate=True), torch's backward of the
gather, which serialises each run of equal indices: with a few materials
over many lanes it took ~57 ms a launch on an H100 (PERF.md).

The kernel library is built at the first backward on a card (never by a
render, which takes no gradient). Each `mat_grad` call on the card counts
under `mat_grad` and, from the device, adds one to the `mat_grad` slot of
utils/launches.py's tally.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils import cuda_build
from ..utils.launches import count, tally_address

# csrc/mat_grad.cu's partition: a pass-1 block of THREADS threads owns
# BLOCK_LANES consecutive lanes, thread t the lanes k * THREADS + t of them;
# pass 2 sums the blocks' partials with SUM_THREADS threads.
THREADS = 256
WARP = 32
LANES_PER_THREAD = 8
BLOCK_LANES = THREADS * LANES_PER_THREAD
SUM_THREADS = 256
# the plain version's material tile: bounds its [blocks, THREADS, tile, C]
# accumulator (it does not change the sums)
PLAIN_TILE = 16


def _block_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum `x` over `dim` (THREADS or SUM_THREADS long) as a kernel block
    does: within each warp of 32 by halving (lane l + lane l + 16, then + 8,
    4, 2, 1: the shuffle butterfly's lane 0), then the warps in order."""
    x = x.unflatten(dim, (x.shape[dim] // WARP, WARP))
    half = WARP // 2
    while half:
        x = x.narrow(dim + 1, 0, half) + x.narrow(dim + 1, half, half)
        half //= 2
    x = x.squeeze(dim + 1)
    out = x.select(dim, 0)
    for w in range(1, x.shape[dim]):
        out = out + x.select(dim, w)
    return out


def mat_grad_plain(mat_id: torch.Tensor,
                   grads: Sequence[Optional[torch.Tensor]],
                   m: int) -> torch.Tensor:
    """The [m, C] per-material sums of C gradient planes (None reads 0) over
    the lanes of `mat_id` (ids outside [0, m) add nothing), in
    csrc/mat_grad.cu's order, bit for bit: the lanes padded to whole
    blocks; each thread's lanes in order; each block by `_block_sum`; the
    blocks' partials, thread j of pass 2 those of blocks j, j +
    SUM_THREADS, ..., in order, then `_block_sum`."""
    ids = mat_id.reshape(-1).to(torch.int64)
    n = ids.numel()
    like = next((g for g in grads if g is not None), None)
    dtype = like.dtype if like is not None else torch.float32
    planes = torch.stack([
        torch.zeros(n, dtype=dtype, device=ids.device) if g is None
        else g.reshape(-1).to(dtype) for g in grads], -1)
    blocks = -(-n // BLOCK_LANES)
    pad = blocks * BLOCK_LANES - n
    ids = F.pad(ids, (0, pad), value=-1).view(blocks, LANES_PER_THREAD,
                                              THREADS)
    planes = F.pad(planes, (0, 0, 0, pad)).view(
        blocks, LANES_PER_THREAD, THREADS, len(grads))
    parts = []
    for m0 in range(0, m, PLAIN_TILE):
        mats = torch.arange(m0, min(m, m0 + PLAIN_TILE), device=ids.device)
        acc = planes.new_zeros((blocks, THREADS, len(mats), len(grads)))
        for k in range(LANES_PER_THREAD):
            hit = (ids[:, k, :, None] == mats)[..., None]
            acc = acc + torch.where(hit, planes[:, k, :, None, :], 0.0)
        parts.append(_block_sum(acc, 1))
    part = torch.cat(parts, 1)  # [blocks, m, C]
    rounds = -(-blocks // SUM_THREADS)
    part = F.pad(part, (0, 0, 0, 0, 0, rounds * SUM_THREADS - blocks)).view(
        rounds, SUM_THREADS, m, len(grads))
    acc = part.new_zeros(part.shape[1:])
    for r in range(rounds):
        acc = acc + part[r]
    return _block_sum(acc, 0)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load("mat_grad")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mat_grad_launch.restype = i32
    lib.mat_grad_launch.argtypes = [i32, ptr, ptr, ptr, ptr, i64, i32, ptr,
                                    ptr, ptr, ptr]
    lib.mat_grad_block_lanes.restype = i64
    lib.mat_grad_block_lanes.argtypes = []
    lib.mat_grad_error_string.restype = ctypes.c_char_p
    lib.mat_grad_error_string.argtypes = [i32]
    if lib.mat_grad_block_lanes() != BLOCK_LANES:
        raise RuntimeError("csrc/mat_grad.cu's BLOCK_LANES is not "
                           f"ops/matgrad.BLOCK_LANES ({BLOCK_LANES})")
    return lib


def _mat_grad_kernel(mat_id: torch.Tensor,
                     grads: Sequence[Optional[torch.Tensor]],
                     m: int) -> torch.Tensor:
    """csrc/mat_grad.cu on the current stream: checks, scratch and output
    by torch.empty, no sync."""
    c = len(grads)
    if c not in (1, 3):
        raise ValueError(f"the kernel takes 1 or 3 planes, not {c}")
    if m <= 0:
        raise ValueError("the kernel needs a table of 1 or more rows")
    dev = mat_id.device
    ids = mat_id.reshape(-1).to(torch.int64).contiguous()
    n = ids.numel()
    planes = []
    for g in grads:
        if g is None:
            planes.append(None)
            continue
        if g.dtype != torch.float32 or g.device != dev or g.numel() != n:
            raise ValueError("each gradient plane must be float32 with one "
                             "value a lane, on mat_id's device")
        planes.append(g.reshape(-1).contiguous())
    ptrs = [None if g is None else g.data_ptr() for g in planes]
    ptrs += [None] * (3 - c)
    blocks = -(-n // BLOCK_LANES)
    part = torch.empty(max(blocks * m * c, 1), dtype=torch.float32,
                       device=dev)
    out = torch.empty((m, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        lib = _kernel_lib()
        rc = lib.mat_grad_launch(
            c, ids.data_ptr(), *ptrs, n, m, part.data_ptr(), out.data_ptr(),
            tally_address(dev, "mat_grad"),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("mat_grad launch failed: "
                           + lib.mat_grad_error_string(rc).decode())
    count("mat_grad")
    return out


def mat_grad(mat_id: torch.Tensor, grads: Sequence[Optional[torch.Tensor]],
             m: int) -> torch.Tensor:
    """The [m, C] per-material sums of the gradient planes `grads` (C = 1
    or 3; None reads 0): `mat_grad_plain` for CPU tensors, the kernel for
    CUDA tensors (float32 planes)."""
    if mat_id.device.type == "cpu":
        return mat_grad_plain(mat_id, grads, m)
    if mat_id.device.type != "cuda":
        raise ValueError(f"mat_grad takes CPU or CUDA tensors, not "
                         f"{mat_id.device}")
    return _mat_grad_kernel(mat_id, grads, m)


class MatSelect(torch.autograd.Function):
    """table[mat_id] for an [M] table, or its [M,3] rows as three planes,
    with `mat_grad` as the backward (a gradient for the table alone)."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, mat_id: torch.Tensor):
        ctx.save_for_backward(mat_id)
        ctx.table_shape = table.shape
        ctx.set_materialize_grads(False)
        rows = table[mat_id]
        if table.ndim == 1:
            return rows
        return rows[:, 0], rows[:, 1], rows[:, 2]

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        mat_id, = ctx.saved_tensors
        if all(g is None for g in grads):
            return None, None
        m = ctx.table_shape[0]
        return mat_grad(mat_id, grads, m).view(ctx.table_shape), None


def select(table: torch.Tensor, mat_id: torch.Tensor):
    """`MatSelect`: table[mat_id] ([M] table) or its three row planes
    ([M,3] table), differentiable in the table."""
    if table.ndim not in (1, 2) or (table.ndim == 2
                                    and table.shape[1] != 3):
        raise ValueError(f"an [M] or [M,3] table, not {tuple(table.shape)}")
    return MatSelect.apply(table, mat_id)
