"""Texel fetches: every 32-bit table take of the texture and env stages.

The JAX stages fetch a texel with `jnp.take` on a packed u32 plane (the
atlas's RGB8 texels, the env map's RGBE texels, the --bilinear-fast pair
planes, the env map's alias table); the port routes each such take through
`take_u32`, which is `table[idx]` over a flat 32-bit table: on a CUDA
tensor the hand kernel P1 (`gather`, csrc/gather.cu, the instance its
table's size picks: the table staged in each block's shared memory up to
200 KB, read through L2 above), on a CPU tensor P1's plain version
(`gather_plain`). There is no fallback: a CUDA table or index that P1 does
not take (a wrong dtype, a non-contiguous index, a failed build or launch)
raises.

P1 has two instances: the table staged in each block's shared memory
(`block`, k = 1) or read through L2 (`l2`, k = 0). `gather` picks one by
the table's size alone, before the launch (`instance_for`: `block` up to
SLICE_BYTES, `l2` above); `_gather_instance` launches either instance that
can hold the table, for the bitwise checks only. tools/exp_gather.py times
P1 against torch's gathers.

`fuse` builds, once when a scene's textures reach their device, the
concatenated atlas and env planes that the shader fetches hit and miss
lanes from with one gather (JAX concatenates them inside every call); the
env's texels start at index Ha*Wa.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from ..scene import types as T
from ..utils import cuda_build
from ..utils.launches import count, tally_address

MAX_FETCHES = 2 ** 31 - 1  # P1's indices are int32
# Bytes of table one block holds in shared memory (csrc/gather.cu's
# SLICE_MAX).
SLICE_BYTES = 200 * 1024
INSTANCES = {1: "block", 0: "l2"}


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
    """Shared-memory bytes instance k holds for a table of `texels` words:
    the table rounded up to 16 bytes (0 for k = 0)."""
    if k == 0:
        return 0
    return (texels + 3) // 4 * 16


def instance_for(table_bytes: int) -> int:
    """The instance for a table of `table_bytes` (4 a texel): the block
    instance (1) while the table fits one block's shared memory, else the
    L2 instance (0)."""
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
    """(grid, blocks per SM) of instance k's persistent grid for a table of
    `texels` words on the device, from the occupancy calculator (at most
    one block an SM), worked out once per device, instance and size."""
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
    table's size (counted under `p1`, and on the card in the `p1` tally of
    utils/launches.py), where an index outside the table reads 0."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_plain(table, idx)
    _need_cuda(table)
    out = _launch(instance_for(table.numel() * 4), table, idx,
                  tally_address(table.device, "p1"))
    count("p1")
    return out


def _gather_instance(k: int, table: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """Instance k (a key of INSTANCES) on CUDA tensors, whatever the
    table's size would pick: the bitwise checks (counted under `p1_ab`)."""
    if k not in INSTANCES:
        raise ValueError(f"instance must be one of {tuple(INSTANCES)}")
    _check(table, idx)
    _need_cuda(table)
    out = _launch(k, table, idx)
    count("p1_ab")
    return out


def take_u32(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a flat 32-bit table (int32 bits) and contiguous int32
    indices (gather's checks raise on anything else): P1 on a CUDA tensor,
    its plain version on a CPU one."""
    if idx.numel() > MAX_FETCHES:
        raise ValueError(f"{idx.numel()} fetches exceed int32 indexing")
    return gather(table, idx)


def take_f32(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a float32 table, fetched as its int32 bits."""
    return take_u32(table.view(torch.int32), idx).view(torch.float32)


def full(plane: torch.Tensor, texels: int) -> bool:
    """Whether a packed plane is present (not the (1,) placeholder) for an
    image of `texels` texels."""
    return plane.shape[0] == texels


def fuse(textures: T.Textures) -> T.Textures:
    """`textures` with `fused_packed` (atlas_packed then env_packed) and
    `fused_pair` (atlas_pair then env_pair, or env_packed where the env has
    no pair plane) built on their device, where the scene has both an atlas
    and an env map whose planes are present; else unchanged."""
    tx = textures
    if not (tx.has_atlas and tx.has_env):
        return tx
    na = tx.atlas.shape[0] * tx.atlas.shape[1]
    ne = tx.env.shape[0] * tx.env.shape[1]
    if not (full(tx.atlas_packed, na) and full(tx.env_packed, ne)):
        return tx
    out = dict(fused_packed=torch.cat([tx.atlas_packed, tx.env_packed]))
    if full(tx.atlas_pair, na):
        env = tx.env_pair if full(tx.env_pair, ne) else tx.env_packed
        out["fused_pair"] = torch.cat([tx.atlas_pair, env])
    return dataclasses.replace(tx, **out)
