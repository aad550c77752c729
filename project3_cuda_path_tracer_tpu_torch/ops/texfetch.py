"""Texel fetches: every 32-bit table take of the texture and env stages.

The JAX stages fetch a texel with `jnp.take` on a packed u32 plane (the
atlas's RGB8 texels, the env map's RGBE texels, the --bilinear-fast pair
planes, the env map's alias table); the port routes each such take through
`take_u32`, which is `table[idx]` over a flat 32-bit table: on a CUDA
tensor the hand kernel P1 (`tools.exp_gather.gather`, csrc/gather.cu, the
instance its table's size picks: the table staged in each block's shared
memory up to 200 KB, read through L2 above), on a CPU tensor P1's plain
version (`gather_plain`). There is no fallback: a CUDA table or index that
P1 does not take (a wrong dtype, a non-contiguous index, a failed build or
launch) raises.

`fuse` builds, once when a scene's textures reach their device, the
concatenated atlas and env planes that the shader fetches hit and miss
lanes from with one gather (JAX concatenates them inside every call); the
env's texels start at index Ha*Wa. It keeps the fused packed table's bytes
as the counter `texfetch.table_bytes` (utils/profiling.py).
"""
from __future__ import annotations

import dataclasses

import torch

from ..scene import types as T
from ..tools import exp_gather
from ..utils.profiling import set_counter

MAX_FETCHES = 2 ** 31 - 1  # P1's indices are int32


def take_u32(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a flat 32-bit table (int32 bits) and contiguous int32
    indices (gather's checks raise on anything else): P1 on a CUDA tensor,
    its plain version on a CPU one."""
    if idx.numel() > MAX_FETCHES:
        raise ValueError(f"{idx.numel()} fetches exceed int32 indexing")
    return exp_gather.gather(table, idx)


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
    fused = torch.cat([tx.atlas_packed, tx.env_packed])
    set_counter("texfetch.table_bytes", fused.numel() * fused.element_size())
    out = dict(fused_packed=fused)
    if full(tx.atlas_pair, na):
        env = tx.env_pair if full(tx.env_pair, ne) else tx.env_packed
        out["fused_pair"] = torch.cat([tx.atlas_pair, env])
    return dataclasses.replace(tx, **out)
