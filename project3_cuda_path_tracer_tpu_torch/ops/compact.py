"""Stream compaction and material-key sorting of the wavefront.

Counterpart of project3_cuda_path_tracer_tpu/ops/compact.py, function for
function: the wavefront keeps its size, and a permutation moves the live
paths to the front (compaction) grouped by the material they hit (sorting;
reference: src/pathtrace.cu:313-317, :366-367). Every permutation here is
the JAX one exactly: a stable partition, and the stable counting sort over
`num_materials + 2` buckets, written as a stable `torch.sort` of the bucket
ids (the same permutation; tests/test_torch_compact.py holds both against
JAX). These are tensor ops: the JAX module has no Pallas kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

DEAD_KEY = 0x7FFFFFFF
MISS_KEY = 0x3FFFFFFF


def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis, in x's dtype."""
    return torch.cumsum(x, dim=-1, dtype=x.dtype) - x


def compaction_permutation(alive: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-partition permutation: the live lanes in order, then the dead
    ones in order. Returns (perm [N] int64, num_live 0-dim int64)."""
    perm = torch.sort((~alive).to(torch.uint8), stable=True).indices
    return perm, alive.sum()


def material_sort_key(alive: torch.Tensor, hit_t: torch.Tensor,
                      mat_id: torch.Tensor) -> torch.Tensor:
    """Composite key: live hits by material, then live misses, then dead
    lanes, so that one sort both compacts and groups."""
    m = torch.where(hit_t > 0, mat_id, torch.full_like(mat_id, MISS_KEY))
    return torch.where(alive, m, torch.full_like(m, DEAD_KEY))


def sort_permutation(keys: torch.Tensor) -> torch.Tensor:
    """Stable ascending-sort permutation of `keys` (int64)."""
    return torch.sort(keys, stable=True).indices


def apply_permutation(tree, perm: torch.Tensor):
    """Gather every [N] tensor of a (nested) NamedTuple or tuple by `perm`;
    None leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[perm]
    leaves = (apply_permutation(leaf, perm) for leaf in tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*leaves)
    return type(tree)(leaves)


def bucket_sort_permutation(bucket_ids: torch.Tensor,
                            num_buckets: int) -> torch.Tensor:
    """The JAX counting sort's permutation for ids in [0, num_buckets):
    bucket by bucket, each in lane order. That is the stable sort of the
    ids, which on the card is one radix sort instead of num_buckets
    scans."""
    del num_buckets  # the stable sort needs no bucket count
    return sort_permutation(bucket_ids)


def material_bucket_ids(alive: torch.Tensor, hit_t: torch.Tensor,
                        mat_id: torch.Tensor, num_materials: int):
    """(bucket_ids, num_buckets): live hits by material, then live misses
    (bucket num_materials), then dead lanes (num_materials + 1)."""
    m = torch.where(hit_t > 0, mat_id,
                    torch.full_like(mat_id, num_materials))
    ids = torch.where(alive, m, torch.full_like(m, num_materials + 1))
    return ids, num_materials + 2
