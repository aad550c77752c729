"""Hash-based Owen-scrambled Sobol (0,2) pairs for the stratified sampler
(`--sampler sobol`), after Burley, "Practical Hash-based Owen Scrambling"
(JCGT 2020).

Counterpart of project3_cuda_path_tracer_tpu/ops/qmc.py, bit for bit. The
uint32 arithmetic runs in int64 planes holding values in [0, 2^32), each
result wrapped by `& 0xFFFFFFFF` (torch's uint32 lacks shifts and masks).
A product of two 32-bit values would overflow int64's sign, so `_mul32`
forms the low 32 bits of the product from the multiplier's 16-bit halves:
every partial product stays below 2^48, on the CPU and on the card alike.
"""
from __future__ import annotations

from typing import Tuple

import torch

INDEX_BITS = 32
_U32 = 0xFFFFFFFF

# second-dimension generator columns (the Pascal matrix mod 2)
_SOBOL2 = []
_c = 0x80000000
for _ in range(INDEX_BITS):
    _SOBOL2.append(_c)
    _c = (_c ^ (_c >> 1)) & _U32


def _u32(x) -> torch.Tensor:
    """An int64 plane of uint32 values (int32 bit patterns wrap to their
    unsigned value)."""
    return torch.as_tensor(x).to(torch.int64) & _U32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c < 2^32."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def hash32(x: torch.Tensor, salt: int) -> torch.Tensor:
    """Full-avalanche 32-bit finalizer hash of a [N] plane."""
    x = _u32(x) ^ (salt & _U32)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    x = _u32(x)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & _U32


def laine_karras(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Laine-Karras-style hash: each output bit depends only on lower input
    bits and the seed (a valid Owen scramble in the reversed-bit domain)."""
    x = (_u32(x) + _u32(seed)) & _U32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return x


def owen_scramble(bits: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Owen-scramble a radical-inverse value given MSB first."""
    return reverse_bits32(laine_karras(reverse_bits32(bits), seed))


def sobol2d_bits(index: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (x, y) Sobol pair of [N] uint32 indices as uint32 fixed-point
    bit patterns (MSB-first radical-inverse domain)."""
    idx = _u32(index)
    x = reverse_bits32(idx)  # dim 0: van der Corput
    y = torch.zeros_like(idx)
    for k in range(INDEX_BITS):
        take = -((idx >> k) & 1)  # 0 or all ones (masked below)
        y = y ^ (take & _SOBOL2[k])
    return x, y


_INV32 = float(2.0 ** -32)


def owen_sobol_pair(index: torch.Tensor, seed_shuffle: torch.Tensor,
                    seed_x: torch.Tensor, seed_y: torch.Tensor):
    """One padded Owen-Sobol 2-D sample a lane: the lane-shuffled index's
    Sobol point, Owen-scrambled per dimension, as two float32 planes in
    [0, 1] (a value within half an ulp of 2^32 rounds up to 1.0, as in
    the JAX package)."""
    idx = reverse_bits32(laine_karras(reverse_bits32(_u32(index)),
                                      seed_shuffle))
    bx, by = sobol2d_bits(idx)
    bx = owen_scramble(bx, seed_x)
    by = owen_scramble(by, seed_y)
    return (bx.to(torch.float32) * _INV32, by.to(torch.float32) * _INV32)


def sample_planes(iteration, depth: int, pixel_index: torch.Tensor,
                  num_dims: int, salt: int) -> Tuple[torch.Tensor, ...]:
    """`num_dims` stratified uniform planes for (iteration, depth, pixel):
    padded Owen-Sobol pairs, each index-shuffled and scrambled by seeds
    hashed from (pixel, depth, pair). The "sobol" implementation of
    ops/wavefront.stratified_planes. `iteration` is an int or a 0-dim
    integer tensor on the pixels' device, which is used where it lies (a
    captured iteration graph reads it at each replay)."""
    mix = _u32(pixel_index) ^ ((int(depth) * 0x9E3779B9) & _U32)
    it = _u32(torch.as_tensor(iteration, device=pixel_index.device)
              ).expand(pixel_index.shape)
    out = []
    for p in range((num_dims + 1) // 2):
        s = salt + 0x1000 * p
        out.extend(owen_sobol_pair(it, hash32(mix, s), hash32(mix, s + 1),
                                   hash32(mix, s + 2)))
    return tuple(out[:num_dims])
