"""Planar (component structure-of-arrays) 3-vector math over tensors.

Counterpart of project3_cuda_path_tracer_tpu/ops/vec.py: a `V3` is three
same-shaped [N] tensors. The planar layout is kept so that every function of
the port's wavefront code reads like the JAX function it is held against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def splat(v, like: torch.Tensor) -> V3:
    """Broadcast a length-3 tensor (or sequence) to a V3 shaped like `like`."""
    return V3(*(torch.as_tensor(v[i], dtype=like.dtype,
                                device=like.device).expand_as(like)
                for i in range(3)))


def from_rows(a: torch.Tensor) -> V3:
    """[N,3] (or [3]) tensor -> V3 of [N] (or 0-dim) components."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def dot(a: V3, b: V3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def norm(a: V3) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: V3) -> V3:
    """Unit vector; zero/near-zero lanes pass through unscaled.

    Double-where floor at 1e-12 instead of max(dot, 1e-30): torch.where, like
    jnp.where, differentiates both branches, and rsqrt's derivative at a tiny
    floor is inf in f32, so a 0 cotangent on a dead (zero-vector) lane would
    turn into NaN. Hit lanes are unchanged bit for bit."""
    d2 = dot(a, a)
    return a * torch.rsqrt(torch.where(d2 > 1e-12, d2, torch.ones_like(d2)))


def where(c: torch.Tensor, a: V3, b: V3) -> V3:
    return V3(torch.where(c, a.x, b.x), torch.where(c, a.y, b.y),
              torch.where(c, a.z, b.z))


def xform_pt(mat: torch.Tensor, p: V3) -> V3:
    """Affine transform by one [4,4] matrix (its entries are 0-dim tensors)."""
    return V3(
        mat[0, 0] * p.x + mat[0, 1] * p.y + mat[0, 2] * p.z + mat[0, 3],
        mat[1, 0] * p.x + mat[1, 1] * p.y + mat[1, 2] * p.z + mat[1, 3],
        mat[2, 0] * p.x + mat[2, 1] * p.y + mat[2, 2] * p.z + mat[2, 3],
    )


def xform_dir(mat: torch.Tensor, v: V3) -> V3:
    return V3(
        mat[0, 0] * v.x + mat[0, 1] * v.y + mat[0, 2] * v.z,
        mat[1, 0] * v.x + mat[1, 1] * v.y + mat[1, 2] * v.z,
        mat[2, 0] * v.x + mat[2, 1] * v.y + mat[2, 2] * v.z,
    )
