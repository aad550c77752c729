"""Adam as `optax.adam(learning_rate)` computes it, over a list of tensors.

The JAX train step (project3_cuda_path_tracer_tpu/models/inverse.py) takes
`optax.adam(1e-2)`: b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0, one step
count shared by the whole parameter tree, and every leaf updated each step,
a leaf without a gradient taking optax's zero cotangent. `torch.optim.Adam`
parts from it: it counts steps per parameter and skips a parameter whose
`.grad` is None, so the two diverge as soon as a leaf (the camera's
`shutter` or `aperture`, say) has no gradient in some step. Hence these
two plain functions, in optax's order of operations.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch


class AdamState(NamedTuple):
    """optax's ScaleByAdamState: the step count and both moments."""
    count: torch.Tensor        # [] int32
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def init(params: Sequence[torch.Tensor]) -> AdamState:
    """Zero moments shaped like `params`, count 0 (on their device)."""
    dev = params[0].device if params else torch.device("cpu")
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu=[torch.zeros_like(p, memory_format=torch.contiguous_format)
            for p in params],
        nu=[torch.zeros_like(p, memory_format=torch.contiguous_format)
            for p in params])


@torch.no_grad()
def update(params: Sequence[torch.Tensor],
           grads: Sequence[Optional[torch.Tensor]], state: AdamState,
           learning_rate: float, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8, eps_root: float = 0.0) -> AdamState:
    """One Adam step: `params` are updated in place and the new state is
    returned. A None in `grads` is a zero gradient."""
    if not len(params) == len(grads) == len(state.mu) == len(state.nu):
        raise ValueError("params, grads and the state's moments differ in "
                         "length")
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=c.device), c)
    mu, nu = [], []
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        if g is None:
            g = torch.zeros_like(p)
        m = (1 - b1) * g + b1 * m
        v = (1 - b2) * (g * g) + b2 * v
        u = (m / bc1) / (torch.sqrt(v / bc2 + eps_root) + eps)
        p.add_(-learning_rate * u)
        mu.append(m)
        nu.append(v)
    return AdamState(count=count, mu=mu, nu=nu)
