"""Adam as `optax.adam(learning_rate)` computes it, over a list of tensors.

The JAX train step (project3_cuda_path_tracer_tpu/models/inverse.py) takes
`optax.adam(1e-2)`: b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0, one step
count shared by the whole parameter tree, and every leaf updated each step,
a leaf without a gradient taking optax's zero cotangent. `torch.optim.Adam`
parts from it: it counts steps per parameter and skips a parameter whose
`.grad` is None, so the two diverge as soon as a leaf (the camera's
`shutter` or `aperture`, say) has no gradient in some step. Hence these
plain functions, in optax's order of operations: `update_` writes the
state in place (the form a captured train step replays), `update` runs it
on a copy.
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
def update_(params: Sequence[torch.Tensor],
            grads: Sequence[Optional[torch.Tensor]], state: AdamState,
            learning_rate: float, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8, eps_root: float = 0.0) -> None:
    """One Adam step written in place: `params`, the step count and both
    moments of `state`. A None in `grads` is a zero gradient. It makes no
    host round trip (the bias corrections' bases are filled on the count's
    device), so a captured CUDA graph of a train step can hold it."""
    if not len(params) == len(grads) == len(state.mu) == len(state.nu):
        raise ValueError("params, grads and the state's moments differ in "
                         "length")
    state.count.add_(1)
    c = state.count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(c, b1), c)
    bc2 = 1.0 - torch.pow(torch.full_like(c, b2), c)
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        if g is None:
            g = torch.zeros_like(p)
        m.copy_((1 - b1) * g + b1 * m)
        v.copy_((1 - b2) * (g * g) + b2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2 + eps_root) + eps)
        p.add_(-learning_rate * u)


def copy_state(state: AdamState) -> AdamState:
    """A copy of `state` that shares no tensor with it."""
    return AdamState(count=state.count.clone(),
                     mu=[m.clone() for m in state.mu],
                     nu=[v.clone() for v in state.nu])


def update(params: Sequence[torch.Tensor],
           grads: Sequence[Optional[torch.Tensor]], state: AdamState,
           learning_rate: float, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8, eps_root: float = 0.0) -> AdamState:
    """One Adam step: `params` are updated in place and the new state is
    returned (`update_` on a copy of `state`, which stays as it was)."""
    new = copy_state(state)
    update_(params, grads, new, learning_rate, b1, b2, eps, eps_root)
    return new
