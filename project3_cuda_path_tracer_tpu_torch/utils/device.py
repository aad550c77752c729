"""Device resolution: the caller names the device, nothing is picked for it."""
from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: str) -> torch.device:
    """`"cuda"` or `"cpu"` -> torch.device. Raises when CUDA is asked for and
    absent: a render that asked for the card never quietly runs elsewhere."""
    if name not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    return torch.device(name)


def synchronize(device: torch.device) -> None:
    """Wait for queued work on `device` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
