"""Device resolution (the caller names the device, nothing is picked for
it), and timing on the card."""
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


_COUNTERS = {}  # (device index, stream) -> a persistent kernel's counter


def stream_counter(device: torch.device, stream: int) -> torch.Tensor:
    """4 bytes of scratch for a persistent kernel's work counter, one per
    device and stream (K1 and K2 share it: their C entry points zero it on
    the stream before each launch, and a stream runs one launch at a
    time)."""
    key = (device.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.empty((1,), dtype=torch.int32, device=device)
    return _COUNTERS[key]


def synchronize(device: torch.device) -> None:
    """Wait for queued work on `device` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ~5 ms of a 2 GHz clock: longer than the host takes to enqueue 20 calls
# of a ctypes-bound wrapper
HOLD_CYCLES = 10_000_000


def time_ms(fn, iters: int, warm: int = 1) -> float:
    """Mean device ms per call of `fn` over `iters` calls after `warm`
    untimed ones, by CUDA events on the current stream (needs a card).

    The stream is held busy (`torch.cuda._sleep`) while the host enqueues
    the timed calls, so a call whose kernel is shorter than its host side
    (a ctypes launch takes tens of us) is timed by its kernels, not by its
    launch. A loop of eager ops that outlasts the hold is still timed at
    the host's pace."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


FLUSH_BYTES = 128 << 20  # more than the 50 MB L2 of an H100


def time_cold_ms(fn, reps: int, flush_bytes: int = FLUSH_BYTES) -> list:
    """Device ms of each of `reps` calls of `fn`, each made after writing a
    `flush_bytes` buffer (so that what the call reads comes from device
    memory, not L2), with CUDA events around the call alone. The stream is
    held while the host enqueues, as in `time_ms`."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for rep in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES // 10)
        flush.fill_(rep)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]
