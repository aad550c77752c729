"""The host round-trip audit of the port's graph bodies (not a test file).

A CUDA graph captures device work only: an op that reads a device value on
the host, gathers by a boolean mask or copies host data to the card
synchronises with the host, and under a capture it fails. On the CPU no op
syncs, so the audit watches for those ops by name while a body runs:
`HostRoundTrips` is a TorchDispatchMode that records them, and
`host_round_trips` also skips the plain versions of the hand kernels (the
card runs the kernels there, launched without a host query) and records
every `torch.tensor`/`torch.as_tensor` of host data made for a device.
tests/test_torch_chunk.py audits the render iteration with it,
tests/test_torch_train_graph.py the train step (forward, backward, Adam,
the history update).
"""
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
from project3_cuda_path_tracer_tpu_torch.ops import matgrad as MG
from project3_cuda_path_tracer_tpu_torch.ops import pallas_bvh as PPB
from project3_cuda_path_tracer_tpu_torch.ops import texfetch as P1

# the plain versions that the card's kernels replace
PLAIN_KERNELS = ((P8, "traverse8_plain"), (PPB, "traverse_binary_plain"),
                 (P1, "gather_plain"), (MG, "mat_grad_plain"))


class HostRoundTrips(TorchDispatchMode):
    """Records the ops that read a device value on the host, index by a
    boolean mask or lift a tensor of host data with more than one element
    (a sync on the card, an error under a capture; a 0-dim tensor of host
    data stays a scalar argument on the CPU); the plain versions of the
    kernels, which the card replaces, are skipped (`paused`). It sees the
    backward too: autograd runs it under the caller's dispatch modes."""

    SYNCS = {torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.nonzero.default,
             torch.ops.aten.masked_select.default,
             torch.ops.aten.equal.default,
             torch.ops.aten.is_nonzero.default}

    def __init__(self):
        super().__init__()
        self.hits = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            name = str(func)
            if (func in self.SYNCS or "unique" in name
                    or "repeat_interleave" in name):
                self.hits.append(name)
            if func in (torch.ops.aten.index.Tensor,
                        torch.ops.aten.index_put_.default,
                        torch.ops.aten._index_put_impl_.default):
                if any(t is not None and t.dtype == torch.bool
                       for t in args[1]):
                    self.hits.append(name + " by a mask")
            if func is torch.ops.aten.lift_fresh.default and \
                    args[0].dim() > 0:
                self.hits.append(name + " of host data")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def host_round_trips(monkeypatch):
    """Yields a HostRoundTrips audit, not yet entered, with every plain
    kernel version patched to run unaudited, and `torch.tensor` /
    `torch.as_tensor` patched to record (in `audit.copies`) each tensor of
    host data made for a named device. Enter the audit around the body."""
    audit = HostRoundTrips()
    audit.copies = []
    for mod, name in PLAIN_KERNELS:
        plain = getattr(mod, name)

        def paused(*args, _plain=plain, **kwargs):
            audit.paused += 1
            try:
                return _plain(*args, **kwargs)
            finally:
                audit.paused -= 1
        monkeypatch.setattr(mod, name, paused)
    for name in ("tensor", "as_tensor"):
        make = getattr(torch, name)

        def spy(data, *args, _make=make, **kwargs):
            if (kwargs.get("device") is not None
                    and not isinstance(data, torch.Tensor)):
                audit.copies.append(repr(data)[:40])
            return _make(data, *args, **kwargs)
        monkeypatch.setattr(torch, name, spy)
    yield audit
