"""torch_kernel_ms.train: device milliseconds a train step of every kernel
that is not a hand-written one (the torch-op stages, autograd's backward,
Adam), from the profiler."""
from harness import profiling


def read(rec):
    return profiling.torch_kernel_ms(rec, "steps")
