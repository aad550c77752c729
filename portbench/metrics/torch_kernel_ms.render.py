"""torch_kernel_ms.render: device milliseconds an iteration of every kernel
that is not a hand-written one (the torch-op stages), from the profiler."""
from harness import profiling


def read(rec):
    return profiling.torch_kernel_ms(rec, "iterations")
