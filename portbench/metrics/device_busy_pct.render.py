"""device_busy_pct.render: the share of the traced sub-window in which some
operation ran on the device (the union of the profiler's kernel, copy and
fill intervals), in percent."""
from harness import profiling


def read(rec):
    return profiling.busy_pct(rec)
