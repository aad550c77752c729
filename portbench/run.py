"""The port's benchmark: one run of one cell.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It loads the cell's scene, warms up, drives
the cell's traffic for `--seconds`, checks what the window produced against
the plain reference in portbench/reference, and prints one JSON line last.
With --trace 1 it also profiles a short sub-window and reports the cell's
per-layer metrics instead of its end-to-end ones. It needs an NVIDIA GPU:
without one it exits 2 and prints no result."""
import time

PROCESS_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache the program or torch may write, at fixed paths in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(HERE, ".cache", sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [HERE, ROOT]

if __name__ == "__main__":
    from harness import runner
    sys.exit(runner.main(sys.argv[1:], PROCESS_START))
