"""What the benchmark's process may not hold: JAX, or the JAX package that
the program was ported from. Modules are compared by their whole top-level
name (the part before the first dot), since the program's own name begins
with the JAX package's."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "project3_cuda_path_tracer_tpu")


def forbidden(names: Iterable[str]) -> List[str]:
    """The module names whose top-level name is forbidden, sorted."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def loaded() -> List[str]:
    return forbidden(list(sys.modules))
