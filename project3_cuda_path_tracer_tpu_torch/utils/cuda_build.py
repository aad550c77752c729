"""Build the package's CUDA sources with nvcc at first use; load with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers), so a
build is one nvcc run of a few seconds. The shared library lands in the
package's git-ignored `_build/` directory under a name keyed by a hash of the
source, the shared `csrc/*.cuh` headers and the flags: an edited source
builds anew, an unchanged one loads the library already there. nvcc's
report (ptxas's registers and spills per kernel) lands beside it, in
`<library>.log`.
`build_all` starts one nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from PATH, else from the toolkit at $CUDA_HOME (default
    /usr/local/cuda, the toolkit's standard install location)."""
    nvcc = shutil.which("nvcc")
    home_nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "nvcc")
    if nvcc is None and os.path.exists(home_nvcc):
        nvcc = home_nvcc
    if nvcc is None:
        raise RuntimeError(f"nvcc not found on PATH or at {home_nvcc}: "
                           "the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> str:
    """Where `csrc/<name>.cu` builds to (keyed by its source, the headers
    and the flags)."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            key.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless its keyed library exists; return the
    library's path. Raises with nvcc's output when the build fails."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}.cu:\n{proc.stdout}{proc.stderr}")
        with open(out + ".log", "w") as f:  # ptxas: registers, spills
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """`build` every name, one nvcc process each, all started together."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load `csrc/<name>.cu` (once per process)."""
    return ctypes.CDLL(build(name))
