"""Build the package's CUDA sources with nvcc at first use; load with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers), so a
build is one nvcc run of a few seconds. The shared library lands in the
package's git-ignored `_build/` directory under a name keyed by a hash of the
source and the flags: an edited source builds anew, an unchanged one loads
the library already there.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


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
    """Where `csrc/<name>.cu` builds to (keyed by its source and flags)."""
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
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
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load `csrc/<name>.cu` (once per process)."""
    return ctypes.CDLL(build(name))
