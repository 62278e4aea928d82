"""Build and load the port's CUDA kernels.

The kernels are CUDA C++ for Hopper (``sm_90a``) with a plain C interface.
``nvcc`` compiles each source into a shared library at first use, under
``kernels/build/`` (listed in ``.gitignore``), and ``ctypes`` loads it.  The
library's file name carries a hash of the source and the flags, so an edited
source is rebuilt and a current one is reused.  Nothing is built when this
module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_library", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels are "
        "compiled at first use on a machine with the CUDA toolkit"
    )


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_library(name: str, force: bool = False) -> dict:
    """Compile ``csrc/<name>.cu`` unless a current build exists (or
    ``force``).  Returns ``{"path", "seconds", "command", "built"}``; raises
    ``RuntimeError`` with nvcc's output if the compile fails."""
    out = _library_path(name)
    if out.exists() and not force:
        return {"path": str(out), "seconds": 0.0, "command": None, "built": False}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return {"path": str(out), "seconds": seconds, "command": " ".join(cmd), "built": True}


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s shared library, once
    per process."""
    return ctypes.CDLL(build_library(name)["path"])
