"""Build and load the port's CUDA kernels.

Every kernel source ``csrc/<name>.cu`` exports a plain C interface. At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``<repo>/build/kernels/`` and loaded with ``ctypes``
(seconds to build, where a source that includes PyTorch's headers takes
minutes). The library's file name carries a hash of the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source or
header is rebuilt and a stale library is never loaded. The compiler's output (``-Xptxas -v``: registers, shared
memory, spills per kernel) is kept beside the library as ``<name>.log``;
``sass`` disassembles a built library (``cuobjdump -sass``). Nothing here
runs at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "load_library", "build_log", "library_path", "sass"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", name)


def _digest(src: Path) -> str:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    return hashlib.sha1(" ".join(NVCC_FLAGS).encode() + src.read_bytes()
                        + headers).hexdigest()[:16]


def build_log(name: str) -> Path:
    return BUILD_DIR / f"{name}.log"


def library_path(name: str) -> Path:
    """The library ``csrc/<name>.cu`` builds into (built or not)."""
    src = CSRC / f"{name}.cu"
    return BUILD_DIR / f"lib{name}-{_digest(src)}.so"


def sass(name: str) -> str:
    """The SASS of ``csrc/<name>.cu``'s library, built first if missing."""
    load_library(name)
    return subprocess.run([_tool("cuobjdump"), "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it."""
    src = CSRC / f"{name}.cu"
    lib_path = library_path(name)
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a per-process name and rename: concurrent builders
        # never load a half-written library
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=600)
        build_log(name).write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
