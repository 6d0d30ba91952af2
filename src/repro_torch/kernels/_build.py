"""Build and load the CUDA kernels of the port at first use.

``nvcc`` compiles ``src/repro_torch/csrc/crossbar_step.cu`` for
``sm_90a`` into a shared library with a plain C interface, which is
loaded with ``ctypes``. The library lands in ``build/repro_torch/`` at
the root of the checkout (``.gitignore`` lists ``build/``), named by a
hash of its source, so an edited source never reuses a stale build.
Nothing here runs at import time.
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

__all__ = ["BUILD_DIR", "SOURCE", "build", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "crossbar_step.cu"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

# Every C entry point takes (st_in, st_out, n_items, n_cols, gate, in0,
# in1, in2, outc, init_ptr, init_cols, n_slots, m_ops, block, stream)
# and returns cudaGetLastError() as an int.
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 7
             + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_ENTRY_POINTS = ("k1_packed", "k2_unpacked")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under CUDA_HOME)")


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libcrossbar_step-{digest[:16]}.so"


def build(verbose: bool = False) -> "tuple[Path, float]":
    """Compile the kernels if this source has no library yet; returns
    ``(library path, seconds spent compiling)`` (0.0 when it existed).
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report of
    registers, shared memory and spills."""
    lib = _library_path()
    if lib.exists() and not verbose:
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, seconds


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with
    ``argtypes``/``restype`` declared for every entry point."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name in _ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib
