"""Build and load the CUDA kernels of the port at first use.

``nvcc`` compiles every ``src/repro_torch/csrc/*.cu`` for ``sm_90a`` —
one ``nvcc`` per source, all started together — and links the objects
into one shared library with a plain C interface, which is loaded with
``ctypes``. The library lands in ``build/repro_torch/`` at the root of
the checkout (``.gitignore`` lists ``build/``), named by a hash of all
sources and the flags, so an edited source never reuses a stale build.
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

__all__ = ["BUILD_DIR", "SOURCES", "build", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMPILE_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
_LINK_FLAGS = [*_ARCH, "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# The C entry points, each returning cudaGetLastError() as an int.
_ENTRY_POINTS = {
    # crossbar_step.cu: (st_in, st_out, n_words or n_rows, n_cols, cmd,
    # n_cmd, n_steps, max_step, held, max_ops, words per block, stream)
    "k1_packed": [_P, _P, _I, _I, _P] + [_I] * 6 + [_P],
    "k2_unpacked": [_P, _P, _I, _I, _P] + [_I] * 6 + [_P],
    # bitserial_matmul.cu: (x, w, out, M, K, N, n_bits, stream)
    "k3_bitserial_matmul": [_P, _P, _P, _I, _I, _I, _I, _P],
}


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
    h = hashlib.sha256(" ".join(_COMPILE_FLAGS + _LINK_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"librepro_torch-{h.hexdigest()[:16]}.so"


def _check(proc: subprocess.CompletedProcess, what: str) -> None:
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")


def build(verbose: bool = False) -> "tuple[Path, float]":
    """Compile the kernels if these sources have no library yet; returns
    ``(library path, seconds spent compiling and linking)`` (0.0 when it
    existed). ``verbose`` adds ``-Xptxas -v`` and prints the compiler's
    report of registers, shared memory and spills."""
    lib = _library_path()
    if lib.exists() and not verbose:
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    jobs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{src.stem}-{tag}.o"
        cmd = [nvcc, *_COMPILE_FLAGS, *extra, "-c", "-o", str(obj),
               str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    # Wait for every compile before checking any, so a failure leaves
    # no nvcc running.
    done = []
    for src, _, proc in jobs:
        out, err = proc.communicate()
        done.append((src, subprocess.CompletedProcess(
            proc.args, proc.returncode, out, err)))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        for src, proc in done:
            _check(proc, src.name)
        link = subprocess.run([nvcc, *_LINK_FLAGS, "-o", str(tmp),
                               *[str(obj) for _, obj, _ in jobs]],
                              capture_output=True, text=True)
        _check(link, "the link")
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    reports = [proc.stdout + proc.stderr for _, proc in done]
    if verbose:
        print("".join(reports))
    os.replace(tmp, lib)
    return lib, seconds


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with
    ``argtypes``/``restype`` declared for every entry point."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
