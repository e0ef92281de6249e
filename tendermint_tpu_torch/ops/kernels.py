"""Build and load the CUDA kernel library (csrc/).

The kernels are compiled at first use with nvcc into a shared library
with a plain C interface, loaded with ctypes. The library lands in
build/kernels/ at the repository root, named by a digest of the sources
and flags, so a changed source builds anew and an unchanged one loads
the existing file. nvcc's `-Xptxas -v` report (registers, spills) is
kept beside it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("rlc.cu",)
HEADERS = ("fe25519.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class Build:
    path: Path
    seconds: float  # 0.0 when an existing library was loaded
    ptxas: str  # nvcc's -Xptxas -v report


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> Build:
    """Compile the library unless a build of these sources exists."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    stem = f"libtm_rlc-{h.hexdigest()[:16]}"
    lib = BUILD_DIR / f"{stem}.so"
    log = BUILD_DIR / f"{stem}.ptxas.txt"
    if lib.exists() and log.exists():
        return Build(lib, 0.0, log.read_text())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return Build(lib, seconds, log.read_text())


_ENTRIES = {
    # name: number of pointer arguments before the lane count
    "tm_k1_rlc": 6,
    "tm_k2_rlc": 2,
    "tm_k3_rlc": 6,
}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build().path))
    for name, n_ptr in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.tm_error_string.argtypes = [ctypes.c_int]
    lib.tm_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return library().tm_error_string(err).decode()
