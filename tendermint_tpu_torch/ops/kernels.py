"""Build, load and launch the CUDA kernel library (csrc/).

The kernels are compiled at first use with nvcc into a shared library
with a plain C interface, loaded with ctypes. Each source compiles to
an object in its own nvcc process, all started together, and one more
nvcc links the objects. The library lands in build/kernels/ at the
repository root, named by a digest of the sources and flags, so a
changed source builds anew and an unchanged one loads the existing
file. nvcc's `-Xptxas -v` report (registers, spills) is kept beside it.

Every kernel wrapper launches through `launch`, which counts the
launches per kernel in LAUNCHES (plain-version calls on CPU tensors are
not launches). A pointer argument given as None is a null pointer (the
secp256k1 kernels' optional coordinate output).
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("rlc.cu", "verify.cu", "sr25519.cu", "secp256k1.cu", "bls12381.cu", "sha512.cu",
           "ed25519_verify.cu")
HEADERS = ("fe25519.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C entry (without its "tm_" prefix): (pointer arguments, int arguments);
# every entry takes a stream last.
_ENTRIES = {
    "k1_rlc": (6, 1),
    "k2_rlc": (2, 1),
    "k3_rlc": (6, 1),
    "k1_rlc_cached": (8, 2),
    "epoch_coords": (3, 1),
    "k1_decompress": (8, 1),
    "k1_decompress_cached": (10, 2),
    "k2_table": (2, 1),
    "k3_ladder": (7, 1),
    "k1r_decode": (10, 1),
    "k3r_ladder": (7, 1),
    "secp_verify": (9, 1),
    "secp_verify_cached": (11, 2),
    "bls_miller": (6, 2),
    "bls_finalexp": (2, 2),
    "sha512_challenge": (4, 2),
    "og_verify": (6, 1),
    "og_verify_cached": (8, 2),
}

LAUNCHES = {name: 0 for name in _ENTRIES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass
class Build:
    path: Path
    seconds: float  # 0.0 when an existing library was loaded
    ptxas: str  # nvcc's -Xptxas -v report, all sources


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _run(procs: dict) -> dict:
    """Wait for every nvcc process; raise with the first failure's output
    after all have ended, so none is left running."""
    outs = {name: p.communicate() for name, p in procs.items()}
    for name, p in procs.items():
        if p.returncode != 0:
            out, err = outs[name]
            raise RuntimeError(f"nvcc failed on {name} ({p.returncode}):\n{out}\n{err}")
    return outs


def build() -> Build:
    """Compile the library unless a build of these sources exists."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    stem = f"libtm_kernels-{h.hexdigest()[:16]}"
    lib = BUILD_DIR / f"{stem}.so"
    log = BUILD_DIR / f"{stem}.ptxas.txt"
    if lib.exists() and log.exists():
        return Build(lib, 0.0, log.read_text())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{stem}.{os.getpid()}"
    objs = {s: BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES}
    t0 = time.perf_counter()
    procs = {
        s: subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs[s]), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for s in SOURCES
    }
    outs = _run(procs)
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    _run({"link": subprocess.Popen(
        [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *(str(objs[s]) for s in SOURCES)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )})
    seconds = time.perf_counter() - t0
    for o in objs.values():
        o.unlink()
    log.write_text("".join(f"== {s}\n{outs[s][0]}{outs[s][1]}" for s in SOURCES))
    os.replace(tmp, lib)
    return Build(lib, seconds, log.read_text())


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build().path))
    for name, (n_ptr, n_int) in _ENTRIES.items():
        fn = getattr(lib, "tm_" + name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.tm_error_string.argtypes = [ctypes.c_int]
    lib.tm_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return library().tm_error_string(err).decode()


def device_of(t: torch.Tensor) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device


def check_tensor(name: str, t: torch.Tensor, shape: tuple, dtype,
                 device: torch.device) -> None:
    """A wrapper's argument check: shape, dtype, device, contiguity."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} must be {tuple(shape)} {dtype}, got {tuple(t.shape)} {t.dtype}"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(name: str, *args) -> None:
    """Call the C entry tm_<name> on the current stream of its tensors'
    device: tensors first (None for a null pointer), then ints, as
    _ENTRIES lists them. The entry returns cudaGetLastError() of its
    launch; a launch counts in LAUNCHES only when that is 0."""
    lib = library()
    n_ptr, n_int = _ENTRIES[name]
    ptrs, ints = args[:n_ptr], args[n_ptr:]
    if (len(ints) != n_int or not isinstance(ptrs[0], torch.Tensor)
            or not all(t is None or isinstance(t, torch.Tensor) for t in ptrs)):
        raise TypeError(f"{name} takes {n_ptr} tensors and {n_int} ints")
    dev = ptrs[0].device
    cargs = [ctypes.c_void_p(None if t is None else t.data_ptr()) for t in ptrs]
    cargs += [ctypes.c_int(int(i)) for i in ints]
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, "tm_" + name)(*cargs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {error_string(err)} ({err})")
    LAUNCHES[name] += 1
