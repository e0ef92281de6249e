"""Build, load and call the host C library (csrc/merlin.cpp).

Counterpart: the sr25519 challenge helper of the JAX package's native
extension (native/tm_native.cpp sr25519_challenges), as the port's own C
copy. The library is compiled at first use with the host C++ compiler
(CXX, else `c++` or `g++` on PATH: the one nvcc itself calls) into
build/host/ at the repository root, named by a digest of the source and
flags, and loaded with ctypes. A missing compiler is an error: the
pure-Python transcript (crypto/_merlin.py) is some two thousand times
slower and is not a fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .kernels import CSRC

BUILD_DIR = CSRC.parent.parent / "build" / "host"
SOURCE = "merlin.cpp"
CXX_FLAGS = ("-std=c++17", "-O3", "-funroll-loops", "-fPIC", "-shared")


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler found: set CXX or put c++ on PATH")
    return cxx


def build() -> Path:
    """Compile the library unless a build of this source exists."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((CSRC / SOURCE).read_bytes())
    lib = BUILD_DIR / f"libtm_host-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp.so"
    out = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(CSRC / SOURCE)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"c++ failed on {SOURCE} ({out.returncode}):\n"
                           f"{out.stdout}\n{out.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded host library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tm_sr25519_challenges.argtypes = [p, i64, p, p, p, p, i64, p]
    lib.tm_sr25519_challenges.restype = ctypes.c_int
    return lib


def _rows(name: str, a: np.ndarray, n: int) -> np.ndarray:
    if a.dtype != np.uint8 or a.shape != (n, 32):
        raise ValueError(f"{name} must be ({n}, 32) uint8, got {a.shape} {a.dtype}")
    return np.ascontiguousarray(a)


def sr25519_challenges(ctx: bytes, pubs: np.ndarray, rs: np.ndarray, msgs,
                       offsets: np.ndarray) -> np.ndarray:
    """(n, 64) uint8 schnorrkel "sign:c" challenges: signature i under
    signing context `ctx`, key pubs[i], R rs[i] and message
    msgs[offsets[i]:offsets[i+1]] (an EntryBlock's columns)."""
    n = offsets.shape[0] - 1
    pubs, rs = _rows("pubs", pubs, n), _rows("rs", rs, n)
    buf = np.frombuffer(msgs, dtype=np.uint8)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    if n < 0 or (n and (int(offs[0]) < 0 or int(offs[-1]) > buf.size
                        or bool((np.diff(offs) < 0).any()))):
        raise ValueError("offsets must be (n+1,), non-decreasing, inside the message buffer")
    out = np.empty((n, 64), dtype=np.uint8)
    if n:
        ctx_a = np.frombuffer(ctx, dtype=np.uint8)
        library().tm_sr25519_challenges(ctx_a.ctypes.data, len(ctx), pubs.ctypes.data,
                                        rs.ctypes.data, buf.ctypes.data, offs.ctypes.data,
                                        n, out.ctypes.data)
    return out
