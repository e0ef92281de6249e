"""Build, load and call the host C library (csrc/merlin.cpp and
csrc/host_prep.cpp).

Counterpart: the host helpers of the JAX package's native extension
(native/tm_native.cpp: sr25519_challenges, commit_prep_fused with its
device-hash RAM blocks,
ed25519_challenges_buf, ed25519_rlc_prep, vote_sign_bytes_batch_buf and
the mod-L reduction), as the port's own C copy behind a plain C
interface. The library is compiled at first use with the host C++
compiler (CXX, else `c++` or `g++` on PATH: the one nvcc itself calls)
into build/host/ at the repository root, named by a digest of the sources
and flags, and loaded with ctypes, which releases the interpreter lock
for every call. A missing compiler is an error: the Python versions these
helpers replace (crypto/_merlin.py, backend._challenges,
rlc._rlc_scalars_py, commit_prep._prep_commit_numpy) are the tests'
oracles, not a fallback.

Each wrapper checks its arrays' shapes, dtypes and contiguity and raises
ValueError on bad input (an offset table that does not run from 0,
non-decreasing, inside its buffer); outputs are numpy arrays it
allocates. The C side threads over ranges of signatures (TM_NATIVE_THREADS
caps the threads; threads() says how many a call may use).
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
SOURCES = ("merlin.cpp", "host_prep.cpp")
CXX_FLAGS = ("-std=c++17", "-O3", "-funroll-loops", "-fPIC", "-pthread", "-shared")
# The RAM blocks commit_prep_fused lays out: R || A || M of up to
# RAM_MAX_LEN bytes (host_prep.cpp's RAM_MAX_LEN; ops/commit_prep.py
# exports both names).
RAM_MAX_LEN = 256


def ram_nblock(max_len: int) -> int:
    """SHA-512 blocks a message of up to max_len bytes pads to: the 0x80
    terminator and the 16-byte length field take 17 bytes."""
    return (max_len + 17 + 127) // 128


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler found: set CXX or put c++ on PATH")
    return cxx


def build() -> Path:
    """Compile the library unless a build of these sources exists."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    lib = BUILD_DIR / f"libtm_host-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp.so"
    out = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp),
                          *(str(CSRC / s) for s in SOURCES)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"c++ failed on {', '.join(SOURCES)} ({out.returncode}):\n"
                           f"{out.stdout}\n{out.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded host library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    argtypes = {
        "tm_sr25519_challenges": [p, i64, p, p, p, p, i64, p],
        "tm_host_threads": [],
        "tm_ed25519_challenges_buf": [p, p, p, i64, p, i64, p],
        "tm_ed25519_rlc_prep": [p, p, p, i64, p, i64, p, i64, i64, p, p, p],
        "tm_mod_l_many": [p, i64, p],
        "tm_vote_sign_bytes_batch_buf": [p, i64, p, i64, p, i64, p, i64, p],
        "tm_commit_prep_fused": [p, p, p, p, p, p, i64, p, i64, p, i64, p, i64, i64, i64,
                                 p, p, p, p, p, p, i64, p, i64, p, p, p, p],
    }
    for name, args in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def threads() -> int:
    """The threads one call of the library may use."""
    return library().tm_host_threads()


def _array(name: str, a: np.ndarray, dtype, shape: tuple) -> np.ndarray:
    """a itself, once it is a C-contiguous array of `dtype` and `shape`."""
    if not isinstance(a, np.ndarray) or a.dtype != dtype or a.shape != shape:
        got = (a.shape, a.dtype) if isinstance(a, np.ndarray) else type(a).__name__
        raise ValueError(f"{name} must be {shape} {np.dtype(dtype)}, got {got}")
    if not a.flags.c_contiguous:
        raise ValueError(f"{name} must be C-contiguous")
    return a


def _rows(name: str, a: np.ndarray, n: int, width: int = 32) -> np.ndarray:
    return _array(name, a, np.uint8, (n, width))


def _msgs(msgs, offsets: np.ndarray) -> tuple:
    """(message buffer as uint8, int64 offsets, n) of an EntryBlock's
    message columns."""
    buf = np.frombuffer(msgs, dtype=np.uint8)
    if not isinstance(offsets, np.ndarray) or offsets.ndim != 1 or offsets.size < 1:
        raise ValueError("offsets must be (n+1,)")
    offs = _array("offsets", offsets, np.int64, offsets.shape)
    return buf, offs, offs.shape[0] - 1


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def sr25519_challenges(ctx: bytes, pubs: np.ndarray, rs: np.ndarray, msgs,
                       offsets: np.ndarray) -> np.ndarray:
    """(n, 64) uint8 schnorrkel "sign:c" challenges: signature i under
    signing context `ctx`, key pubs[i], R rs[i] and message
    msgs[offsets[i]:offsets[i+1]] (an EntryBlock's columns)."""
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    buf, offs, n = _msgs(msgs, offs)
    pubs = _rows("pubs", np.ascontiguousarray(pubs), n)
    rs = _rows("rs", np.ascontiguousarray(rs), n)
    if n and (int(offs[0]) < 0 or int(offs[-1]) > buf.size
              or bool((np.diff(offs) < 0).any())):
        raise ValueError("offsets must be (n+1,), non-decreasing, inside the message buffer")
    out = np.empty((n, 64), dtype=np.uint8)
    if n:
        ctx_a = np.frombuffer(ctx, dtype=np.uint8)
        library().tm_sr25519_challenges(_ptr(ctx_a), len(ctx), _ptr(pubs), _ptr(rs), _ptr(buf),
                                        _ptr(offs), n, _ptr(out))
    return out


def ed25519_challenges_buf(rs: np.ndarray, pubs: np.ndarray, msgs,
                           offsets: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 k_i = SHA-512(rs[i] || pubs[i] || message i) mod L,
    little-endian, message i = msgs[offsets[i]:offsets[i+1]] (offsets
    from 0)."""
    buf, offs, n = _msgs(msgs, offsets)
    rs, pubs = _rows("rs", rs, n), _rows("pubs", pubs, n)
    out = np.empty((n, 32), dtype=np.uint8)
    if library().tm_ed25519_challenges_buf(_ptr(rs), _ptr(pubs), _ptr(buf), buf.size,
                                           _ptr(offs), n, _ptr(out)):
        raise ValueError("bad columnar challenge inputs: offsets must run from 0, "
                         "non-decreasing, inside the message buffer")
    return out


def ed25519_rlc_prep(pubs: np.ndarray, sigs: np.ndarray, msgs, offsets: np.ndarray,
                     z: np.ndarray, m: int, total: int) -> tuple:
    """The RLC host prep of n signatures padded to `total` rows in lanes
    of m: (k (n, 32) challenges, S (total/m, 32) lane scalars, U (total,
    32) per-row scalars, s_ok (total,) bool). z is (total, 32) uint8;
    padding rows have U = 0 and s_ok = True (ops/rlc.py)."""
    buf, offs, n = _msgs(msgs, offsets)
    pubs, sigs = _rows("pubs", pubs, n), _rows("sigs", sigs, n, 64)
    if m <= 0 or total < n or total % m:
        raise ValueError(f"total {total} must be a multiple of m={m} and >= {n}")
    z = _rows("z", z, total)
    g = total // m
    k = np.empty((n, 32), dtype=np.uint8)
    su = np.empty((g + total, 32), dtype=np.uint8)
    sok = np.empty((total,), dtype=np.uint8)
    if library().tm_ed25519_rlc_prep(_ptr(pubs), _ptr(sigs), _ptr(buf), buf.size, _ptr(offs),
                                     n, _ptr(z), m, total, _ptr(k), _ptr(su), _ptr(sok)):
        raise ValueError("bad rlc prep inputs: offsets must run from 0, non-decreasing, "
                         "inside the message buffer")
    return k, su[:g], su[g:], sok.view(bool)


def mod_l_many(digests: np.ndarray) -> np.ndarray:
    """(n, 64) uint8 little-endian integers -> (n, 32) uint8, each mod L."""
    if not isinstance(digests, np.ndarray) or digests.ndim != 2:
        raise ValueError("digests must be (n, 64) uint8")
    n = digests.shape[0]
    digests = _rows("digests", digests, n, 64)
    out = np.empty((n, 32), dtype=np.uint8)
    library().tm_mod_l_many(_ptr(digests), n, _ptr(out))
    return out


def sign_bytes_bound(prefix_len: int, suffix_len: int) -> int:
    """The most bytes one vote's sign bytes take with this template: the
    Timestamp field is at most 24 bytes (tag, length, and two tagged
    10-byte varints), the record's length prefix a varint of the body."""
    body = prefix_len + 24 + suffix_len
    return body + (body.bit_length() + 6) // 7


def vote_sign_bytes_batch_buf(prefix: bytes, suffix: bytes, times: np.ndarray) -> tuple:
    """Canonical vote sign bytes of n votes of one template (prefix,
    suffix), times (n, 2) int64 each vote's Timestamp (seconds, nanos):
    (buf, (n+1,) int64 offsets), vote i at buf[offsets[i]:offsets[i+1]]
    (the EntryBlock msgs form). buf is sized by sign_bytes_bound per vote
    and returned as a memoryview of the bytes written."""
    if not isinstance(times, np.ndarray) or times.ndim != 2:
        raise ValueError("times must be (n, 2) int64")
    n = times.shape[0]
    times = _array("times", times, np.int64, (n, 2))
    pre = np.frombuffer(prefix, dtype=np.uint8)
    suf = np.frombuffer(suffix, dtype=np.uint8)
    buf = np.empty(n * sign_bytes_bound(pre.size, suf.size), dtype=np.uint8)
    offs = np.empty(n + 1, dtype=np.int64)
    if library().tm_vote_sign_bytes_batch_buf(_ptr(pre), pre.size, _ptr(suf), suf.size,
                                              _ptr(times), n, _ptr(buf), buf.size, _ptr(offs)):
        raise ValueError("sign bytes overran their bound")
    return memoryview(buf)[: int(offs[-1])], offs


def commit_prep_fused(flags: np.ndarray, sig: np.ndarray, ts_seconds: np.ndarray,
                      ts_nanos: np.ndarray, pub: np.ndarray, power: np.ndarray,
                      prefix_commit: bytes, prefix_nil: bytes, suffix: bytes,
                      threshold: int, mode: int, ram: bool = False) -> tuple:
    """Selection, tally, sign bytes and the pub / sig gather of
    verify_commit over a commit's columns (ops/entry_block.CommitBlock)
    and its set's (pub (n, 32) uint8, power (n,) int64), in one call.
    `mode` takes ops/commit_prep's MODE_* bits. Returns (sel (m,) int64,
    tallied, None) when the tally is not above threshold, else (sel,
    tallied, (pub (m, 32), sig (m, 64), msgs, offsets (m+1,) int64,
    ram)). ram is None unless asked for (`ram`) and every row's
    R || A || M fits in RAM_MAX_LEN bytes; then it is (ram_hi, ram_lo
    (m, ram_nblock(RAM_MAX_LEN) * 16) uint32, counts (m,) int32),
    commit_prep._fill_ram's layout. The
    sign-bytes buffer is sized by sign_bytes_bound per row."""
    if not isinstance(flags, np.ndarray) or flags.ndim != 1:
        raise ValueError("flags must be (n,) uint8")
    n = flags.shape[0]
    flags = _array("flags", flags, np.uint8, (n,))
    sig = _rows("sig", sig, n, 64)
    ts_seconds = _array("ts_seconds", ts_seconds, np.int64, (n,))
    ts_nanos = _array("ts_nanos", ts_nanos, np.int32, (n,))
    pub = _rows("pub", pub, n)
    power = _array("power", power, np.int64, (n,))
    pc = np.frombuffer(prefix_commit, dtype=np.uint8)
    pn = np.frombuffer(prefix_nil, dtype=np.uint8)
    sf = np.frombuffer(suffix, dtype=np.uint8)
    sel = np.empty((n,), dtype=np.int64)
    m, tallied, nblock = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    pub_out = np.empty((n, 32), dtype=np.uint8)
    sig_out = np.empty((n, 64), dtype=np.uint8)
    msgs = np.empty(n * sign_bytes_bound(max(pc.size, pn.size), sf.size), dtype=np.uint8)
    offs = np.empty(n + 1, dtype=np.int64)
    width = ram_nblock(RAM_MAX_LEN) * 16 if ram else 0
    ram_hi = np.empty((n, width), dtype=np.uint32)
    ram_lo = np.empty((n, width), dtype=np.uint32)
    counts = np.empty((n,), dtype=np.int32)
    rc = library().tm_commit_prep_fused(
        _ptr(flags), _ptr(sig), _ptr(ts_seconds), _ptr(ts_nanos), _ptr(pub), _ptr(power), n,
        _ptr(pc), pc.size, _ptr(pn), pn.size, _ptr(sf), sf.size, int(threshold), int(mode),
        _ptr(sel), ctypes.addressof(m), ctypes.addressof(tallied), _ptr(pub_out),
        _ptr(sig_out), _ptr(msgs), msgs.size, _ptr(offs), int(bool(ram)), _ptr(ram_hi),
        _ptr(ram_lo), _ptr(counts), ctypes.addressof(nblock))
    if rc < 0:
        raise ValueError("sign bytes overran their bound")
    m = m.value
    if rc == 1:
        return sel[:m], tallied.value, None
    ram = (ram_hi[:m], ram_lo[:m], counts[:m]) if nblock.value else None
    return sel[:m], tallied.value, (pub_out[:m], sig_out[:m],
                                    memoryview(msgs)[: int(offs[m])], offs[: m + 1], ram)
