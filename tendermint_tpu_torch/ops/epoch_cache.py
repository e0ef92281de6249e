"""Validator-set epoch cache: device tables of the committee's points.

Counterpart: tendermint_tpu/ops/epoch_cache.py (its ed25519 and
secp256k1 tables). A
validator set stays the same from one height to the next, so the keys
of every commit after the first are ones the device has already
decompressed. The cache keys on ValidatorSet.hash(). The first sight of
a set registers it and returns None: that commit verifies cold. From
the second sight on the set is warm: types/validation.py attaches the
set's key (`epoch_key`) and each signature's validator row (`val_idx`)
to the EntryBlock, and ops/rlc.py's k1_rlc_cached (or, on the
per-signature path, ops/verify.py's k1_decompress_cached; on the
op-graph path, ops/ed25519_verify.py's og_verify_cached) reads A from
the set's table instead of decompressing it. The reference's op-graph
kernel gathers the keys' undecompressed limbs (its xla_tables) and
decompresses A in the kernel; the port's reads the same decompressed
coordinates and flags as the other warm kernels, so a set keeps one
table. An all-secp256k1 set is
noted too (reference :410-419): its warm batches take
ops/secp_verify.py's cached kernel. An all-bls12381 set is noted too
(reference :420-422): its aggregated commits (ops/entry_block.AggBlock)
always carry the set's key, and the BLS lane reads the set's
decompressed G1 table from its entry from the first commit on. sr25519
and mixed sets are never noted: they have no column.

    coords_tables(device)  ed25519: (4*32, vp) int32 decompressed
                           extended coordinates in the kernels' 32-row
                           slots and (1, vp) int32 ok flags, built once
                           per device by the epoch_coords kernel
                           (csrc/rlc.cu)
    secp_tables(device)    secp256k1 (reference :221-247): (vp, 8) int32
                           affine x and y words and (vp,) bool ok flags,
                           decompressed once per set on the host
                           (secp_verify.table_columns) and uploaded once
                           per device
    bls_tables(device)     bls12381 (reference :250-277): (vp, 12) int32
                           affine x and y words (bls_verify.
                           table_columns_g1: a bad key and a padding row
                           are g1; bad keys are found by bls_verify.
                           bad_rows, so unlike the reference no ok flags
                           go to the device), decompressed once per set
                           on the host and uploaded once per device

Rows are padded to vp = max(next_pow2(v + 1), 16) with the scheme's
padding key (ed25519: the identity encoding; secp256k1: the compressed
generator, reference _secp_pad_pub :74; bls12381: the compressed G1
generator, _bls_pad_pub :83, the key of the BLS lane's self-signed pad
commit), so row vp - 1 is always a padding row: padding signatures and
pad commits use it. `lookup` hands a block only
the entry of its own scheme.

TM_TPU_EPOCH_CACHE=N sets the LRU depth (0 disables the cache); unset,
the depth is 8. An evicted or unknown key makes `lookup` return None and
the batch verifies cold: never an error.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from ..crypto import _weierstrass
from ..crypto import bls12381 as _bls
from . import fe, kernels, point

DEFAULT_DEPTH = 8
TABLE_ROWS = 4 * 32

_IDENT_ENC = np.zeros(32, dtype=np.uint8)
_IDENT_ENC[0] = 1  # y = 1: the identity point's encoding
# the compressed secp256k1 generator, the padding rows of a secp256k1 set
_SECP_PAD = np.frombuffer(_weierstrass.compress(_weierstrass.G), dtype=np.uint8)
# the compressed G1 generator, the padding rows of a bls12381 set
_BLS_PAD = np.frombuffer(_bls.g1_compress(_bls.G1_GEN), dtype=np.uint8)
_PAD_ROWS = {"ed25519": _IDENT_ENC, "secp256k1": _SECP_PAD, "bls12381": _BLS_PAD}


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


# -- the table build ------------------------------------------------------------


def epoch_coords_plain(pub_t):
    """(32, vp) uint8 key bytes -> (coords (4*32, vp), ok (1, vp)) int32:
    each column's ZIP-215 decompression (epoch_cache._coords_fn)."""
    vp = pub_t.shape[-1]
    y, sign = point.unpack_limbs(pub_t.to(torch.int32))
    ok, pt = point.decompress(y, sign)
    coords = torch.zeros((TABLE_ROWS, vp), dtype=torch.int32, device=pub_t.device)
    for c in range(4):
        coords[c * 32 : c * 32 + fe.NLIMBS] = pt[c]
    return coords, ok.to(torch.int32)


def epoch_coords(pub_t):
    """The table build (csrc/rlc.cu epoch_coords_kernel, replacing the
    XLA _coords_fn); see epoch_coords_plain."""
    dev = kernels.device_of(pub_t)
    vp = pub_t.shape[-1]
    kernels.check_tensor("pub_t", pub_t, (32, vp), torch.uint8, dev)
    if vp < 1:
        raise ValueError("an epoch table has at least one row")
    if dev.type == "cpu":
        return epoch_coords_plain(pub_t)
    coords = torch.empty((TABLE_ROWS, vp), dtype=torch.int32, device=dev)
    ok = torch.empty((1, vp), dtype=torch.int32, device=dev)
    kernels.launch("epoch_coords", pub_t, coords, ok, vp)
    return coords, ok


def table_columns(entries, bucket: int, ep: "EpochEntry") -> np.ndarray:
    """(bucket,) int32 table columns of an EntryBlock's signatures
    (entries.val_idx), padded with column vp - 1, the identity. A row
    outside the set is refused: on the card it would be a read out of
    the table's bounds."""
    n = len(entries)
    vidx = entries.val_idx
    if vidx is None:
        raise ValueError("a warm batch needs an EntryBlock with val_idx")
    if n and (int(vidx.min()) < 0 or int(vidx.max()) >= ep.n_vals):
        raise ValueError(f"val_idx outside the epoch's {ep.n_vals} validators")
    idx = np.full((bucket,), ep.vp - 1, dtype=np.int32)
    idx[:n] = vidx
    return idx


# -- the cache ------------------------------------------------------------------


class EpochEntry:
    """One validator set's keys: `pub_rows` (vp, 32) on the host (vp, 33
    for secp256k1, vp, 48 for bls12381), padded with the scheme's
    padding key, and its device tables, built lazily once per device
    under the entry's lock."""

    __slots__ = ("key", "n_vals", "vp", "pub_rows", "scheme", "_mtx", "_tables")

    def __init__(self, key: bytes, pub_col: np.ndarray, scheme: str = "ed25519"):
        v = pub_col.shape[0]
        vp = max(_next_pow2(v + 1), 16)
        pad = _PAD_ROWS[scheme]
        rows = np.empty((vp, pad.shape[0]), dtype=np.uint8)
        rows[:v] = pub_col
        rows[v:] = pad
        self.key = key
        self.n_vals = v
        self.vp = vp
        self.pub_rows = rows
        self.scheme = scheme
        self._mtx = threading.Lock()
        self._tables: dict = {}

    def coords_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """((4*32, vp) int32 coordinates, (1, vp) int32 ok flags) on
        `device` (an ed25519 set), built on first use there on the
        current stream; see _on_device."""
        if self.scheme != "ed25519":
            raise ValueError(f"a {self.scheme} set has no ed25519 table")
        return self._on_device("coords", device, lambda dev: epoch_coords(
            torch.from_numpy(np.ascontiguousarray(self.pub_rows.T)).to(dev)))

    def secp_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """((vp, 8) int32 x, (vp, 8) int32 y, (vp,) bool ok) on `device`
        (a secp256k1 set): each key decompressed on the host once per set
        (secp_verify.table_columns: a key that does not decompress is G
        with ok False, a padding row G with ok True), uploaded on first
        use there on the current stream; see _on_device."""
        if self.scheme != "secp256k1":
            raise ValueError(f"a {self.scheme} set has no secp256k1 table")
        from . import secp_verify

        def build(dev):
            # table_columns appends the padding row itself
            cols = secp_verify.table_columns([r.tobytes() for r in self.pub_rows[: self.vp - 1]])
            return tuple(torch.from_numpy(c).to(dev) for c in cols)

        return self._on_device("secp", device, build)

    def bls_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """((vp, 12) int32 x, (vp, 12) int32 y) on `device` (a bls12381
        set): each key decompressed and subgroup-checked on the host once
        per set (bls_verify.table_columns_g1: a bad key and a padding row
        are g1), uploaded on first use there on the current stream; see
        _on_device."""
        if self.scheme != "bls12381":
            raise ValueError(f"a {self.scheme} set has no bls12381 table")
        from . import bls_verify

        def build(dev):
            # table_columns_g1 appends the padding row itself
            cols = bls_verify.table_columns_g1(
                [r.tobytes() for r in self.pub_rows[: self.vp - 1]])
            return tuple(torch.from_numpy(c).to(dev) for c in cols)

        return self._on_device("bls", device, build)

    def _on_device(self, kind: str, device, build) -> tuple:
        """The tables `kind` on `device`, made by build(dev) on first use
        there on the current stream. A caller on another CUDA stream than
        the build's waits for the build's event, and the tables are
        recorded as used on its stream, so the caching allocator keeps
        their memory until its kernels are done."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        with self._mtx:
            t = self._tables.get((kind, dev))
            if t is None:
                tables = build(dev)
                stream = built = None
                if dev.type == "cuda":
                    stream = torch.cuda.current_stream(dev)
                    built = torch.cuda.Event()
                    built.record(stream)
                t = self._tables[(kind, dev)] = (tables, stream, built)
        tables, stream, built = t
        if built is not None:
            cur = torch.cuda.current_stream(dev)
            if cur != stream:
                cur.wait_event(built)
                for x in tables:
                    x.record_stream(cur)
        return tables


class EpochCache:
    """LRU over recent validator sets, with hit, miss and eviction counts."""

    def __init__(self, depth: int):
        self.depth = depth
        self.hits = self.misses = self.evictions = 0
        self._mtx = threading.Lock()
        self._entries: "OrderedDict[bytes, EpochEntry]" = OrderedDict()

    def __len__(self) -> int:
        with self._mtx:
            return len(self._entries)

    def get(self, key: bytes) -> Optional[EpochEntry]:
        with self._mtx:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
            return e

    def note(self, key: bytes, pub_col: np.ndarray,
             scheme: str = "ed25519") -> Optional[EpochEntry]:
        """The entry of a warm set (seen before: a hit); a cold set is
        registered (a miss, evicting the least recent beyond `depth`) and
        gives None, so its first commit verifies cold."""
        with self._mtx:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return e
            self.misses += 1
            self._entries[key] = EpochEntry(key, pub_col, scheme)
            while len(self._entries) > self.depth:
                self._entries.popitem(last=False)
                self.evictions += 1
        return None


_cache: Optional[EpochCache] = None
_cache_mtx = threading.Lock()


def _depth_from_env() -> int:
    env = os.environ.get("TM_TPU_EPOCH_CACHE")
    if env is None:
        return DEFAULT_DEPTH
    try:
        return max(int(env), 0)
    except ValueError:
        return 0


def _current() -> EpochCache:
    global _cache
    with _cache_mtx:
        if _cache is None:
            _cache = EpochCache(_depth_from_env())
        return _cache


def cache() -> Optional[EpochCache]:
    """The process-wide cache, or None when its depth is 0. The depth is
    read from the environment once; reset() reads it again."""
    c = _current()
    return c if c.depth > 0 else None


def reset(depth: Optional[int] = None) -> None:
    """Drop every entry and zero the counts; `depth` overrides the
    environment's."""
    global _cache
    with _cache_mtx:
        _cache = EpochCache(_depth_from_env() if depth is None else depth)


def note_valset(vals) -> Optional[bytes]:
    """Register or refresh `vals`; its key when the set is warm (seen
    before) and all-ed25519, all-secp256k1 or all-bls12381, else None."""
    c = cache()
    if c is None:
        return None
    cols, scheme = vals.ed25519_columns(), "ed25519"
    if cols is None:
        cols, scheme = vals.secp256k1_columns(), "secp256k1"
    if cols is None:
        cols, scheme = vals.bls12381_columns(), "bls12381"
    if cols is None:
        return None
    key = vals.hash()
    return key if c.note(key, cols[0], scheme) is not None else None


def lookup(entries) -> Optional[EpochEntry]:
    """The epoch entry of an EntryBlock, or None (no key or rows, an
    evicted key, the cache disabled, or an entry of another scheme than
    the block's: its table would feed the wrong kernel)."""
    key = getattr(entries, "epoch_key", None)
    if key is None or getattr(entries, "val_idx", None) is None:
        return None
    c = cache()
    e = None if c is None else c.get(key)
    if e is not None and e.scheme != getattr(entries, "scheme", "ed25519"):
        return None
    return e


def stats() -> dict:
    """The cache's state and its counts since the last reset()."""
    c = _current()
    return {
        "enabled": c.depth > 0,
        "depth": c.depth,
        "entries": len(c),
        "hits": c.hits,
        "misses": c.misses,
        "evictions": c.evictions,
    }
