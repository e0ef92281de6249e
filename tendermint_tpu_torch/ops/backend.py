"""Host side of the device verifier: row packing, challenges, s < L, the
path switch, the batch sizes of the dispatcher, and the BatchVerifiers
the commit path uses.

Counterpart: tendermint_tpu/ops/backend.py (_pack_rows, _challenges,
_s_below_l, _use_rlc, BUCKETS :71, quantized_bucket :809, max_coalesce
:818, Ed25519DeviceBatchVerifier :1030-1059). DeviceBatchVerifier holds
what the ed25519 verifier here and the sr25519 one (ops/mixed.py)
share: the reference's add() checks and the accumulate-then-verify of
one EntryBlock. The ed25519 verifier verifies below DEVICE_THRESHOLD
signatures on the host and sends every larger block through the shared
asynchronous dispatcher of its device (ops/pipeline.shared_verifier),
whose host prep (prepare_ed25519) picks the RLC path of ops/rlc.py or,
with TM_TPU_RLC=0, the per-signature path of ops/verify.py. The
reference verifies a block above BUCKETS[-1] synchronously in chunks;
here the dispatcher splits it into the same chunks (max_coalesce()
signatures), so every device launch of the path comes from the
dispatch thread. The challenges
come from the host library (ops/host.py, csrc/host_prep.cpp) in one
call over the block's message buffer; _challenges, hashlib and Python
big-int reductions, is the tests' oracle for it.

The reference's backend._bucket_for (:90), the XLA path's bucket, has
no counterpart: the port's per-signature path pads with
verify.bucket_for (the reference's _pallas_bucket).

secp256k1 (reference :102-109, :492-575, :864): a block of scheme
secp256k1 pads to SECP_BUCKETS and verifies through ops/secp_verify.py's
kernels, cached when the epoch cache holds its set; prepare_block is
the dispatcher's host stage for a block of either scheme, and
verify_batch the synchronous path. The reference's prepare_batch_secp
and prepare_batch_secp_cached are secp_verify.prepare_batch here, as
the ed25519 preps are rlc.prepare_batch and verify.prepare_batch.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..crypto import BatchVerifier, PubKey
from ..crypto import ed25519 as _ed25519
from ..crypto._edwards import L
from . import epoch_cache, host, rlc, secp_verify
from . import verify as per_sig
from .entry_block import EntryBlock

# Below this many signatures a batch verifies on the host, one signature
# at a time (backend.DEVICE_THRESHOLD's default).
DEVICE_THRESHOLD = 64

# The per-signature path's buckets; the last is the largest batch the
# verifier sends through the dispatcher (backend.BUCKETS).
BUCKETS = per_sig.BUCKETS


def use_rlc() -> bool:
    """The batch path, read from TM_TPU_RLC at each call (backend._use_rlc):
    unset or any value but "0" takes the RLC path, "0" the per-signature
    one."""
    return os.environ.get("TM_TPU_RLC", "1") != "0"


# The secp256k1 lane's buckets (backend.SECP_BUCKETS): a finer floor,
# since its ladder's time is linear in the rows, padding included.
SECP_BUCKETS = secp_verify.BUCKETS


def quantized_bucket(n: int, scheme: str = "ed25519") -> int:
    """The signatures a device batch of n of `scheme` pads to
    (backend.quantized_bucket, and _secp_bucket_for for secp256k1): for
    ed25519 on the path TM_TPU_RLC picks now."""
    if scheme == "secp256k1":
        return secp_verify.bucket_for(n)
    return rlc.plan_bucket(n)[0] if use_rlc() else per_sig.bucket_for(n)


def max_coalesce(scheme: str = "ed25519") -> int:
    """The largest device batch of `scheme` the dispatcher fuses jobs into
    (backend.max_coalesce): SECP_BUCKETS[-1] for secp256k1; for ed25519
    rlc.MAX_SIGS on the RLC path, BUCKETS[-1] on the per-signature one."""
    if scheme == "secp256k1":
        return SECP_BUCKETS[-1]
    return rlc.MAX_SIGS if use_rlc() else BUCKETS[-1]


def prepare_secp(entries) -> "secp_verify.SecpBatch":
    """The dispatcher's host stage for a secp256k1 block (the reference's
    _prepare, pipeline.py:535-552): the cached kernel's arrays when the
    epoch cache holds the block's set, else the uncached one's. There is
    no RLC and no blame pass."""
    return secp_verify.prepare_batch(entries, epoch_cache.lookup(entries))


def prepare_block(entries):
    """The dispatcher's host stage, by the block's scheme."""
    if getattr(entries, "scheme", "ed25519") == "secp256k1":
        return prepare_secp(entries)
    return prepare_ed25519(entries)


def prepare_ed25519(entries):
    """The dispatcher's host stage for an ed25519 block (the reference's
    AsyncBatchVerifier._prepare, pipeline.py:496-629, Pallas branches):
    TM_TPU_RLC read now picks rlc.prepare_batch or
    verify.prepare_batch. The prepared batch carries its own launch and
    conclude stages."""
    return rlc.prepare_batch(entries) if use_rlc() else per_sig.prepare_batch(entries)


_L_BE = np.frombuffer(L.to_bytes(32, "big"), dtype=np.uint8)


def _pack_rows(entries: EntryBlock, bucket: int):
    """(bucket, 32) pub / R / s rows; padding rows A = R = the identity
    encoding (y = 1), s = 0 — they verify."""
    n = len(entries)
    pub = np.zeros((bucket, 32), dtype=np.uint8)
    r_enc = np.zeros((bucket, 32), dtype=np.uint8)
    s_enc = np.zeros((bucket, 32), dtype=np.uint8)
    pub[:n] = entries.pub
    r_enc[:n] = entries.sig[:, :32]
    s_enc[:n] = entries.sig[:, 32:]
    pub[n:, 0] = 1
    r_enc[n:, 0] = 1
    return pub, r_enc, s_enc


def _challenges(r_enc: np.ndarray, pub: np.ndarray, msgs) -> bytes:
    """k_i = SHA512(R_i || A_i || M_i) mod L, 32 bytes little-endian each:
    the oracle of host.ed25519_challenges_buf."""
    n = len(msgs)
    ra = np.empty((n, 64), dtype=np.uint8)
    ra[:, :32] = r_enc[:n]
    ra[:, 32:] = pub[:n]
    ra_b = ra.tobytes()
    sha = hashlib.sha512
    return b"".join(
        (
            int.from_bytes(sha(ra_b[64 * i : 64 * i + 64] + m).digest(), "little")
            % L
        ).to_bytes(32, "little")
        for i, m in enumerate(msgs)
    )


def _s_below_l(s_enc: np.ndarray, n: int, bucket: int) -> np.ndarray:
    """s < L (RFC 8032 scalar range) by a big-endian lexicographic
    compare; padding rows (s = 0) pass."""
    s_ok = np.zeros((bucket,), dtype=bool)
    s_ok[n:] = True
    if n:
        s_be = s_enc[:n, ::-1]
        diff = s_be != _L_BE
        first = diff.argmax(axis=1)
        s_ok[:n] = diff.any(axis=1) & (s_be[np.arange(n), first] < _L_BE[first])
    return s_ok


def _host_rows(entries: EntryBlock, bucket: int):
    """The host stage both batch preps share: (bucket, 32) pub, R, s and
    k = SHA512(R || A || M) mod L rows (k = 0 on padding rows) and the
    (bucket,) s < L flags."""
    n = len(entries)
    pub, r_enc, s_enc = _pack_rows(entries, bucket)
    s_ok = _s_below_l(s_enc, n, bucket)
    k_enc = np.zeros((bucket, 32), dtype=np.uint8)
    buf, offs = entries.msgs_contiguous()
    k_enc[:n] = host.ed25519_challenges_buf(r_enc[:n], pub[:n], buf,
                                            np.ascontiguousarray(offs, dtype=np.int64))
    return pub, r_enc, s_enc, k_enc, s_ok


class DeviceBatchVerifier(BatchVerifier):
    """Accumulate-then-verify on `device`, for one key type. add() mirrors
    the reference's BatchVerifier.Add checks (crypto/ed25519/ed25519.go:
    203-217, crypto/sr25519/batch.go); verify() returns (all_valid,
    per_sig_valid) like BatchVerifier.Verify. A subclass names its key
    class and verifies the accumulated EntryBlock in _verify_block."""

    KEY_CLASS: type = PubKey
    KEY_NAME = ""
    SCHEME = "ed25519"  # the EntryBlock scheme of the accumulated entries
    SIGNATURE_SIZE = 64

    def __init__(self, device):
        self.device = device
        self._entries: List[Tuple[bytes, bytes, bytes]] = []
        self._blocks: List[EntryBlock] = []

    def _check_key(self, key) -> None:
        if not isinstance(key, self.KEY_CLASS):
            raise TypeError(f"pubkey is not {self.KEY_NAME}")

    def add(self, key: PubKey, msg: bytes, sig: bytes) -> None:
        self._check_key(key)
        if len(sig) != self.SIGNATURE_SIZE:
            raise ValueError("invalid signature length")
        self._entries.append((key.bytes(), msg, sig))

    def add_block(self, block: EntryBlock, keys=None) -> None:
        """Columnar bulk add; `keys` (the rows' PubKey objects) gets the
        same per-key type check as add()."""
        for k in keys or ():
            self._check_key(k)
        if len(block):
            # keep submission order: flush interleaved add() entries first
            if self._entries:
                self._blocks.append(EntryBlock.from_entries(self._entries, scheme=self.SCHEME))
                self._entries = []
            self._blocks.append(block)

    def _verify_block(self, block: EntryBlock) -> np.ndarray:
        raise NotImplementedError

    def verify(self) -> Tuple[bool, List[bool]]:
        blocks = list(self._blocks)
        if self._entries:
            blocks.append(EntryBlock.from_entries(self._entries, scheme=self.SCHEME))
        block = EntryBlock.concat(blocks) if blocks else EntryBlock.from_entries(
            [], scheme=self.SCHEME)
        if len(block) == 0:
            return False, []
        res = np.asarray(self._verify_block(block), dtype=bool)
        return bool(res.all()), res.tolist()


class Ed25519DeviceBatchVerifier(DeviceBatchVerifier):
    """ed25519 on `device` (backend.py:1030-1059): below DEVICE_THRESHOLD
    signatures on the host; from there up through the device's shared
    dispatcher, which splits a block above its batch cap, waiting at
    most 600 s."""

    KEY_CLASS = _ed25519.PubKey
    KEY_NAME = "ed25519"
    SIGNATURE_SIZE = _ed25519.SIGNATURE_SIZE

    def _verify_block(self, block: EntryBlock) -> np.ndarray:
        if len(block) < DEVICE_THRESHOLD:
            return np.array([_ed25519.verify_zip215(*e) for e in block.iter_entries()],
                            dtype=bool)
        from .pipeline import shared_verifier

        return shared_verifier(self.device).submit(block).result(timeout=600)


# -- the synchronous batch path -----------------------------------------------


def verify_batch_secp(entries: EntryBlock, *, device) -> np.ndarray:
    """A secp256k1 EntryBlock of any size -> (n,) bool verdicts,
    synchronously on the caller's thread (reference :547-575): chunks of
    SECP_BUCKETS[-1], each prepared (cached when the epoch cache holds
    the block's set), copied, launched and read back."""
    if entries.scheme != "secp256k1":
        raise ValueError(f"a {entries.scheme} block is not secp256k1")
    out = []
    cap = max_coalesce("secp256k1")
    for i in range(0, len(entries), cap):
        batch = prepare_secp(entries[i : i + cap])
        with record_function("secp.h2d"):
            dev_args = [torch.from_numpy(a).to(device) for a in batch.args]
        res = batch.launch(dev_args)
        with record_function("secp.d2h"):  # waits for the kernel
            row = res.cpu().numpy()
        out.append(batch.conclude(row))
    return np.concatenate(out) if out else np.zeros((0,), dtype=bool)


def verify_batch(entries, *, device) -> np.ndarray:
    """The synchronous direct path (reference :864): an EntryBlock of any
    size -> (n,) bool verdicts on `device`, by its scheme: secp256k1
    through verify_batch_secp, ed25519 through the path TM_TPU_RLC picks
    (rlc.verify_batch_rlc, verify.verify_batch_compact)."""
    if entries.scheme == "secp256k1":
        return verify_batch_secp(entries, device=device)
    if use_rlc():
        return rlc.verify_batch_rlc(entries, device=device)
    return per_sig.verify_batch_compact(entries, device=device)
