"""Host side of the device verifier: the challenges' oracle, the
path switch, the batch sizes of the dispatcher, and the BatchVerifiers
the commit path uses.

Counterpart: tendermint_tpu/ops/backend.py (_challenges, _use_rlc,
_use_pallas :787, HOST_HASH :85, _max_msg_len :844, BUCKETS :71,
quantized_bucket :809, max_coalesce :818, Ed25519DeviceBatchVerifier
:1030-1059; _pack_rows and _s_below_l are ops/packing.py's, _bucket_for
:90 ed25519_verify.bucket_for). DeviceBatchVerifier holds
what the ed25519 verifier here and the sr25519 one (ops/mixed.py)
share: the reference's add() checks and the accumulate-then-verify of
one EntryBlock. The ed25519 verifier verifies below DEVICE_THRESHOLD
signatures on the host and sends every larger block through the shared
asynchronous dispatcher of its device (ops/pipeline.shared_verifier),
whose host prep (prepare_ed25519) picks the RLC path of ops/rlc.py or,
with TM_TPU_RLC=0, the per-signature path of ops/verify.py; with
TM_TPU_PALLAS=0 the op-graph path of ops/ed25519_verify.py (the
reference's path where Pallas is off), whose challenges hash on the card
unless TM_TPU_HOST_HASH=1 or a message of the batch exceeds
DEVICE_HASH_MAX_MSG (device_hash_for, backend.py:921). The
reference verifies a block above BUCKETS[-1] synchronously in chunks;
here the dispatcher splits it into the same chunks (max_coalesce()
signatures), so every device launch of the path comes from the
dispatch thread. The challenges
come from the host library (ops/host.py, csrc/host_prep.cpp) in one
call over the block's message buffer; _challenges, hashlib and Python
big-int reductions, is the tests' oracle for it.

Buckets: the op-graph path pads with ed25519_verify.bucket_for (the
reference's _bucket_for, BUCKETS 128, 1024, 10240), the per-signature
path with verify.bucket_for (the reference's _pallas_bucket), the RLC
path with rlc.plan_bucket.

secp256k1 (reference :102-109, :492-575, :864): a block of scheme
secp256k1 pads to SECP_BUCKETS and verifies through ops/secp_verify.py's
kernels, cached when the epoch cache holds its set; prepare_block is
the dispatcher's host stage for a block of either scheme, and
verify_batch the synchronous path. The reference's prepare_batch_secp
and prepare_batch_secp_cached are secp_verify.prepare_batch here, as
the ed25519 preps are rlc.prepare_batch and verify.prepare_batch.

bls12381 (reference :584-728, :867): an AggBlock (one aggregated commit
a row) pads to BLS_BUCKETS and verifies through ops/bls_verify.py's
two-launch protocol, with its committee's table from the epoch cache
(bls_epoch) or built from the block's keys. The reference's
prepare_batch_bls, _bls_bad_rows and bls_kernel are bls_verify.
prepare_batch, bad_rows and BlsBatch.launch here; verify_batch_bls_codes
is the synchronous path, and its row is int32 verdict codes
(bls_verify.CODE_*).
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
from . import bls_verify, epoch_cache, host, rlc, secp_verify
from . import ed25519_verify as og
from . import verify as per_sig
from .commit_prep import DEVICE_HASH_MAX_MSG
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


def use_pallas() -> bool:
    """The ed25519 kernel family, read from TM_TPU_PALLAS at each call
    (backend._use_pallas): unset or any value but "0" takes the ported
    Pallas kernels (the RLC or per-signature path, use_rlc), "0" the
    op-graph path (ops/ed25519_verify.py). The reference picks Pallas by
    default only on a TPU; the port's default is the Pallas kernels'
    counterparts."""
    return os.environ.get("TM_TPU_PALLAS", "1") != "0"


def host_hash() -> bool:
    """TM_TPU_HOST_HASH read at each call (backend.HOST_HASH, which the
    reference reads at import): "1" sends the op-graph path's challenges
    to the host library."""
    return bool(int(os.environ.get("TM_TPU_HOST_HASH", "0")))


def builds_ram_columns() -> bool:
    """Whether verify_commit's fused prep lays out the RAM columns (the
    device hash's input): on the op-graph path (TM_TPU_PALLAS=0) unless
    TM_TPU_HOST_HASH=1. The RLC and per-signature paths never read
    them."""
    return not use_pallas() and not host_hash()


def device_hash_for(entries) -> bool:
    """Whether an op-graph batch hashes its challenges on the card
    (backend.py:921, with _max_msg_len :844): unless TM_TPU_HOST_HASH=1,
    or a message exceeds DEVICE_HASH_MAX_MSG (then the host library
    computes them)."""
    longest = int(np.diff(entries.offsets).max()) if len(entries) else 0
    return not host_hash() and longest <= DEVICE_HASH_MAX_MSG


# The secp256k1 lane's buckets (backend.SECP_BUCKETS): a finer floor,
# since its ladder's time is linear in the rows, padding included.
SECP_BUCKETS = secp_verify.BUCKETS


# The bls12381 lane's buckets, in aggregated commits (backend.BLS_BUCKETS).
BLS_BUCKETS = bls_verify.BUCKETS

# Below this many concurrent aggregated commits (the caller's k_hint) a
# commit verifies synchronously through the oracle
# (types/validation.prepare_aggregated_commit): one fused launch cannot
# amortise its final exponentiation (backend.BLS_DEVICE_THRESHOLD's
# default).
BLS_DEVICE_THRESHOLD = 2


def quantized_bucket(n: int, scheme: str = "ed25519") -> int:
    """The rows a device batch of n of `scheme` pads to
    (backend.quantized_bucket, and _secp_bucket_for, _bls_bucket_for):
    for ed25519 on the path TM_TPU_PALLAS and TM_TPU_RLC pick now."""
    if scheme == "secp256k1":
        return secp_verify.bucket_for(n)
    if scheme == "bls12381":
        return bls_verify.bucket_for(n)
    if not use_pallas():
        return og.bucket_for(n)
    return rlc.plan_bucket(n)[0] if use_rlc() else per_sig.bucket_for(n)


def max_coalesce(scheme: str = "ed25519") -> int:
    """The largest device batch of `scheme` the dispatcher fuses jobs into
    (backend.max_coalesce): SECP_BUCKETS[-1] for secp256k1, BLS_BUCKETS[-1]
    aggregated commits for bls12381; for ed25519 rlc.MAX_SIGS on the RLC
    path, BUCKETS[-1] on the per-signature and the op-graph ones."""
    if scheme == "secp256k1":
        return SECP_BUCKETS[-1]
    if scheme == "bls12381":
        return BLS_BUCKETS[-1]
    return rlc.MAX_SIGS if use_pallas() and use_rlc() else BUCKETS[-1]


def coalesce_linger(scheme: str = "ed25519") -> float:
    """Seconds the dispatcher's coalescer waits for more jobs of `scheme`
    while the device is idle (the reference's dispatcher has no such
    wait): 5 ms for bls12381, where each launch A pays a whole final
    exponentiation (about a second on an H100, PERF.md), so aggregated
    commits submitted together (prepare_aggregated_commit's k_hint) must
    land in one launch rather than in two; none for the other schemes."""
    return 0.005 if scheme == "bls12381" else 0.0


def prepare_secp(entries) -> "secp_verify.SecpBatch":
    """The dispatcher's host stage for a secp256k1 block (the reference's
    _prepare, pipeline.py:535-552): the cached kernel's arrays when the
    epoch cache holds the block's set, else the uncached one's. There is
    no RLC and no blame pass."""
    return secp_verify.prepare_batch(entries, epoch_cache.lookup(entries))


def bls_epoch(block):
    """The epoch entry of an AggBlock's committee, or None (reference
    _bls_epoch :607): AggBlocks carry no val_idx (the bitmap indexes the
    committee), so this looks the key up directly and only guards the
    scheme."""
    key = getattr(block, "epoch_key", None)
    c = epoch_cache.cache()
    ep = None if key is None or c is None else c.get(key)
    return ep if ep is not None and ep.scheme == "bls12381" else None


def prepare_bls(block) -> "bls_verify.BlsBatch":
    """The dispatcher's host stage for an AggBlock (reference
    pipeline.py:516-534): its committee's epoch entry when the cache
    holds it, else a table built from the block's keys."""
    return bls_verify.prepare_batch(block, bls_epoch(block))


def prepare_block(entries):
    """The dispatcher's host stage, by the block's scheme."""
    scheme = getattr(entries, "scheme", "ed25519")
    if scheme == "secp256k1":
        return prepare_secp(entries)
    if scheme == "bls12381":
        return prepare_bls(entries)
    return prepare_ed25519(entries)


def prepare_ed25519(entries):
    """The dispatcher's host stage for an ed25519 block (the reference's
    AsyncBatchVerifier._prepare, pipeline.py:496-629): TM_TPU_PALLAS and
    TM_TPU_RLC read now pick rlc.prepare_batch, verify.prepare_batch or,
    Pallas off, ed25519_verify.prepare_batch with the hash route of
    device_hash_for (:604-628). The prepared batch carries its own launch
    and conclude stages."""
    if not use_pallas():
        return og.prepare_batch(entries, device_hash_for(entries))
    return rlc.prepare_batch(entries) if use_rlc() else per_sig.prepare_batch(entries)


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


def verify_batch_bls_codes(block, *, device) -> np.ndarray:
    """An AggBlock of any size -> (k,) int32 verdict codes
    (bls_verify.CODE_*), synchronously on the caller's thread (reference
    :687-721): chunks of BLS_BUCKETS[-1] commits, each prepared, copied
    and run through the two-launch protocol."""
    if getattr(block, "scheme", None) != "bls12381":
        raise ValueError("verify_batch_bls_codes takes an AggBlock")
    out = [np.zeros((0,), dtype=np.int32)]
    cap = max_coalesce("bls12381")
    for i in range(0, len(block), cap):
        batch = prepare_bls(block[i : i + cap])
        with record_function("bls.h2d"):
            dev_args = [torch.from_numpy(a).to(device) for a in batch.args]
        out.append(batch.conclude(batch.launch(dev_args).numpy()))
    return np.concatenate(out)


def verify_batch_bls(block, *, device) -> np.ndarray:
    """The boolean face of verify_batch_bls_codes: one bool a commit."""
    return verify_batch_bls_codes(block, device=device) == bls_verify.CODE_VALID


def verify_batch(entries, *, device) -> np.ndarray:
    """The synchronous direct path (reference :864): a block of any size
    -> (n,) bool verdicts on `device`, by its scheme: secp256k1 through
    verify_batch_secp, bls12381 (an AggBlock, a verdict a commit) through
    verify_batch_bls, ed25519 through the path TM_TPU_PALLAS and
    TM_TPU_RLC pick (ed25519_verify.verify_batch_og, rlc.verify_batch_rlc,
    verify.verify_batch_compact)."""
    if entries.scheme == "secp256k1":
        return verify_batch_secp(entries, device=device)
    if entries.scheme == "bls12381":
        return verify_batch_bls(entries, device=device)
    if not use_pallas():
        return og.verify_batch_og(entries, device=device)
    if use_rlc():
        return rlc.verify_batch_rlc(entries, device=device)
    return per_sig.verify_batch_compact(entries, device=device)
