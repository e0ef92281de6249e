"""Host side of the device verifier: row packing, challenges, s < L, the
path switch, and the BatchVerifier the commit path uses.

Counterpart: tendermint_tpu/ops/backend.py (_pack_rows, _challenges,
_s_below_l, _use_rlc, Ed25519DeviceBatchVerifier). The batch path is
synchronous, one batch at a time with no async pipeline: the RLC path of
ops/rlc.py (verify_batch_rlc, which takes a warm validator set's epoch
table) or, with TM_TPU_RLC=0, the per-signature path of ops/verify.py
(verify_batch_compact). Challenges are hashlib SHA-512 and Python
big-int reductions (the JAX package's fallback when its native helpers
are not built).
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Tuple

import numpy as np

from ..crypto import BatchVerifier, PubKey
from ..crypto import ed25519 as _ed25519
from ..crypto._edwards import L
from . import rlc
from . import verify as per_sig
from .entry_block import EntryBlock

# Below this many signatures a batch verifies on the host, one signature
# at a time (backend.DEVICE_THRESHOLD's default).
DEVICE_THRESHOLD = 64


def use_rlc() -> bool:
    """The batch path, read from TM_TPU_RLC at each call (backend._use_rlc):
    unset or any value but "0" takes the RLC path, "0" the per-signature
    one."""
    return os.environ.get("TM_TPU_RLC", "1") != "0"


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
    """k_i = SHA512(R_i || A_i || M_i) mod L, 32 bytes little-endian each."""
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
    if n:
        ks = _challenges(r_enc[:n], pub[:n], entries.messages())
        k_enc[:n] = np.frombuffer(ks, dtype=np.uint8).reshape(n, 32)
    return pub, r_enc, s_enc, k_enc, s_ok


class Ed25519DeviceBatchVerifier(BatchVerifier):
    """Accumulate-then-verify on `device`. add() mirrors curve25519-voi's
    BatchVerifier.Add checks (crypto/ed25519/ed25519.go:203-217); verify()
    returns (all_valid, per_sig_valid) like BatchVerifier.Verify."""

    def __init__(self, device):
        self.device = device
        self._entries: List[Tuple[bytes, bytes, bytes]] = []
        self._blocks: List[EntryBlock] = []

    def add(self, key: PubKey, msg: bytes, sig: bytes) -> None:
        if not isinstance(key, _ed25519.PubKey):
            raise TypeError("pubkey is not ed25519")
        if len(sig) != _ed25519.SIGNATURE_SIZE:
            raise ValueError("invalid signature length")
        self._entries.append((key.bytes(), msg, sig))

    def add_block(self, block: EntryBlock, keys=None) -> None:
        """Columnar bulk add; `keys` (the rows' PubKey objects) gets the
        same per-key type check as add()."""
        if keys is not None and any(
            not isinstance(k, _ed25519.PubKey) for k in keys
        ):
            raise TypeError("pubkey is not ed25519")
        if len(block):
            # keep submission order: flush interleaved add() entries first
            if self._entries:
                self._blocks.append(EntryBlock.from_entries(self._entries))
                self._entries = []
            self._blocks.append(block)

    def verify(self) -> Tuple[bool, List[bool]]:
        blocks = list(self._blocks)
        if self._entries:
            blocks.append(EntryBlock.from_entries(self._entries))
        block = EntryBlock.concat(blocks)
        n = len(block)
        if n == 0:
            return False, []
        if n < DEVICE_THRESHOLD:
            valid = [_ed25519.verify_zip215(*e) for e in block.iter_entries()]
            return all(valid), valid
        if use_rlc():
            res = rlc.verify_batch_rlc(block, device=self.device)
        else:
            res = per_sig.verify_batch_compact(block, device=self.device)
        return bool(res.all()), res.tolist()
