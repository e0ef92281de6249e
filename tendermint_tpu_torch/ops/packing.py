"""The (bucket, 32) rows every ed25519 batch prep starts from: pub, R and
s packed and padded, the s < L flags, and the host library's challenges.

Counterpart: tendermint_tpu/ops/backend.py (_pack_rows, _s_below_l and
the row half of prepare_compact). The RLC (ops/rlc.py), per-signature
(ops/verify.py), op-graph (ops/ed25519_verify.py) and sr25519
(ops/sr25519.py) preps call them here; ops/backend.py keeps the
Python oracle of the challenges (_challenges).
"""

from __future__ import annotations

import numpy as np

from ..crypto._edwards import L
from . import host
from .entry_block import EntryBlock

_L_BE = np.frombuffer(L.to_bytes(32, "big"), dtype=np.uint8)


def pack_rows(entries: EntryBlock, bucket: int):
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


def s_below_l(s_enc: np.ndarray, n: int, bucket: int) -> np.ndarray:
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


def host_rows(entries: EntryBlock, bucket: int):
    """The host stage the per-signature and op-graph preps share:
    (bucket, 32) pub, R, s and k = SHA512(R || A || M) mod L rows (k = 0
    on padding rows) and the (bucket,) s < L flags."""
    n = len(entries)
    pub, r_enc, s_enc = pack_rows(entries, bucket)
    s_ok = s_below_l(s_enc, n, bucket)
    k_enc = np.zeros((bucket, 32), dtype=np.uint8)
    buf, offs = entries.msgs_contiguous()
    k_enc[:n] = host.ed25519_challenges_buf(r_enc[:n], pub[:n], buf,
                                            np.ascontiguousarray(offs, dtype=np.int64))
    return pub, r_enc, s_enc, k_enc, s_ok
