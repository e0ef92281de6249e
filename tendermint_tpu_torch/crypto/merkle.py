"""RFC-6962-style Merkle root of a list of byte slices.

Counterpart: tendermint_tpu/crypto/merkle.py (crypto/merkle/tree.go):
hash_from_byte_slices and what it needs, with the leaf and inner
prefixes 0x00 and 0x01 and the split at the largest power of two below
the length. Pure Python (the JAX package hands lists of 16 or more to
its native engine; the result is the same).
"""

from __future__ import annotations

from typing import Sequence

from .tmhash import sum_sha256 as _sha256

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def leaf_hash(leaf: bytes) -> bytes:
    return _sha256(LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(INNER_PREFIX + left + right)


def split_point(length: int) -> int:
    """Largest power of 2 strictly less than length (tree.go:92-103)."""
    if length < 1:
        raise ValueError("length must be >= 1")
    bit_len = (length - 1).bit_length()
    k = 1 << (bit_len - 1) if bit_len > 0 else 1
    if k == length:
        k >>= 1
    return max(k, 1) if length > 1 else 0


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    """Merkle root of the list (tree.go:11-29); an empty list hashes to
    SHA256("")."""
    n = len(items)
    if n == 0:
        return _sha256(b"")
    if n == 1:
        return leaf_hash(items[0])
    k = split_point(n)
    return inner_hash(hash_from_byte_slices(items[:k]),
                      hash_from_byte_slices(items[k:]))
