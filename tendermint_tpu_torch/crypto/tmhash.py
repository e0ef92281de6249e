"""SHA-256 hashing.

Counterpart: tendermint_tpu/crypto/tmhash.py (crypto/tmhash/hash.go):
Sum, the full 32-byte digest.
"""

import hashlib

SIZE = 32


def sum_sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()
