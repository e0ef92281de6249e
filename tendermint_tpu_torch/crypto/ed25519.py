"""Ed25519 keys with ZIP-215 verification semantics, in pure Python.

Counterpart: tendermint_tpu/crypto/ed25519.py (crypto/ed25519/ed25519.go
in the reference). PrivKey is seed || pubkey (64 bytes); Address is
SHA256(pub)[:20]; verification is ZIP-215 (crypto/_edwards.py). There is
no OpenSSL path: the machine with the card has no `cryptography` wheel,
and the hot path verifies on the card, so host verification is only the
sub-threshold path and the blame path.
"""

from __future__ import annotations

import os

from . import PrivKey as _PrivKey, PubKey as _PubKey, address_hash
from . import _edwards

KEY_TYPE = "ed25519"
PUB_KEY_SIZE = 32
PRIV_KEY_SIZE = 64  # seed || pubkey
SIGNATURE_SIZE = 64
SEED_SIZE = 32


def verify_zip215(pub: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != SIGNATURE_SIZE or len(pub) != PUB_KEY_SIZE:
        return False
    return _edwards.verify_zip215(pub, msg, sig)


class PubKey(_PubKey):
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != PUB_KEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(data)

    def address(self) -> bytes:
        return address_hash(self._bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        return verify_zip215(self._bytes, msg, sig)

    def type(self) -> str:
        return KEY_TYPE


class PrivKey(_PrivKey):
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != PRIV_KEY_SIZE:
            raise ValueError(f"ed25519 privkey must be {PRIV_KEY_SIZE} bytes")
        self._bytes = bytes(data)

    def sign(self, msg: bytes) -> bytes:
        return _edwards.sign(self._bytes[:SEED_SIZE], msg)

    def pub_key(self) -> PubKey:
        return PubKey(self._bytes[SEED_SIZE:])

    def bytes(self) -> bytes:
        return self._bytes

    def type(self) -> str:
        return KEY_TYPE


def gen_priv_key(seed: bytes | None = None) -> PrivKey:
    """Private key from a 32-byte seed (random when None)."""
    if seed is None:
        seed = os.urandom(SEED_SIZE)
    if len(seed) != SEED_SIZE:
        raise ValueError(f"seed must be {SEED_SIZE} bytes")
    return PrivKey(seed + _edwards.pubkey_from_seed(seed))
