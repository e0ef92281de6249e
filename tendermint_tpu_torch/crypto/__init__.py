"""Key and batch-verifier interfaces.

Counterpart: tendermint_tpu/crypto/__init__.py and crypto/tmhash.py
(crypto/crypto.go:22-54 in the reference): PubKey / PrivKey /
BatchVerifier, and Address = SHA256(pubkey)[:20].
"""

from __future__ import annotations

import abc
import hashlib
from typing import List, Tuple

ADDRESS_SIZE = 20


def address_hash(data: bytes) -> bytes:
    """Address of raw key bytes: first 20 bytes of SHA-256."""
    return hashlib.sha256(data).digest()[:ADDRESS_SIZE]


class PubKey(abc.ABC):
    @abc.abstractmethod
    def address(self) -> bytes: ...

    @abc.abstractmethod
    def bytes(self) -> bytes: ...

    @abc.abstractmethod
    def verify_signature(self, msg: bytes, sig: bytes) -> bool: ...

    @abc.abstractmethod
    def type(self) -> str: ...

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PubKey)
            and self.type() == other.type()
            and self.bytes() == other.bytes()
        )

    def __hash__(self):
        return hash((self.type(), self.bytes()))

    def __repr__(self):
        return f"PubKey{self.type().capitalize()}{{{self.bytes().hex().upper()}}}"


class PrivKey(abc.ABC):
    @abc.abstractmethod
    def sign(self, msg: bytes) -> bytes: ...

    @abc.abstractmethod
    def pub_key(self) -> PubKey: ...

    @abc.abstractmethod
    def bytes(self) -> bytes: ...

    @abc.abstractmethod
    def type(self) -> str: ...


class BatchVerifier(abc.ABC):
    """Accumulate (pubkey, msg, sig) triples, verify all at once;
    verify() returns (all_valid, per_entry_validity)."""

    @abc.abstractmethod
    def add(self, key: PubKey, msg: bytes, sig: bytes) -> None: ...

    @abc.abstractmethod
    def verify(self) -> Tuple[bool, List[bool]]: ...
