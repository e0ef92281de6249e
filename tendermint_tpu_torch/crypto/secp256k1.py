"""secp256k1 ECDSA keys, in pure Python.

Counterpart: tendermint_tpu/crypto/secp256k1.py (crypto/secp256k1/
secp256k1.go and secp256k1_nocgo.go in the reference):
  - PubKey is 33-byte compressed SEC1; Address = RIPEMD160(SHA256(pub))
    (secp256k1.go:141-153);
  - Sign: ECDSA over SHA256(msg), RFC 6979 nonces, 64-byte R || S in
    lower-S form (nocgo:20-32);
  - VerifySignature rejects r or s outside (0, n) and a non-lower-S s
    (nocgo:34-54).
There is no OpenSSL path (the machine with the card has no
`cryptography` wheel): signing and host verification run
crypto/_weierstrass.py, whose signatures are byte-identical to OpenSSL's
deterministic ones. secp256k1 has no batch verifier
(crypto/batch.go:26-33); its device lane is ops/secp_verify.py, reached
through the commit path's prepare seam and ops/mixed.py.
"""

from __future__ import annotations

import hashlib
import os

from . import PrivKey as _PrivKey, PubKey as _PubKey
from . import _weierstrass

KEY_TYPE = "secp256k1"
PUB_KEY_SIZE = 33
PRIV_KEY_SIZE = 32
SIGNATURE_LENGTH = 64

PUB_KEY_NAME = "tendermint/PubKeySecp256k1"
PRIV_KEY_NAME = "tendermint/PrivKeySecp256k1"

N = _weierstrass.N


class PubKey(_PubKey):
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != PUB_KEY_SIZE:
            raise ValueError(f"secp256k1 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(data)

    def address(self) -> bytes:
        return hashlib.new("ripemd160", hashlib.sha256(self._bytes).digest()).digest()

    def bytes(self) -> bytes:
        return self._bytes

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_LENGTH:
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if r <= 0 or s <= 0 or r >= N:
            return False
        if s > N // 2:  # not lower-S (nocgo:35,41-44)
            return False
        return _weierstrass.verify_digest(
            _weierstrass.decompress(self._bytes), hashlib.sha256(msg).digest(), r, s
        )

    def type(self) -> str:
        return KEY_TYPE


class PrivKey(_PrivKey):
    __slots__ = ("_bytes", "_d")

    def __init__(self, data: bytes):
        if len(data) != PRIV_KEY_SIZE:
            raise ValueError(f"secp256k1 privkey must be {PRIV_KEY_SIZE} bytes")
        self._bytes = bytes(data)
        self._d = int.from_bytes(data, "big")
        if not (0 < self._d < N):
            raise ValueError("invalid secp256k1 scalar")

    def sign(self, msg: bytes) -> bytes:
        # RFC 6979 nonces as btcec (nocgo:20-32): one (key, msg), one signature
        r, s = _weierstrass.sign_digest(self._d, hashlib.sha256(msg).digest())
        if s > N // 2:  # normalize to lower-S
            s = N - s
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")

    def pub_key(self) -> PubKey:
        return PubKey(_weierstrass.compress(_weierstrass.scalar_mult(self._d, _weierstrass.G)))

    def bytes(self) -> bytes:
        return self._bytes

    def type(self) -> str:
        return KEY_TYPE


def gen_priv_key() -> PrivKey:
    while True:
        cand = os.urandom(PRIV_KEY_SIZE)
        if 0 < int.from_bytes(cand, "big") < N:
            return PrivKey(cand)
