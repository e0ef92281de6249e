"""sr25519 — Schnorr signatures over ristretto255 (schnorrkel flavor).

Counterpart: tendermint_tpu/crypto/sr25519.py (crypto/sr25519/ in the
reference, backed by curve25519-voi's schnorrkel), in pure Python:
  - PrivKey is a 32-byte MiniSecretKey, expanded ExpandEd25519-style
    (SHA-512, ed25519 clamping, divide-by-cofactor) to (scalar, nonce)
  - signing context is "substrate" (crypto/sr25519/signature.go)
  - transcript protocol: merlin "SigningContext" / "Schnorr-sig" framing
  - signatures are R || s with the schnorrkel v1 marker bit (s[31] |= 0x80)
  - verification: R == [s]B - [k]A with k = transcript challenge
Host verification here is the path below the device threshold
(ops/mixed.py) and the oracle the device kernels are held to; the batch
path is ops/sr25519.py.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Tuple

from . import PrivKey as _PrivKey, PubKey as _PubKey, address_hash
from . import _merlin, _ristretto as R

KEY_TYPE = "sr25519"
PUB_KEY_SIZE = 32
PRIV_KEY_SIZE = 32  # MiniSecretKey
SIGNATURE_SIZE = 64

PUB_KEY_NAME = "tendermint/PubKeySr25519"
PRIV_KEY_NAME = "tendermint/PrivKeySr25519"

SIGNING_CTX = b"substrate"

L = R.L


def _expand_ed25519(mini: bytes) -> Tuple[int, bytes]:
    """MiniSecretKey.ExpandEd25519: (scalar, nonce)."""
    h = hashlib.sha512(mini).digest()
    key = bytearray(h[:32])
    key[0] &= 248
    key[31] &= 63
    key[31] |= 64
    # divide by cofactor: right-shift the 256-bit LE integer by 3
    scalar = int.from_bytes(bytes(key), "little") >> 3
    return scalar % L, h[32:]


def _signing_transcript(msg: bytes) -> "_merlin.Transcript":
    t = _merlin.Transcript(b"SigningContext")
    t.append_message(b"", SIGNING_CTX)
    t.append_message(b"sign-bytes", msg)
    return t


def _challenge_scalar(t: "_merlin.Transcript", label: bytes) -> int:
    return int.from_bytes(t.challenge_bytes(label, 64), "little") % L


def sign(mini: bytes, msg: bytes) -> bytes:
    scalar, nonce = _expand_ed25519(mini)
    pub_pt = R.scalar_mult(scalar, R.BASE)
    pub = R.encode(pub_pt)
    t = _signing_transcript(msg)
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pub)
    r = int.from_bytes(t.witness_bytes(b"signing", [nonce], 64), "little") % L
    r_enc = R.encode(R.scalar_mult(r, R.BASE))
    t.append_message(b"sign:R", r_enc)
    k = _challenge_scalar(t, b"sign:c")
    s = (k * scalar + r) % L
    sig = bytearray(r_enc + s.to_bytes(32, "little"))
    sig[63] |= 0x80  # schnorrkel v1 marker
    return bytes(sig)


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != SIGNATURE_SIZE or len(pub) != PUB_KEY_SIZE:
        return False
    if not (sig[63] & 0x80):
        return False  # not a schnorrkel v1 signature
    a_pt = R.decode(pub)
    if a_pt is None:
        return False
    r_bytes = sig[:32]
    r_pt = R.decode(r_bytes)
    if r_pt is None:
        return False
    s_bytes = bytearray(sig[32:])
    s_bytes[31] &= 0x7F
    s = int.from_bytes(bytes(s_bytes), "little")
    if s >= L:
        return False
    t = _signing_transcript(msg)
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pub)
    t.append_message(b"sign:R", r_bytes)
    k = _challenge_scalar(t, b"sign:c")
    # R == [s]B - [k]A
    sb = R.scalar_mult(s, R.BASE)
    ka = R.scalar_mult(k, a_pt)
    expected = R.add(sb, R.neg(ka))
    return R.equals(expected, r_pt)


class PubKey(_PubKey):
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != PUB_KEY_SIZE:
            raise ValueError(f"sr25519 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(data)

    def address(self) -> bytes:
        return address_hash(self._bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        return verify(self._bytes, msg, sig)

    def type(self) -> str:
        return KEY_TYPE


class PrivKey(_PrivKey):
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != PRIV_KEY_SIZE:
            raise ValueError(f"sr25519 privkey must be {PRIV_KEY_SIZE} bytes")
        self._bytes = bytes(data)

    def sign(self, msg: bytes) -> bytes:
        return sign(self._bytes, msg)

    def pub_key(self) -> PubKey:
        scalar, _ = _expand_ed25519(self._bytes)
        return PubKey(R.encode(R.scalar_mult(scalar, R.BASE)))

    def bytes(self) -> bytes:
        return self._bytes

    def type(self) -> str:
        return KEY_TYPE


def verify_batch(entries: List[Tuple[bytes, bytes, bytes]]) -> List[bool]:
    """Per-signature verdicts for (pub, msg, sig) triples, on the host."""
    return [verify(p, m, s) for p, m, s in entries]


def gen_priv_key(seed: bytes | None = None) -> PrivKey:
    return PrivKey(seed if seed is not None else os.urandom(PRIV_KEY_SIZE))

