"""Pure-Python secp256k1 (short Weierstrass) arithmetic and ECDSA.

Counterpart: tendermint_tpu/crypto/_weierstrass.py. The semantics oracle
of the secp256k1 lane: the device kernel (ops/secp_verify.py,
csrc/secp256k1.cu) is held to it, and it is the port's only secp256k1
signer and host verifier (the machine with the card has no
`cryptography` wheel).

Semantics match the reference's btcec configuration
(crypto/secp256k1/secp256k1_nocgo.go:20-54):
  - signing is RFC 6979 deterministic (SHA-256 for both the message
    digest and the nonce HMAC), normalized to lower-S by the caller
    (crypto/secp256k1.py), byte-identical to OpenSSL's
    `deterministic_signing=True` path;
  - verification is plain ECDSA over SHA256(msg); the lower-S and range
    checks on (r, s) live in the caller (secp256k1.PubKey).

Points are affine (x, y) tuples; the identity is None. Modular inversion
by pow(x, -1, p) keeps every formula one line: this is an oracle, not a
hot path.
"""

from __future__ import annotations

import hashlib
import hmac
from typing import Optional, Tuple

# Field prime, curve order, and base point (SEC 2 v2, §2.4.1).
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B = 7  # y^2 = x^3 + 7

Point = Optional[Tuple[int, int]]

G: Point = (GX, GY)


def point_add(p: Point, q: Point) -> Point:
    """Affine addition, complete over all inputs (identity = None)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % P == 0:  # q == -p (covers y == 0 doubling too)
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def point_neg(p: Point) -> Point:
    if p is None:
        return None
    x, y = p
    return (x, (P - y) % P)


def scalar_mult(k: int, p: Point) -> Point:
    k %= N
    q: Point = None
    while k > 0:
        if k & 1:
            q = point_add(q, p)
        p = point_add(p, p)
        k >>= 1
    return q


def on_curve(p: Point) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B) % P == 0


def decompress(pub: bytes) -> Point:
    """33-byte SEC1 compressed point -> affine point, or None if invalid.

    Matches OpenSSL's from_encoded_point acceptance: prefix 02/03,
    x < p, and x^3 + 7 must be a quadratic residue. p ≡ 3 (mod 4), so
    the candidate root is rhs^((p+1)/4) and one squaring checks it.
    """
    if len(pub) != 33 or pub[0] not in (2, 3):
        return None
    x = int.from_bytes(pub[1:], "big")
    if x >= P:
        return None
    rhs = (x * x * x + B) % P
    y = pow(rhs, (P + 1) // 4, P)
    if y * y % P != rhs:
        return None
    if (y & 1) != (pub[0] & 1):
        y = P - y
    return (x, y)


def compress(p: Point) -> bytes:
    assert p is not None
    x, y = p
    return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")


def _rfc6979_nonce(x: bytes, h1: bytes, retry: int) -> int:
    """RFC 6979 §3.2 deterministic nonce (SHA-256; qlen == hlen == 256,
    so bits2int is the identity). `retry` extra K-update rounds handle
    the (astronomically rare) out-of-range / r==0 / s==0 candidates."""
    h2o = (int.from_bytes(h1, "big") % N).to_bytes(32, "big")  # bits2octets
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h2o, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h2o, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 0 < cand < N and retry == 0:
            return cand
        if 0 < cand < N:
            retry -= 1
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign_digest(d: int, digest: bytes) -> Tuple[int, int]:
    """ECDSA over a 32-byte digest with the RFC 6979 nonce; returns the
    raw (r, s) pair — lower-S normalization is the caller's concern."""
    e = int.from_bytes(digest, "big") % N
    x = d.to_bytes(32, "big")
    retry = 0
    while True:
        nonce = _rfc6979_nonce(x, digest, retry)
        pt = scalar_mult(nonce, G)
        assert pt is not None
        r = pt[0] % N
        if r != 0:
            s = (e + r * d) * pow(nonce, -1, N) % N
            if s != 0:
                return r, s
        retry += 1  # pragma: no cover


def verify_digest(pub_point: Point, digest: bytes, r: int, s: int) -> bool:
    """Plain ECDSA verify: R' = (e/s)G + (r/s)Q, accept iff R'.x ≡ r (mod n).
    Range checks on (r, s) are the caller's concern."""
    if pub_point is None or not on_curve(pub_point):
        return False
    e = int.from_bytes(digest, "big") % N
    w = pow(s, -1, N)
    rp = point_add(
        scalar_mult(e * w % N, G), scalar_mult(r * w % N, pub_point)
    )
    if rp is None:
        return False
    return rp[0] % N == r % N
