"""Pure-Python edwards25519 arithmetic and ZIP-215 ed25519 verification.

Counterpart: tendermint_tpu/crypto/_edwards.py, copied whole. It is the
semantics oracle for the port's kernels (ops/rlc.py): slow,
obviously-correct big-int math used for differential testing, for the
host path below the device threshold, and for per-signature blame.

Semantics match the reference's curve25519-voi configuration
(crypto/ed25519/ed25519.go:23-31, VerifyOptionsZIP_215):
  - A (pubkey) and R (sig[:32]) decode per RFC 8032 §5.1.3 decompression
    *without* the canonical-y check (y is reduced mod p), i.e. non-canonical
    encodings are accepted;
  - small-order / mixed-order points are accepted;
  - s (sig[32:]) must be canonical: 0 <= s < L;
  - the verification equation is cofactored: [8]([s]B - R - [k]A) == O,
    with k = SHA512(R || A || msg) mod L.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

# Field and group parameters for edwards25519 (RFC 7748 / RFC 8032).
P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1), p ≡ 5 (mod 8)

# Extended homogeneous coordinates (X, Y, Z, T): x = X/Z, y = Y/Z, x*y = T/Z.
Point = Tuple[int, int, int, int]

IDENTITY: Point = (0, 1, 1, 0)

# Base point: y = 4/5, x recovered with even parity... sign bit 0 per RFC 8032.
_by = (4 * pow(5, P - 2, P)) % P


def _sqrt_ratio(u: int, v: int) -> Optional[int]:
    """Return r with v*r^2 == u (mod p), or None if u/v is not a square.

    Uses the p ≡ 5 (mod 8) trick: candidate r = u*v^3 * (u*v^7)^((p-5)/8);
    correct by sqrt(-1) if needed (RFC 8032 §5.1.3 step 3).
    """
    v3 = (v * v % P) * v % P
    v7 = (v3 * v3 % P) * v % P
    r = (u * v3 % P) * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    if check == u % P:
        return r
    if check == (P - u) % P:
        return r * SQRT_M1 % P
    return None


def decompress(s: bytes, allow_noncanonical: bool = True) -> Optional[Point]:
    """Decode a 32-byte point encoding -> extended point, or None.

    ZIP-215 mode (allow_noncanonical=True) follows curve25519-dalek's
    decompression (which ZIP 215 specifies and curve25519-voi implements):
    the y < p canonicity check is skipped AND the RFC 8032 §5.1.3 step-4
    rule ("x = 0 with sign bit 1 fails") is dropped — a conditional negate
    of x = 0 is a no-op, so "negative zero" encodings decode to x = 0.
    Strict mode applies both RFC 8032 checks.
    """
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little") & ((1 << 255) - 1)
    sign = s[31] >> 7
    if not allow_noncanonical and y >= P:
        return None
    y %= P
    yy = y * y % P
    u = (yy - 1) % P
    v = (D * yy + 1) % P
    x = _sqrt_ratio(u, v)
    if x is None:
        return None
    if x == 0 and sign and not allow_noncanonical:
        return None
    if (x & 1) != sign:
        x = P - x
    return (x, y, 1, x * y % P)


def compress(pt: Point) -> bytes:
    x, y, z, _ = pt
    zi = pow(z, P - 2, P)
    x = x * zi % P
    y = y * zi % P
    s = y | ((x & 1) << 255)
    return s.to_bytes(32, "little")


def point_add(p: Point, q: Point) -> Point:
    """Unified addition (add-2008-hwcd-3 with a=-1); complete for all inputs
    since a=-1 is square and d is non-square mod p."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 % P * t2 % P
    d = 2 * z1 * z2 % P
    e = b - a
    f = d - c
    g = d + c
    h = b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_double(p: Point) -> Point:
    """Dedicated doubling (dbl-2008-hwcd, a=-1)."""
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    d = (-a) % P
    e = ((x1 + y1) * (x1 + y1) - a - b) % P
    g = (d + b) % P
    f = (g - c) % P
    h = (d - b) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_neg(p: Point) -> Point:
    x, y, z, t = p
    return ((P - x) % P, y, z, (P - t) % P)


def scalar_mult(k: int, p: Point) -> Point:
    q = IDENTITY
    while k > 0:
        if k & 1:
            q = point_add(q, p)
        p = point_double(p)
        k >>= 1
    return q


def point_equal(p: Point, q: Point) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def is_identity(p: Point) -> bool:
    x, y, z, _ = p
    return x % P == 0 and (y - z) % P == 0


_bu = (_by * _by - 1) % P
_bv = (D * _by % P * _by + 1) % P
_bx = _sqrt_ratio(_bu, _bv)
assert _bx is not None
if _bx & 1:
    _bx = P - _bx
BASE: Point = (_bx, _by, 1, _bx * _by % P)


def mult_by_cofactor(p: Point) -> Point:
    return point_double(point_double(point_double(p)))


def challenge_scalar(r_enc: bytes, a_enc: bytes, msg: bytes) -> int:
    """k = SHA512(R || A || M) mod L (RFC 8032 verify step)."""
    h = hashlib.sha512(r_enc + a_enc + msg).digest()
    return int.from_bytes(h, "little") % L


def verify_zip215(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 single-signature verification (the oracle).

    Matches curve25519-voi VerifyWithOptions(..., VerifyOptionsZIP_215) as
    used at crypto/ed25519/ed25519.go:167.
    """
    if len(pub) != 32 or len(sig) != 64:
        return False
    a = decompress(pub)
    if a is None:
        return False
    r = decompress(sig[:32])
    if r is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = challenge_scalar(sig[:32], pub, msg)
    # [8]([s]B - R - [k]A) == O
    sb = scalar_mult(s, BASE)
    ka = scalar_mult(k, a)
    diff = point_add(sb, point_neg(point_add(r, ka)))
    return is_identity(mult_by_cofactor(diff))


def pubkey_from_seed(seed: bytes) -> bytes:
    """Derive the public key from a 32-byte seed (RFC 8032 §5.1.5)."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return compress(scalar_mult(a, BASE))


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 §5.1.6 signing (byte-identical to OpenSSL's)."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    prefix = h[32:]
    pub = compress(scalar_mult(a, BASE))
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    r_enc = compress(scalar_mult(r, BASE))
    k = challenge_scalar(r_enc, pub, msg)
    s = (r + k * a) % L
    return r_enc + s.to_bytes(32, "little")
