"""ristretto255 group on edwards25519 — sr25519's curve group.

Counterpart: tendermint_tpu/crypto/_ristretto.py, copied whole. The
pure-Python oracle (like _edwards for ed25519): decode/encode per the
ristretto255 spec (draft-irtf-cfrg-ristretto255); the arithmetic reuses
the extended-coordinate point functions of _edwards. The device kernels
(csrc/sr25519.cu) are held to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

from . import _edwards as E

P = E.P
D = E.D
SQRT_M1 = E.SQRT_M1

# 1/sqrt(a - d) with a = -1 (ristretto encode constant)
INVSQRT_A_MINUS_D = 0

Point = Tuple[int, int, int, int]


def _is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def _invsqrt(u: int) -> Tuple[bool, int]:
    """(was_square, 1/sqrt(u)); for u=0 returns (True, 0)."""
    if u % P == 0:
        return True, 0
    r = E._sqrt_ratio(1, u)
    if r is not None:
        return True, r % P
    # not a square: sqrt(i/u)
    r = E._sqrt_ratio(SQRT_M1, u)
    return False, (r % P) if r is not None else 0


def _compute_constants():
    global INVSQRT_A_MINUS_D
    a = P - 1
    _, inv = _invsqrt((a - D) % P)
    INVSQRT_A_MINUS_D = inv


_compute_constants()


def decode(b: bytes) -> Optional[Point]:
    """ristretto255 DECODE."""
    if len(b) != 32:
        return None
    s = int.from_bytes(b, "little")
    if s >= P or _is_negative(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    ok, invsq = _invsqrt(v * u2_sqr % P)
    den_x = invsq * u2 % P
    den_y = invsq * den_x % P * v % P
    x = (s + s) % P * den_x % P
    if _is_negative(x):
        x = P - x
    y = u1 * den_y % P
    t = x * y % P
    if not ok or _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def encode(pt: Point) -> bytes:
    """ristretto255 ENCODE."""
    x0, y0, z0, t0 = pt
    u1 = (z0 + y0) * (z0 - y0) % P
    u2 = x0 * y0 % P
    _, invsq = _invsqrt(u1 * u2 % P * u2 % P)
    den1 = invsq * u1 % P
    den2 = invsq * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    if _is_negative(t0 * z_inv % P):
        x = y0 * SQRT_M1 % P
        y = x0 * SQRT_M1 % P
        den_inv = den1 * INVSQRT_A_MINUS_D % P
    else:
        x = x0
        y = y0
        den_inv = den2
    if _is_negative(x * z_inv % P):
        y = (P - y) % P
    s = den_inv * ((z0 - y) % P) % P
    if _is_negative(s):
        s = P - s
    return s.to_bytes(32, "little")


def equals(a: Point, b: Point) -> bool:
    """Ristretto equality: x1 y2 == y1 x2 or y1 y2 == x1 x2."""
    x1, y1, _, _ = a
    x2, y2, _, _ = b
    return (x1 * y2 - y1 * x2) % P == 0 or (y1 * y2 - x1 * x2) % P == 0


BASE: Point = E.BASE
IDENTITY: Point = E.IDENTITY
add = E.point_add
neg = E.point_neg
scalar_mult = E.scalar_mult
L = E.L
