"""Edwards25519 point arithmetic and byte unpacking — plain PyTorch.

Counterpart: tendermint_tpu/ops/pallas_verify.py:90-220 (the point
functions the Pallas kernels share). Points are 4-tuples of (20, B)
limb tensors: extended (X, Y, Z, T), or Niels (Y+X, Y-X, Z, 2dT) for
table entries. csrc/fe25519.cuh mirrors each function.
"""

from __future__ import annotations

import torch

from ..crypto import _edwards
from . import fe

NL = fe.NLIMBS


def point_add(p, q):
    """Unified extended-coordinates addition (a = -1)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = fe.mul(fe.sub(y1, x1), fe.sub(y2, x2))
    b = fe.mul(fe.add(y1, x1), fe.add(y2, x2))
    c = fe.mul(fe.mul(t1, fe.from_int(_edwards.D2, t1)), t2)
    zz = fe.mul(z1, z2)
    d = fe.add(zz, zz)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def point_double(p, need_t: bool = True):
    """Doubling never reads T; need_t=False also skips producing it."""
    x1, y1, z1 = p[0], p[1], p[2]
    a = fe.sq(x1)
    b = fe.sq(y1)
    zz = fe.sq(z1)
    c = fe.add(zz, zz)
    e = fe.sub(fe.sub(fe.sq(fe.add(x1, y1)), a), b)
    g = fe.sub(b, a)
    f = fe.sub(g, c)
    h = fe.neg(fe.add(a, b))
    t = fe.mul(e, h) if need_t else torch.zeros_like(x1)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), t)


def point_neg(p):
    x, y, z, t = p
    return (fe.neg(x), y, z, fe.neg(t))


def to_niels(p):
    """Extended (X, Y, Z, T) -> Niels (Y+X, Y-X, Z, T*2d)."""
    x, y, z, t = p
    return (fe.add(y, x), fe.sub(y, x), z, fe.mul(t, fe.from_int(_edwards.D2, t)))


def point_add_niels(p, q, need_t: bool = True):
    """Extended accumulator + Niels table entry; need_t=False skips T
    where the consumer never reads it."""
    x1, y1, z1, t1 = p
    yplusx2, yminusx2, z2, t2d2 = q
    a = fe.mul(fe.sub(y1, x1), yminusx2)
    b = fe.mul(fe.add(y1, x1), yplusx2)
    c = fe.mul(t1, t2d2)
    zz = fe.mul(z1, z2)
    d = fe.add(zz, zz)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    t = fe.mul(e, h) if need_t else torch.zeros_like(x1)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), t)


def sqrt_ratio(u, v):
    """(ok (1, B) bool, r): v r^2 = u, or v r^2 = -u (ZIP-215 accepts
    check == -u as the RFC 8032 sqrt(-1) branch)."""
    v3 = fe.mul(fe.sq(v), v)
    v7 = fe.mul(fe.sq(v3), v)
    r = fe.mul(fe.mul(u, v3), fe.pow22523(fe.mul(u, v7)))
    check = fe.mul(v, fe.sq(r))
    ok_pos = fe.eq(check, u)
    ok_neg = fe.is_zero(fe.add(check, u))
    r = torch.where(ok_pos, r, fe.mul(r, fe.from_int(_edwards.SQRT_M1, r)))
    return ok_pos | ok_neg, r


def decompress(y_limbs, sign):
    """ZIP-215 decompression of (20, B) y limbs (low 255 bits of the
    encoding, not reduced: non-canonical y is accepted) and (1, B) sign
    bits. The sign flip uses the canonical x. Returns (ok (1, B) bool,
    (x, y, z, t))."""
    one = fe.from_int(1, y_limbs)
    y = fe.carry(y_limbs)
    yy = fe.sq(y)
    u = fe.sub(yy, one)
    v = fe.add(fe.mul(fe.from_int(_edwards.D, y), yy), one)
    ok, x = sqrt_ratio(u, v)
    x = fe.canon(x)
    flip = (x[0:1] & 1) != sign
    x = torch.where(flip, fe.neg(x), x)
    t = fe.mul(x, y)
    z = one.expand_as(y).clone()
    return ok, (x, y, z, t)


def ristretto_decode(s_limbs, ok_host):
    """ristretto255 DECODE (pallas_sr25519._ristretto_decode) of (20, B)
    limbs of s, the low 255 bits of the encoding; the host has checked it
    canonical (s < p) and even and passes that as ok_host (1, B). x and t
    are made canonical before their parity is read. Returns (ok (1, B)
    bool, (x, y, z, t)); 1 + s^2 = 0 makes sqrt_ratio(1, 0) not square
    and y = 0, and rejects."""
    one = fe.from_int(1, s_limbs)
    s = fe.carry(s_limbs)
    ss = fe.sq(s)
    u1 = fe.sub(one, ss)  # 1 - s^2
    u2 = fe.add(one, ss)  # 1 + s^2
    u2_sqr = fe.sq(u2)
    # v = -(D * u1^2) - u2^2
    v = fe.sub(fe.neg(fe.mul(fe.from_int(_edwards.D, s), fe.sq(u1))), u2_sqr)
    # invsqrt(v * u2^2): sqrt_ratio(1, x) gives r with x r^2 == 1 when square
    was_square, invsq = sqrt_ratio(one.expand_as(s), fe.mul(v, u2_sqr))
    den_x = fe.mul(invsq, u2)
    den_y = fe.mul(fe.mul(invsq, den_x), v)
    x = fe.canon(fe.mul(fe.add(s, s), den_x))
    x = torch.where((x[0:1] & 1) != 0, fe.neg(x), x)  # |x|
    y = fe.mul(u1, den_y)
    t = fe.mul(x, y)
    t_odd = (fe.canon(t)[0:1] & 1) != 0
    ok = was_square & ~t_odd & ~fe.is_zero(y) & (ok_host != 0)
    z = one.expand_as(y).clone()
    return ok, (x, y, z, t)


def slot_rows(p: int, c: int) -> slice:
    """Rows of coordinate c of point p (or table entry p) in a global
    array's 32-row slots."""
    base = (p * 4 + c) * 32
    return slice(base, base + fe.NLIMBS)


def cat_points(points):
    """Points side by side along the batch axis (one lane-folded op)."""
    return tuple(torch.cat([p[c] for p in points], dim=1) for c in range(4))


def slice_point(pt, i: int, n: int):
    """The i-th block of n columns of a lane-folded point."""
    return tuple(c[:, i * n : (i + 1) * n] for c in pt)


def unpack_limbs(enc32):
    """(32, B) int32 bytes of a little-endian encoding -> ((20, B) limbs
    of the low 255 bits, (1, B) sign bit)."""
    b = enc32
    sign = b[31:32] >> 7
    b31 = b[31] & 0x7F
    rows = []
    for i in range(NL):
        lo_bit = fe.RADIX * i
        byte0, shift = lo_bit >> 3, lo_bit & 7

        def byte(k):
            return b31 if k == 31 else b[k]

        v = byte(byte0)
        if byte0 + 1 < 32:
            v = v + (byte(byte0 + 1) << 8)
        if byte0 + 2 < 32 and shift + fe.RADIX > 16:
            v = v + (byte(byte0 + 2) << 16)
        rows.append((v >> shift) & fe.MASK)
    return torch.stack(rows, dim=0), sign


def unpack_digits2_grouped(enc32):
    """(32, B) int32 scalar bytes (< 2^253) -> (128, B) base-4 digits in
    the shift-grouped order of pallas_verify: digit t (bits 2t, 2t+1,
    both in byte t >> 2) at row (t & 3) * 32 + (t >> 2)."""
    return torch.cat([(enc32 >> s) & 3 for s in (0, 2, 4, 6)], dim=0)


def digit_row(t: int) -> int:
    """Row of digit t in the shift-grouped order."""
    return (t & 3) * 32 + (t >> 2)
