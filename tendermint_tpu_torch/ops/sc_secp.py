"""Scalars mod n (the secp256k1 group order) and the GLV split, on the host.

Counterpart: tendermint_tpu/ops/sc_secp.py. ECDSA's scalar work (s^-1
mod n, u1 = e/s, u2 = r/s) is a few 256-bit operations a signature
outside the ladder, so it stays Python ints: one batched inversion (the
Montgomery product trick), the GLV split that halves the ladder, and
the packing of the split scalars into the kernel's rows.

GLV: secp256k1 has the endomorphism phi(x, y) = (beta x, y) = [lambda]P
(beta^3 = 1 mod p, lambda^3 = 1 mod n). Any u splits as u = k1 + k2
lambda (mod n) with |k1|, |k2| < 2^129, so the kernel's joint ladder
runs 130 iterations over four half-width scalars instead of 256 over two
full-width ones. The constants are libsecp256k1's lattice basis; the
lattice identities are asserted at import.

The kernel's scalar rows are 32-bit words (the JAX package's are 13-bit
limbs): scalars_to_limbs packs each magnitude into 5 words, least
significant first.
"""

from __future__ import annotations

import numpy as np

from ..crypto._weierstrass import N

N_HALF = N // 2  # lower-S bound: valid signatures have s <= N_HALF

# phi(P) = (BETA x, y) = [LAMBDA]P for every P on the curve
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE

# basis v1 = (A1, -B1), v2 = (A2, B2) of {(x, y) : x + y lambda = 0 mod n}
A1 = 0x3086D221A7D46BCDE86C90E49284EB15
B1 = 0xE4437ED6010E88286F547FA90ABFE4C3
A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
B2 = A1

# both basis vectors annihilate lambda mod n: the split rests on these
assert (A1 - B1 * LAMBDA) % N == 0
assert (A2 + B2 * LAMBDA) % N == 0

SCALAR_BITS = 130  # split magnitudes are below 2^129; one bit of headroom
SCALAR_WORDS = 5  # ceil(130 / 32)


def glv_split(u: int) -> tuple:
    """u in [0, n) -> SIGNED (k1, k2) with u = k1 + k2 lambda (mod n) and
    |k1|, |k2| < 2^129 (Babai rounding on the basis above)."""
    c1 = (B2 * u + (N >> 1)) // N
    c2 = (B1 * u + (N >> 1)) // N
    k1 = u - c1 * A1 - c2 * A2
    k2 = c1 * B1 - c2 * B2
    return k1, k2


def glv_decompose(u: int) -> tuple:
    """u -> (|k1|, sign1, |k2|, sign2); a sign of 1 negates the base point
    on the device."""
    k1, k2 = glv_split(u)
    m1, m2 = abs(k1), abs(k2)
    if m1 >> SCALAR_BITS or m2 >> SCALAR_BITS:  # pragma: no cover
        raise AssertionError("GLV split exceeded 130 bits")
    return m1, int(k1 < 0), m2, int(k2 < 0)


def inv_mod_n_many(vals: list) -> list:
    """Inverses mod n of vals, one pow and three products an element by
    the Montgomery trick. A zero passes through as 0 (its row is already
    rejected)."""
    idx = [i for i, v in enumerate(vals) if v]
    out = [0] * len(vals)
    if not idx:
        return out
    prefix = []
    acc = 1
    for i in idx:
        prefix.append(acc)
        acc = acc * vals[i] % N
    inv = pow(acc, -1, N)
    for j in reversed(range(len(idx))):
        i = idx[j]
        out[i] = prefix[j] * inv % N
        inv = inv * vals[i] % N
    return out


def scalars_to_limbs(vals: list) -> np.ndarray:
    """Nonnegative ints below 2^160 -> (len(vals), 5) int32 rows of 32-bit
    words, least significant first (the bit pattern: a word at or above
    2^31 reads negative)."""
    if not vals:
        return np.zeros((0, SCALAR_WORDS), dtype=np.int32)
    buf = b"".join(v.to_bytes(4 * SCALAR_WORDS, "little") for v in vals)
    return np.frombuffer(buf, dtype="<i4").reshape(len(vals), SCALAR_WORDS).copy()
