"""BLS12-381 minimal-pubkey signatures, in pure Python.

Counterpart: tendermint_tpu/crypto/bls12381.py, copied with its
arithmetic unchanged. Keys live in G1 (48 bytes compressed), signatures
in G2 (96 bytes), so an aggregated commit ships one signature and a
signer bitmap and verifies with one pairing check

    e(apk, H(m)) == e(g1, sigma),   apk = the sum of the signers' keys

("Performance of EdDSA and BLS Signatures in Committee-Based Consensus",
arXiv 2302.00418). This module is the oracle the device lane
(ops/bls_verify.py, csrc/bls12381.cu) is held to, and the path of a
single aggregated commit (types/validation.verify_aggregated_commit).

Everything is int and tuple arithmetic:

  - Fp is ints mod P; Fp2 = Fp[u]/(u^2 + 1) as (c0, c1) tuples.
  - Curve points are affine tuples, None the point at infinity; a
    scalar multiplication pays a field inversion a step.
  - Compression is the ZCash format (bit 7 compressed, bit 6 infinity,
    bit 5 the larger y; G2 writes c1 || c0).
  - hash-to-G2 is try-and-increment and cofactor clearing by h_eff
    (RFC 9380 8.8.2), not the SSWU suite, with the package's own DST.
  - The pairing uses the flat tower Fp12 = Fp2[w]/(w^6 - XI), XI = 1 + u
    (the layout the device kernels evaluate), and a brute-force final
    exponentiation f^((P^12 - 1) / R).

g2_prepare, the line coefficients of a G2 point, is shared with the
device lane: the host runs the ate loop over the G2 point once and
emits a uniform schedule of 63 steps of [double, add] (lambda, c) Fp2
pairs, a skipped add carrying (0, 0), whose line is the Fp2 scalar
XI*yP that the final exponentiation kills. The device only evaluates
and accumulates.

Not ported: fast_aggregate_verify_batch and its host thread pool
(TM_TPU_BLS_HOST_POOL_MIN), which move batches off the device.
"""

from __future__ import annotations

import functools
import hashlib
import os

from . import PrivKey as _PrivKey, PubKey as _PubKey, address_hash

KEY_TYPE = "bls12381"
PUB_KEY_SIZE = 48
PRIV_KEY_SIZE = 32
SIGNATURE_LENGTH = 96

PUB_KEY_NAME = "tendermint/PubKeyBls12381"
PRIV_KEY_NAME = "tendermint/PrivKeyBls12381"

# Base field prime (381 bits) and the prime subgroup order r (255 bits).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# The BLS parameter x (negative): p = (x-1)^2 (x^4 - x^2 + 1)/3 + x.
X_ABS = 0xD201000000010000
X_NEG = True  # x < 0: the ate Miller value is conjugated at the end

# E: y^2 = x^3 + 4 over Fp; E': y^2 = x^3 + 4*XI over Fp2, XI = 1 + u
# (M-twist). B3 = 3*b = 12 is the RCB complete-formula constant the
# device G1 adder uses.
B = 4
B3 = 12

GX = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
GY = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G1_GEN = (GX, GY)

G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# G2 cofactor-clearing exponent h_eff (RFC 9380 8.8.2).
H_EFF = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551

# Custom domain separator — see the module docstring on hash-to-G2.
DST = b"TM_TPU_BLS12381G2_HAI_POP_"

# Full final-exponentiation exponent (brute force; ~4313 bits).
FINAL_EXP = (P**12 - 1) // R

_INV2 = pow(2, P - 2, P)
_SQRT_EXP = (P + 1) // 4  # p = 3 mod 4

# ---- Fp2 = Fp[u]/(u^2 + 1) --------------------------------------------------

F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (1, 1)  # 1 + u


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return (-a[0] % P, -a[1] % P)


def f2_mul(a, b):
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2_sqr(a):
    return f2_mul(a, a)


def f2_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


def f2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ni = pow(norm, P - 2, P)
    return (a[0] * ni % P, -a[1] * ni % P)


def f2_mul_xi(a):
    """(1+u)*(c0 + c1 u) = (c0 - c1) + (c0 + c1) u."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def fp_sqrt(a):
    """Square root in Fp (p = 3 mod 4), or None."""
    s = pow(a, _SQRT_EXP, P)
    return s if s * s % P == a % P else None


def f2_sqrt(a):
    """Square root in Fp2 via the norm method, or None."""
    a0, a1 = a[0] % P, a[1] % P
    if a1 == 0:
        s = fp_sqrt(a0)
        if s is not None:
            return (s, 0)
        # -1 is a non-residue (p = 3 mod 4): -a0 must be square, and
        # (y*u)^2 = -y^2 = a0.
        s = fp_sqrt(-a0 % P)
        return None if s is None else (0, s)
    s = fp_sqrt((a0 * a0 + a1 * a1) % P)
    if s is None:
        return None
    for cand in (s, -s % P):
        t = (a0 + cand) * _INV2 % P
        x0 = fp_sqrt(t)
        if x0 is None or x0 == 0:
            continue
        x1 = a1 * pow(2 * x0, P - 2, P) % P
        if (x0 * x0 - x1 * x1) % P == a0 and 2 * x0 * x1 % P == a1:
            return (x0, x1)
    return None


# ---- curve arithmetic (affine, None = infinity) -----------------------------


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_neg(p1):
    return None if p1 is None else (p1[0], -p1[1] % P)


def g1_mul(k, p1):
    # No k % R reduction: the subgroup checks multiply by R itself, and
    # reducing first would turn them into `[0]P is None` — vacuously
    # true for EVERY on-curve point (reduction is only sound once p1 is
    # already known to have order R).
    acc = None
    for bit in bin(k)[2:]:
        acc = g1_add(acc, acc)
        if bit == "1":
            acc = g1_add(acc, p1)
    return acc


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sqr(lam), x1), x2)
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def g2_neg(p1):
    return None if p1 is None else (p1[0], f2_neg(p1[1]))


def g2_mul(k, p1):
    acc = None
    for bit in bin(k)[2:]:
        acc = g2_add(acc, acc)
        if bit == "1":
            acc = g2_add(acc, p1)
    return acc


def g1_on_curve(p1):
    if p1 is None:
        return True
    x, y = p1
    return y * y % P == (x * x * x + B) % P


def g2_on_curve(p1):
    if p1 is None:
        return True
    x, y = p1
    return f2_sqr(y) == f2_add(f2_mul(x, f2_sqr(x)), f2_scalar(XI, B))


def g1_in_subgroup(p1):
    return g1_on_curve(p1) and g1_mul(R, p1) is None


def g2_in_subgroup(p1):
    return g2_on_curve(p1) and g2_mul(R, p1) is None


# ---- serialization (ZCash compressed format) --------------------------------

_HALF = (P - 1) // 2


def _fp_larger(y):
    return y > _HALF


def _f2_larger(y):
    return _fp_larger(y[1]) if y[1] else _fp_larger(y[0])


def g1_compress(p1) -> bytes:
    if p1 is None:
        return bytes([0xC0]) + bytes(47)
    buf = bytearray(p1[0].to_bytes(48, "big"))
    buf[0] |= 0x80 | (0x20 if _fp_larger(p1[1]) else 0)
    return bytes(buf)


def g1_decompress(data: bytes):
    """48-byte compressed G1 -> affine point / None (infinity), or the
    string "bad" on any malformed encoding (so callers can pin blame
    without exceptions)."""
    if len(data) != PUB_KEY_SIZE or not data[0] & 0x80:
        return "bad"
    if data[0] & 0x40:
        if data[0] != 0xC0 or any(data[1:]):
            return "bad"
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        return "bad"
    y = fp_sqrt((x * x * x + B) % P)
    if y is None:
        return "bad"
    if _fp_larger(y) != bool(data[0] & 0x20):
        y = -y % P
    return (x, y)


def g2_compress(p1) -> bytes:
    if p1 is None:
        return bytes([0xC0]) + bytes(95)
    x, y = p1
    buf = bytearray(x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big"))
    buf[0] |= 0x80 | (0x20 if _f2_larger(y) else 0)
    return bytes(buf)


def g2_decompress(data: bytes):
    """96-byte compressed G2 -> affine point / None / "bad" (see
    g1_decompress)."""
    if len(data) != SIGNATURE_LENGTH or not data[0] & 0x80:
        return "bad"
    if data[0] & 0x40:
        if data[0] != 0xC0 or any(data[1:]):
            return "bad"
        return None
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        return "bad"
    x = (x0, x1)
    y = f2_sqrt(f2_add(f2_mul(x, f2_sqr(x)), f2_scalar(XI, B)))
    if y is None:
        return "bad"
    if _f2_larger(y) != bool(data[0] & 0x20):
        y = f2_neg(y)
    return (x, y)


# ---- hash to G2 (try-and-increment + cofactor clearing) ---------------------


def _hash_fp(tag: int, ctr: int, msg: bytes) -> int:
    pre = DST + bytes([tag]) + ctr.to_bytes(4, "big")
    h = hashlib.sha256(pre + b"\x00" + msg).digest()
    h += hashlib.sha256(pre + b"\x01" + msg).digest()
    return int.from_bytes(h, "big") % P


@functools.lru_cache(maxsize=4096)
def hash_to_g2(msg: bytes):
    """Deterministic msg -> G2 subgroup point (never None for real
    inputs: a failure probability of ~2^-255 per candidate)."""
    ctr = 0
    while True:
        x = (_hash_fp(0, ctr, msg), _hash_fp(1, ctr, msg))
        y = f2_sqrt(f2_add(f2_mul(x, f2_sqr(x)), f2_scalar(XI, B)))
        ctr += 1
        if y is None:
            continue
        sign = hashlib.sha256(DST + b"\x02" + msg).digest()[0] & 1
        if _f2_larger(y) != bool(sign):
            y = f2_neg(y)
        q = g2_mul(H_EFF, (x, y))
        if q is not None:
            return q


# ---- pairing ----------------------------------------------------------------
#
# Ate loop schedule: 63 uniform steps, MSB-first over bits 62..0 of |x|
# (bit 63 seeds T = Q). Every step doubles; steps whose bit is set also
# add. The stored row is ((lam_dbl, c_dbl), (lam_add, c_add)) with
# c = lam*x_T - y_T, and (0, 0) for the skipped add — the line then
# degenerates to the unit Fp2 scalar XI*yP (killed by the final exp), so
# oracle and device share one flag-free schedule.

ATE_BITS = tuple((X_ABS >> i) & 1 for i in range(62, -1, -1))
N_ATE = len(ATE_BITS)  # 63


def g2_prepare(q):
    """Ate-loop line coefficients for a G2 point: N_ATE rows of
    ((lam, c)_dbl, (lam, c)_add), each an Fp2 pair."""
    rows = []
    t = q
    for bit in ATE_BITS:
        xt, yt = t
        lam_d = f2_mul(f2_scalar(f2_sqr(xt), 3), f2_inv(f2_scalar(yt, 2)))
        c_d = f2_sub(f2_mul(lam_d, xt), yt)
        t = _g2_add_with_slope(t, t, lam_d)
        if bit:
            xt, yt = t
            lam_a = f2_mul(f2_sub(yt, q[1]), f2_inv(f2_sub(xt, q[0])))
            c_a = f2_sub(f2_mul(lam_a, xt), yt)
            t = _g2_add_with_slope(t, q, lam_a)
        else:
            lam_a, c_a = F2_ZERO, F2_ZERO
        rows.append(((lam_d, c_d), (lam_a, c_a)))
    return rows


def _g2_add_with_slope(p1, p2, lam):
    x3 = f2_sub(f2_sub(f2_sqr(lam), p1[0]), p2[0])
    return (x3, f2_sub(f2_mul(lam, f2_sub(p1[0], x3)), p1[1]))


# Fp12 = Fp2[w]/(w^6 - XI), flat: tuples of 6 Fp2 coefficients. The
# untwist is x = x'*w^4/XI, y = y'*w^3/XI, so a line with twist-side
# slope lam through T evaluated at P = (xP, yP) in G1, scaled by the
# final-exp-killed XI, is   XI*yP + c*w^3 - lam*xP*w^5.

FP12_ONE = (F2_ONE, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO)


def fp12_mul(a, b):
    acc = [F2_ZERO] * 11
    for i in range(6):
        ai = a[i]
        if ai == F2_ZERO:
            continue
        for j in range(6):
            acc[i + j] = f2_add(acc[i + j], f2_mul(ai, b[j]))
    return tuple(
        f2_add(acc[k], f2_mul_xi(acc[k + 6])) if k < 5 else acc[k]
        for k in range(6)
    )


def fp12_conj(a):
    """a^(p^6): w -> -w (negate odd coefficients)."""
    return (a[0], f2_neg(a[1]), a[2], f2_neg(a[3]), a[4], f2_neg(a[5]))


def line_eval(lam, c, xp, yp):
    """The (sparse) Fp12 line value at the G1 point (xp, yp)."""
    return (
        f2_scalar(XI, yp),
        F2_ZERO,
        F2_ZERO,
        c,
        F2_ZERO,
        f2_scalar(lam, -xp % P),
    )


def miller(coeffs, p1):
    """Miller loop: evaluate prepared line coefficients at the G1 point.
    Conjugated at the end for the negative BLS parameter (conj differs
    from the true inverse by an element the final exp kills)."""
    xp, yp = p1
    f = FP12_ONE
    for (lam_d, c_d), (lam_a, c_a) in coeffs:
        f = fp12_mul(f, f)
        f = fp12_mul(f, line_eval(lam_d, c_d, xp, yp))
        f = fp12_mul(f, line_eval(lam_a, c_a, xp, yp))
    return fp12_conj(f) if X_NEG else f


def final_exp(f):
    """f^((p^12-1)/r) by square-and-multiply (see module docstring)."""
    acc = FP12_ONE
    for bit in bin(FINAL_EXP)[2:]:
        acc = fp12_mul(acc, acc)
        if bit == "1":
            acc = fp12_mul(acc, f)
    return acc


def pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 for affine pairs [(G1 pt, G2 pt), ...]:
    one Miller loop per pair, ONE shared final exponentiation."""
    f = FP12_ONE
    for p1, q2 in pairs:
        f = fp12_mul(f, miller(g2_prepare(q2), p1))
    return final_exp(f) == FP12_ONE


# ---- signatures -------------------------------------------------------------


@functools.lru_cache(maxsize=65536)
def pubkey_status(pub: bytes):
    """(point, reason): reason is None for a usable pubkey, else the
    pinned blame suffix ("malformed" / "identity" / "subgroup"). Memoized
    — the per-epoch subgroup check amortizes to zero on the hot path."""
    pt = g1_decompress(bytes(pub))
    if pt == "bad":
        return None, "malformed"
    if pt is None:
        return None, "identity"
    if not g1_mul(R, pt) is None:
        return None, "subgroup"
    return pt, None


@functools.lru_cache(maxsize=4096)
def signature_status(sig: bytes):
    """(point, reason) for a 96-byte aggregate signature (same protocol
    as pubkey_status)."""
    pt = g2_decompress(bytes(sig))
    if pt == "bad":
        return None, "malformed"
    if pt is None:
        return None, "identity"
    if not g2_mul(R, pt) is None:
        return None, "subgroup"
    return pt, None


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    pk, reason = pubkey_status(bytes(pub))
    if reason is not None:
        return False
    s, reason = signature_status(bytes(sig))
    if reason is not None:
        return False
    return pairing_product_is_one(
        [(pk, hash_to_g2(bytes(msg))), (g1_neg(G1_GEN), s)]
    )


def aggregate(sigs) -> bytes:
    """Aggregate signatures (sum in G2). Raises on malformed input —
    aggregation is a proposer-side op, not a verify path."""
    acc = None
    for sig in sigs:
        pt = g2_decompress(bytes(sig))
        if pt == "bad":
            raise ValueError("malformed bls12381 signature")
        acc = g2_add(acc, pt)
    return g2_compress(acc)


def aggregate_pubkeys(pubs):
    """Affine apk over decompressed pubkeys, or (None, reason-index)."""
    acc = None
    for i, pub in enumerate(pubs):
        pt, reason = pubkey_status(bytes(pub))
        if reason is not None:
            return None, i
        acc = g1_add(acc, pt)
    return acc, None


def fast_aggregate_verify(pubs, msg: bytes, sig: bytes) -> bool:
    """All signers signed the SAME message: one pairing check against
    the aggregate pubkey. False (never raises) on any malformed input,
    identity/subgroup violations, or an infinity apk."""
    s, reason = signature_status(bytes(sig))
    if reason is not None:
        return False
    apk, bad = aggregate_pubkeys(pubs)
    if bad is not None or apk is None:
        return False
    return pairing_product_is_one(
        [(apk, hash_to_g2(bytes(msg))), (g1_neg(G1_GEN), s)]
    )


class PubKey(_PubKey):
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != PUB_KEY_SIZE:
            raise ValueError(f"bls12381 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(data)

    def address(self) -> bytes:
        return address_hash(self._bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_LENGTH:
            return False
        return verify(self._bytes, msg, sig)

    def type(self) -> str:
        return KEY_TYPE


class PrivKey(_PrivKey):
    __slots__ = ("_bytes", "_d")

    def __init__(self, data: bytes):
        if len(data) != PRIV_KEY_SIZE:
            raise ValueError(f"bls12381 privkey must be {PRIV_KEY_SIZE} bytes")
        self._bytes = bytes(data)
        self._d = int.from_bytes(data, "big") % R
        if self._d == 0:
            raise ValueError("invalid bls12381 scalar")

    def sign(self, msg: bytes) -> bytes:
        return g2_compress(g2_mul(self._d, hash_to_g2(bytes(msg))))

    def pub_key(self) -> PubKey:
        return PubKey(g1_compress(g1_mul(self._d, G1_GEN)))

    def bytes(self) -> bytes:
        return self._bytes

    def type(self) -> str:
        return KEY_TYPE


def gen_priv_key() -> PrivKey:
    while True:
        cand = os.urandom(PRIV_KEY_SIZE)
        if int.from_bytes(cand, "big") % R:
            return PrivKey(cand)



# Generator sanity (cheap; the subgroup checks below are a few ms and
# gate the whole lane's correctness, so they run once per process).
assert g1_on_curve(G1_GEN) and g2_on_curve(G2_GEN)
