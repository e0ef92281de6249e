"""GF(p), the BLS12-381 base field (381 bits), in plain PyTorch.

Counterpart: tendermint_tpu/ops/fe_bls.py (36 signed 11-bit int32 limbs
for the TPU), mirrored operation for operation: the same limbs, the same
carry passes (carry, carry2), the same product (a 71-coefficient limb
convolution, two wide passes, the FOLD matrix for the high coefficients,
one three-pass carry) and mul_small, so every function returns the
reference's limbs exactly. It is the arithmetic of the plain versions of
the BLS12-381 kernels (ops/bls_verify.py) and the tests' yardstick; the
kernels (csrc/bls12381.cu) keep 12 words of 32 bits in Montgomery form
instead. The two share only the values: every operation is exact mod p.

An element is an int64 tensor (..., 36), the limb axis last. The
reference's bounds hold unchanged ("reduced": |limb| <= 4608; a product's
convolution coefficients below 36 * 4608^2 = 7.6e8); the limbs are held
in int64 only because PyTorch has no integer matrix product on the card.
The convolution and the fold are float64 matrix products instead: every
term and every partial sum is an integer below 2^53, so they are exact.

The kernels' interface is (..., 12) int32 words of 32 bits,
little-endian, canonical (value in [0, p)): from_words and to_words
convert, words_from_ints and ints_from_words on the host. There is no
device canonicalisation here either: to_words reduces through Python
ints, which only the plain versions' outputs take.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls12381 import P

NLIMBS = 36
RADIX = 11
MASK = (1 << RADIX) - 1  # 2047
NWORDS = 12

# The top wrap: 2^396 mod p. W < p < 2^381, so limb 35 is zero and limb
# 34 below 2^7: a carry out of limb 35 never feeds limb 35 again.
_W_INT = (1 << (RADIX * NLIMBS)) % P


def limbs_raw(v: int) -> np.ndarray:
    """A nonnegative int below 2^396 -> its 36 limbs (int64), not reduced."""
    return np.array([(v >> (RADIX * i)) & MASK for i in range(NLIMBS)], dtype=np.int64)


def limbs_from_int(v: int) -> np.ndarray:
    """A Python int -> its canonical limbs (reduced mod p first)."""
    return limbs_raw(v % P)


def int_from_limbs(a) -> int:
    """(36,) limbs -> the Python int they represent (not reduced)."""
    return sum(int(x) << (RADIX * i) for i, x in enumerate(np.asarray(a).tolist()))


def const(v: int, device) -> torch.Tensor:
    """Canonical (36,) int64 limbs of v mod p on `device`."""
    return torch.from_numpy(limbs_from_int(v)).to(device)


W_LIMBS = limbs_raw(_W_INT)
assert W_LIMBS[35] == 0 and W_LIMBS[34] < 128

# FOLD[k - 36] = the limbs of 2^(11 k) mod p, for the coefficients k of
# 36..73 of a widened product (the reference's 37 rows, and one more for
# reduce_wide's three-pass form).
FOLD = np.stack([limbs_raw(pow(2, RADIX * k, P)) for k in range(NLIMBS, 2 * NLIMBS + 2)])

_TENSORS: dict = {}


def _on(name: str, arr: np.ndarray, device, dtype=torch.int64) -> torch.Tensor:
    """A module constant as a tensor on `device`, made once per device."""
    key = (name, str(device), dtype)
    t = _TENSORS.get(key)
    if t is None:
        t = _TENSORS[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                                            dtype=dtype)
    return t


def _carry_pass(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass (the reference's _carry_pass): each limb
    keeps its low 11 bits and passes the rest up; the carry out of limb
    35 (weight 2^396) wraps through the whole W vector."""
    c = x >> RADIX  # arithmetic shift: floor division, signed-safe
    r = x & MASK
    r[..., 1:] += c[..., : NLIMBS - 1]
    return r.addcmul_(c[..., NLIMBS - 1 :], _on("W", W_LIMBS, x.device))


def carry(x: torch.Tensor) -> torch.Tensor:
    """|limb| < 1.7e8 -> reduced (|limb| <= 4608): three passes."""
    return _carry_pass(_carry_pass(_carry_pass(x)))


def carry2(x: torch.Tensor) -> torch.Tensor:
    """|limb| < 2^17 (sums of a few reduced values, mul_small by <= 24)
    -> reduced: two passes."""
    return _carry_pass(_carry_pass(x))


def add(a, b):
    return carry2(a + b)


def sub(a, b):
    return carry2(a - b)


def neg(a):
    return carry2(-a)


def _wide_pass(x: torch.Tensor) -> torch.Tensor:
    """A carry pass over a widened coefficient array, no top wrap (the
    array is wide enough that the top coefficient's carry is zero)."""
    c = x >> RADIX
    r = x & MASK
    r[..., 1:] += c[..., :-1]
    return r


def toeplitz(b: torch.Tensor) -> torch.Tensor:
    """(..., 36) limbs -> (..., 71, 36) float64 windows of b padded with
    35 zeros each side: row k holds b_(k-35+m) at column m, so
    conv(a, b) = toeplitz(b) @ a.flip(-1) (coefficient k is
    sum_i a_i b_(k-i)). A strided view, no gather."""
    return torch.nn.functional.pad(b.to(torch.float64), (NLIMBS - 1, NLIMBS - 1)).unfold(
        -1, NLIMBS, 1)


def reduce_wide(c71: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """(..., 71) int64 convolution coefficients -> the reduced element
    they represent: `passes` wide passes over 71 + passes coefficients
    (each pass starts with a zero top coefficient, so none drops a
    carry), the fold of the high ones (36 and up) through FOLD, one
    three-pass carry. passes=2 is the reference's mul after its einsum:
    coefficients below 7.7e8 shrink to ~2250 and the fold's terms stay
    below 37 * 2250 * 2047 < 1.7e8, carry()'s domain. passes=3 takes the
    sums of up to 32 products that ops/bls_verify's Fp12 products form
    (|c| < 32 * 7.7e8 < 2.5e10): three passes bring them to ~2051, and
    the fold to below 38 * 2051 * 2047 < 1.6e8."""
    x = torch.nn.functional.pad(c71, (0, passes))
    for _ in range(passes):
        x = _wide_pass(x)
    hi = x[..., NLIMBS:].to(torch.float64)
    fold_m = _on("FOLD", FOLD, x.device, torch.float64)[: hi.shape[-1]]
    return carry(x[..., :NLIMBS] + (hi @ fold_m).to(torch.int64))


def conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 71 convolution coefficients of two reduced elements (int64;
    exact in float64: below 36 * 4608^2 < 2^30)."""
    a, b = torch.broadcast_tensors(a, b)
    c = toeplitz(b) @ a.to(torch.float64).flip(-1).unsqueeze(-1)
    return c.squeeze(-1).to(torch.int64)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field product of reduced elements -> reduced."""
    return reduce_wide(conv(a, b))


def mul_small(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c for |c| <= 24 (limbs stay below 2^17, carry2's domain)."""
    return carry2(a * c)


# -- conversions -----------------------------------------------------------------


def field_to_limbs(vals) -> np.ndarray:
    """Canonical field ints -> (B, 36) int64 limb rows (the reference's
    field_to_limbs, int64)."""
    vals = list(vals)
    if not vals:
        return np.zeros((0, NLIMBS), dtype=np.int64)
    return np.stack([limbs_raw(int(v)) for v in vals])


def f2_rows(vals) -> np.ndarray:
    """[(c0, c1), ...] Fp2 ints -> (B, 2, 36) limb rows."""
    flat = [c for pair in vals for c in pair]
    return field_to_limbs(flat).reshape(-1, 2, NLIMBS)


def words_from_ints(vals) -> np.ndarray:
    """Ints below 2^384 -> (len(vals), 12) int32 words, least significant
    first (the kernels' field rows)."""
    vals = list(vals)
    if not vals:
        return np.zeros((0, NWORDS), dtype=np.int32)
    buf = b"".join(int(v).to_bytes(4 * NWORDS, "little") for v in vals)
    return np.frombuffer(buf, dtype="<i4").reshape(len(vals), NWORDS).copy()


def ints_from_words(w) -> list:
    """(..., 12) int32 words -> the flat list of the ints they hold."""
    a = np.ascontiguousarray(np.asarray(w), dtype="<i4").reshape(-1, NWORDS)
    return [int.from_bytes(r.tobytes(), "little") for r in a]


# limb i is bits [11 i, 11 i + 11) of the 384-bit number: from word
# 11 i // 32 shifted down, joined with the next word's low bits
_BIT = RADIX * np.arange(NLIMBS)
_W_LO = _BIT // 32
_SHIFT = _BIT % 32
_HAS_HI = (_SHIFT + RADIX > 32) & (_W_LO + 1 < NWORDS)
_W_HI = np.minimum(_W_LO + 1, NWORDS - 1)
_HAS_LO = _W_LO < NWORDS
_W_LO = np.minimum(_W_LO, NWORDS - 1)


def from_words(w: torch.Tensor) -> torch.Tensor:
    """(..., 12) int32 words -> (..., 36) int64 canonical limbs."""
    dev = w.device
    u = w.to(torch.int64) & 0xFFFFFFFF
    shift = _on("SHIFT", _SHIFT, dev)
    lo = (u[..., _on("W_LO", _W_LO, dev)] >> shift) * _on("HAS_LO", _HAS_LO, dev)
    hi = (u[..., _on("W_HI", _W_HI, dev)] << (32 - shift)) * _on("HAS_HI", _HAS_HI, dev)
    return (lo | hi) & MASK


def to_ints(x: torch.Tensor) -> list:
    """(..., 36) limbs -> the flat list of their values mod p (host)."""
    rows = x.detach().to("cpu").reshape(-1, NLIMBS).tolist()
    return [sum(int(v) << (RADIX * i) for i, v in enumerate(r)) % P for r in rows]


def to_words(x: torch.Tensor) -> torch.Tensor:
    """(..., 36) limbs -> (..., 12) int32 canonical words on x's device
    (the value mod p, reduced through Python ints on the host)."""
    w = words_from_ints(to_ints(x))
    return torch.from_numpy(w).to(x.device).reshape(*x.shape[:-1], NWORDS)
