"""GF(2^256 - 2^32 - 977), the secp256k1 field, in plain PyTorch.

Counterpart: tendermint_tpu/ops/fe_secp.py (20 signed 13-bit int32 limbs
for the TPU). This is the arithmetic of the plain versions of the
secp256k1 kernels (ops/secp_verify.py); the kernels (csrc/secp256k1.cu)
keep 8 words of 32 bits and 64-bit products instead. The two share only
the values: every operation is exact mod p, so the same formulas give
the same canonical coordinates whatever the limbs.

An element here is an int64 tensor (..., 16) of signed 16-bit limbs,
the limb axis LAST (a point's coordinates are (B, 16) tensors, a
table's (B, 16, 16)). The kernels' interface is (..., 8) int32 words
of 32 bits, little-endian, canonical: from_words and to_words convert.

2^256 = 2^32 + 977 (mod p), so a carry out of limb 15 (weight 2^256)
folds back as 977 at limb 0 and 1 at limb 2.

Bounds. "Reduced" (what carry, add, sub, mul and mul_small return):
every limb in [-1000, 2^16 + 1000]. A product of two reduced elements
has column sums below 16 (2^16 + 1000)^2 < 2^36.1; the fold of the 15
high columns takes a limb below 2^47.1, and four carry passes bring it
back: the carries shrink 2^31.1 -> 2^15.1 -> 2^9 -> 1, the last pass
leaving at most 977 + 1 above 2^16 in limb 0 and 2 in the others.
"canonical" (canon): limbs in [0, 2^16), value in [0, p).
"""

from __future__ import annotations

import torch

NLIMBS = 16
RADIX = 16
MASK = (1 << RADIX) - 1
NWORDS = 8
P = 2**256 - 2**32 - 977
_FOLD0 = 977  # 2^256 mod p = 977 + 2^32: 977 at limb 0, 1 at limb 2


def _limbs(v: int) -> list:
    return [(v >> (RADIX * i)) & MASK for i in range(NLIMBS)]


def const(v: int, device) -> torch.Tensor:
    """Canonical (16,) int64 limbs of v mod p."""
    return torch.tensor(_limbs(v % P), dtype=torch.int64, device=device)


def from_ints(vals, device="cpu") -> torch.Tensor:
    """Python ints in [0, 2^256) -> (len(vals), 16) limbs (not reduced)."""
    return torch.tensor([_limbs(v) for v in vals], dtype=torch.int64,
                        device=device).reshape(len(vals), NLIMBS)


def to_ints(x: torch.Tensor) -> list:
    """(B, 16) limbs -> the B Python ints they represent (not reduced)."""
    return [sum(int(l) << (RADIX * i) for i, l in enumerate(row))
            for row in x.to("cpu").tolist()]


def from_words(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 32-bit words -> (..., 16) int64 limbs."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([u & MASK, u >> RADIX], dim=-1).reshape(*w.shape[:-1], NLIMBS)


def to_words(x: torch.Tensor) -> torch.Tensor:
    """(..., 16) canonical limbs -> (..., 8) int32 32-bit words (the bit
    pattern of each word; words at or above 2^31 read negative)."""
    u = x[..., 0::2] | (x[..., 1::2] << RADIX)
    return (u - ((u >> 31) << 32)).to(torch.int32)


def carry_pass(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass: each limb keeps its low 16 bits and passes
    the rest (an arithmetic shift) up; limb 15's carry folds to limbs 0
    and 2."""
    c = x >> RADIX
    r = x & MASK
    top = c[..., NLIMBS - 1 :]
    r[..., 1:] += c[..., : NLIMBS - 1]
    r[..., 0:1] += _FOLD0 * top
    r[..., 2:3] += top
    return r


def carry(x: torch.Tensor, passes: int = 4) -> torch.Tensor:
    for _ in range(passes):
        x = carry_pass(x)
    return x


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + b, 2)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a - b, 2)


def neg(a: torch.Tensor) -> torch.Tensor:
    return carry(-a, 2)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a k for a small constant 0 <= k <= 64."""
    return carry(a * k, 3)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b: the 31 column sums of the 16 x 16 products (rows skewed by a
    flat reshape), the 15 high columns folded through 2^256 = 2^32 + 977,
    then four carry passes."""
    a, b = torch.broadcast_tensors(a, b)
    lead = a.shape[:-1]
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)  # (..., 16, 16): [i, j] = a_i b_j
    flat = torch.nn.functional.pad(prod, (0, NLIMBS)).reshape(*lead, 2 * NLIMBS * NLIMBS)
    cols = flat[..., : NLIMBS * (2 * NLIMBS - 1)].reshape(*lead, NLIMBS, 2 * NLIMBS - 1).sum(-2)
    lo = cols[..., :NLIMBS].clone()
    hi = cols[..., NLIMBS:]  # 15 columns, weights 2^256 .. 2^480
    lo[..., : NLIMBS - 1] += _FOLD0 * hi
    lo[..., 2:] += hi[..., : NLIMBS - 2]
    # column 30's 2^32 part has weight 2^512 = 2^256 (2^32 + 977)
    lo[..., 0:1] += _FOLD0 * hi[..., NLIMBS - 2 :]
    lo[..., 2:3] += hi[..., NLIMBS - 2 :]
    return carry(lo, 4)


def sq(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def _seq_carry(x: torch.Tensor) -> tuple:
    """Carries propagated limb by limb: (limbs in [0, 2^16), the carry out
    of limb 15)."""
    x = x.clone()
    for i in range(NLIMBS - 1):
        x[..., i + 1] += x[..., i] >> RADIX
        x[..., i] &= MASK
    top = x[..., NLIMBS - 1] >> RADIX
    x[..., NLIMBS - 1] &= MASK
    return x, top


_TWO_P = _limbs(2 * P - 2**256)
_TWO_P[NLIMBS - 1] += 1 << RADIX  # 2p = the limbs of 2p - 2^256, 2^256 in limb 15


def canon(x: torch.Tensor) -> torch.Tensor:
    """Reduced -> canonical: add 2p (the value is then positive), carry
    limb by limb folding the carry out of limb 15 until there is none,
    then subtract p where the value is p or more."""
    x = x + torch.tensor(_TWO_P, dtype=torch.int64, device=x.device)
    for _ in range(3):
        x, top = _seq_carry(x)
        x[..., 0] += _FOLD0 * top
        x[..., 2] += top
    x, top = _seq_carry(x)  # no carry out now: the value is below 2^256
    # v >= p iff v + 2^32 + 977 carries out of 2^256; then that sum's low
    # 256 bits are v - p
    y = x.clone()
    y[..., 0] += _FOLD0
    y[..., 2] += 1
    y, over = _seq_carry(y)
    return torch.where((over != 0).unsqueeze(-1), y, x)


def is_zero(x: torch.Tensor) -> torch.Tensor:
    """(...,) bool: x = 0 mod p."""
    return (canon(x) == 0).all(dim=-1)
