"""GF(2^255 - 19) arithmetic on (20, B) int32 limb tensors — plain PyTorch.

Counterpart: tendermint_tpu/ops/fe_t.py. A field element is 20 signed
13-bit limbs in int32 with the batch on the LAST axis, the layout of the
RLC kernels' global arrays. Every formula mirrors fe_t line for line, and
csrc/fe25519.cuh mirrors this module, so the plain versions of the
kernels (ops/rlc.py) and the CUDA kernels produce the same limbs, not
only the same field values.

Bounds (fe_t.py:60-66, :103-108): add/sub/neg keep limbs in
(-1216, 2^13 + 1216] after one carry pass, and a product of two such
elements has convolution coefficients below 2^31, so all arithmetic fits
int32. torch's `>>` on int32 is an arithmetic shift, as the carries need.
"""

from __future__ import annotations

import torch

NLIMBS = 20
RADIX = 13
MASK = (1 << RADIX) - 1
P = 2**255 - 19
_TOP_WRAP = 608  # 2^260 mod p = 2^5 * 19


def const(v: int, like: torch.Tensor) -> torch.Tensor:
    """Python int in [0, 2^260) -> (20, 1) int32 limbs on like's device."""
    return torch.tensor(
        [[(v >> (RADIX * i)) & MASK] for i in range(NLIMBS)],
        dtype=torch.int32, device=like.device,
    )


def from_int(v: int, like: torch.Tensor) -> torch.Tensor:
    """Canonical (20, 1) limbs of v mod p."""
    return const(v % P, like)


def from_ints(vals, device="cpu") -> torch.Tensor:
    """Python ints in [0, 2^260) -> (20, len(vals)) int32 limbs."""
    return torch.tensor(
        [[(v >> (RADIX * i)) & MASK for v in vals] for i in range(NLIMBS)],
        dtype=torch.int32, device=device,
    )


def to_ints(x: torch.Tensor) -> list:
    """(20, B) limbs -> the B Python ints they represent (not reduced)."""
    cols = x.to("cpu", torch.int64).T.tolist()
    return [sum(l << (RADIX * i) for i, l in enumerate(col)) for col in cols]


def carry_pass(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass over the limb axis; limb 19's carry wraps
    to limb 0 times 608."""
    c = x >> RADIX
    wrap = torch.cat([c[NLIMBS - 1 :] * _TOP_WRAP, c[: NLIMBS - 1]], dim=0)
    return (x & MASK) + wrap


def carry(x: torch.Tensor) -> torch.Tensor:
    return carry_pass(carry_pass(carry_pass(x)))


def add(a, b):
    return carry_pass(a + b)


def sub(a, b):
    return carry_pass(a - b)


def neg(a):
    return carry_pass(-a)


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(20, B) x (20, B) -> (39, B) limb convolution: the outer product,
    each row i skewed to start at column i, summed over rows."""
    outer = a[:, None, :] * b[None, :, :]  # (20, 20, B)
    B = outer.shape[-1]
    skew = torch.cat([outer, torch.zeros_like(outer)], dim=1)  # (20, 40, B)
    # row i of a (20, 39) view of the flattened (20, 40) rows starts at
    # flat index 39 i, so entry (i, i + j) is outer[i, j]
    skew = skew.reshape(NLIMBS * 2 * NLIMBS, B)[: NLIMBS * 39]
    return skew.reshape(NLIMBS, 39, B).sum(0, dtype=torch.int32)


def _wrap_fold(c39: torch.Tensor) -> torch.Tensor:
    """39 convolution coefficients -> carried 20-limb element (2^260 = 608)."""
    lo, hi = c39[:NLIMBS], c39[NLIMBS:]
    z = torch.zeros_like(hi[:1])
    r = (
        lo
        + _TOP_WRAP * torch.cat([hi & MASK, z], dim=0)
        + _TOP_WRAP * torch.cat([z, hi >> RADIX], dim=0)
    )
    return carry(r)


def mul(a, b):
    return _wrap_fold(_conv(a, b))


def sq(a):
    """fe_t.sq sums the symmetric products (a_i * 2a_j, j > i) instead
    of the full square; the 39 coefficients are the same integers, so
    the result is the same limbs."""
    return _wrap_fold(_conv(a, a))


def sqn(a, n: int):
    for _ in range(n):
        a = sq(a)
    return a


def pow22523(z):
    """z^(2^252 - 3) — ref10 addition chain."""
    x2 = sq(z)
    x9 = mul(z, sqn(x2, 2))
    x11 = mul(x2, x9)
    x31 = mul(x9, sq(x11))
    xa = mul(sqn(x31, 5), x31)
    xb = mul(sqn(xa, 10), xa)
    xc = mul(sqn(xb, 20), xb)
    xd = mul(sqn(xc, 10), xa)
    xe = mul(sqn(xd, 50), xd)
    xf = mul(sqn(xe, 100), xe)
    xg = mul(sqn(xf, 50), xd)
    return mul(sqn(xg, 2), z)


def _fold255(x):
    """Fold bits >= 2^255 (2^255 = 19 mod p)."""
    q = x[NLIMBS - 1] >> 8
    top = x[NLIMBS - 1] & 0xFF
    body = torch.cat([(x[0] + 19 * q)[None], x[1 : NLIMBS - 1], top[None]], dim=0)
    return carry(body)


def _cond_sub(x, p_col):
    """x - p if x >= p (non-negative near-canonical limbs), by a
    sequential borrow over the 20 limbs."""
    d = x - p_col
    rows = []
    c = torch.zeros_like(x[0])
    for i in range(NLIMBS):
        t = d[i] + c
        c = t >> RADIX
        rows.append(t & MASK)
    return torch.where((c < 0)[None, :], x, torch.stack(rows, dim=0))


def canon(x):
    p_col = const(P, x)
    x = carry(x)
    x = carry(x + const(8 * P, x))
    x = _fold255(x)
    x = _fold255(x)
    x = _cond_sub(x, p_col)
    return _cond_sub(x, p_col)


def is_zero(x):
    """(1, B) bool: x = 0 mod p."""
    return (canon(x) == 0).all(dim=0, keepdim=True)


def eq(a, b):
    return is_zero(a - b)
