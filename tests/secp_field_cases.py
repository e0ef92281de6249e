"""The secp256k1 kernels' field functions (csrc/secp256k1.cu) at the ends
of their range, for the CPU stand-in (tests/test_torch_secp.py) and the
card (tests/test_torch_cuda.py): the same pairs of values through the
same C++ call, the results against Python integers mod p. On the card
the sums, differences and folds are PTX carry chains, on the stand-in
64-bit C++, so each build is checked on its own."""

import random

import numpy as np

P = 2**256 - 2**32 - 977
NW = 8

# weak values (below 2^256, canonical or not) where the folds of a sum, a
# difference or a product carry or borrow twice
WEAK_EDGE = [0, 1, 2, 977, 2**32 + 976, 2**32 + 977, 2**32 + 978, P - 1, P, P + 1, 2**255,
             2**256 - 2**33 - 1954, 2**256 - 2**32 - 978, 2**256 - 2**32 - 977, 2**256 - 2**32,
             2**256 - 2, 2**256 - 1]
FIELD_OPS = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b, "mul": lambda a, b: a * b,
             "mul21": lambda a, b: 21 * a, "shl3": lambda a, b: 8 * a, "mul3": lambda a, b: 3 * a,
             "canon": lambda a, b: a}

# One field operation on the k-th of n values of 8 words and the k-th
# second operand, in the order of FIELD_OPS: op 0 fp_add, 1 fp_sub,
# 2 fp_mul, 3 fp_mul_small by 21, 4 fp_shl by 3, 5 fp_mul3, 6 fp_canon.
# Included after csrc/secp256k1.cu's body, inside `using namespace secp`.
FIELD_OP = r"""
__device__ void field_op(int op, const uint32_t* a, const uint32_t* b, uint32_t* out, int k) {
  fp x, y;
  for (int i = 0; i < NW; ++i) x.v[i] = a[k * NW + i], y.v[i] = b[k * NW + i];
  const fp r = op == 0 ? fp_add(x, y) : op == 1 ? fp_sub(x, y) : op == 2 ? fp_mul(x, y)
               : op == 3 ? fp_mul_small(x, 21) : op == 4 ? fp_shl(x, 3) : op == 5 ? fp_mul3(x)
               : fp_canon(x);
  for (int i = 0; i < NW; ++i) out[k * NW + i] = r.v[i];
}
"""


def pairs() -> tuple:
    """Every pair of WEAK_EDGE values and four seeded random ones: (the
    pairs, their first and second operands as uint32 words)."""
    rng = random.Random(11)
    vals = WEAK_EDGE + [rng.randrange(2**256) for _ in range(4)]
    both = [(a, b) for a in vals for b in vals]

    def words(xs):
        return np.frombuffer(b"".join(x.to_bytes(32, "little") for x in xs),
                             dtype=np.uint32).copy()

    return both, words([x for x, _ in both]), words([y for _, y in both])


def check(op: str, both: list, out: np.ndarray) -> None:
    """Each result below 2^256 and equal to the value mod p, canonical
    for fp_canon."""
    got = [int.from_bytes(out[k * NW:(k + 1) * NW].tobytes(), "little")
           for k in range(len(both))]
    want = [FIELD_OPS[op](x, y) % P for x, y in both]
    assert [g % P for g in got] == want
    if op == "canon":
        assert got == want
