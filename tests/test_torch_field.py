"""The port's GF(2^255 - 19) field (tendermint_tpu_torch/ops/fe.py)
against the JAX package's limb-major field (tendermint_tpu/ops/fe_t.py,
under jax.jit) and against Python integers.

The same limbs, made from a numpy seed, go to both packages as numpy
arrays. Tolerance: none. The arithmetic is integer, and fe.py performs
fe_t's steps, so the output limbs must be equal, and their value mod p
must equal the Python-integer result.
"""

import os

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tendermint_tpu.ops import fe_t  # noqa: E402
from tendermint_tpu_torch.ops import fe  # noqa: E402

# The plain versions run thousands of small tensor ops: one intra-op
# thread keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = fe.P
EDGE = [0, 1, P - 1, P, 2**255 - 1, 8 * P]


def _values(seed: int, n: int = 10) -> list:
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") % 2**255 for _ in range(n)]
    return EDGE + rand


def _limbs(vals) -> np.ndarray:
    return fe.from_ints(vals).numpy()


def _loose(seed: int) -> np.ndarray:
    """Limbs of a - b after one carry pass: signed limbs, as the ladder's
    intermediate values have them."""
    a = torch.from_numpy(_limbs(_values(seed)))
    b = torch.from_numpy(_limbs(_values(seed + 1)))
    return fe.sub(a, b).numpy()


def _jax(fn, *xs) -> np.ndarray:
    return np.asarray(jax.jit(fn)(*(jnp.asarray(x) for x in xs)))


def _torch(fn, *xs) -> np.ndarray:
    return fn(*(torch.from_numpy(x) for x in xs)).numpy()


def _ints(limbs: np.ndarray) -> list:
    return [v % P for v in fe.to_ints(torch.from_numpy(limbs))]


UNARY = {
    "sq": (fe.sq, fe_t.sq, lambda x: x * x),
    "neg": (fe.neg, fe_t.neg, lambda x: -x),
    "pow22523": (fe.pow22523, fe_t.pow22523, lambda x: pow(x, 2**252 - 3, P)),
    "canon": (fe.canon, fe_t.canon, lambda x: x),
    "carry": (fe.carry, fe_t.carry, lambda x: x),
}
BINARY = {
    "mul": (fe.mul, fe_t.mul, lambda x, y: x * y),
    "add": (fe.add, fe_t.add, lambda x, y: x + y),
    "sub": (fe.sub, fe_t.sub, lambda x, y: x - y),
}


@pytest.mark.parametrize("loose", [False, True], ids=["canonical", "signed-limbs"])
@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_matches_fe_t_and_ints(op, loose):
    port, ref, want = UNARY[op]
    x = _loose(3) if loose else _limbs(_values(3))
    got = _torch(port, x)
    np.testing.assert_array_equal(got, _jax(ref, x))
    assert _ints(got) == [want(v) % P for v in _ints(x)]


@pytest.mark.parametrize("loose", [False, True], ids=["canonical", "signed-limbs"])
@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_matches_fe_t_and_ints(op, loose):
    port, ref, want = BINARY[op]
    if loose:
        a, b = _loose(5), _loose(7)
    else:
        a, b = _limbs(_values(5)), _limbs(_values(7)[::-1])
    got = _torch(port, a, b)
    np.testing.assert_array_equal(got, _jax(ref, a, b))
    assert _ints(got) == [want(x, y) % P for x, y in zip(_ints(a), _ints(b))]


def test_canon_is_fully_reduced():
    x = _limbs(_values(11))
    got = _torch(fe.canon, x)
    assert fe.to_ints(torch.from_numpy(got)) == [v % P for v in _values(11)]
    assert ((got >= 0) & (got <= fe.MASK)).all()


def test_is_zero_matches_fe_t():
    vals = _values(13) + [2 * P, 3 * P]
    x = _limbs(vals)
    got = _torch(fe.is_zero, x)
    np.testing.assert_array_equal(got, _jax(fe_t.is_zero, x))
    assert got.shape == (1, len(vals))
    assert got[0].tolist() == [v % P == 0 for v in vals]


def test_eq_of_equal_values_in_other_limbs():
    """p + v and v are the same field element in different limbs."""
    vals = _values(17)
    a = _limbs([v % P for v in vals])
    b = _limbs([v % P + P for v in vals])
    assert _torch(fe.eq, a, b).all()
    np.testing.assert_array_equal(_torch(fe.eq, a, b), _jax(fe_t.eq, a, b))
