"""The port's point functions and ZIP-215 decompression
(tendermint_tpu_torch/ops/point.py) against the JAX package's jnp point
functions (tendermint_tpu/ops/pallas_verify.py, under jax.jit) and the
pure-Python oracle (tendermint_tpu/crypto/_edwards.py).

Inputs: the public keys and R encodings of the ZIP-215 edge battery of
tests/test_ops.py plus seeded random encodings, as (32, B) byte arrays.
Tolerance: none. Limbs must equal the JAX package's, and affine
coordinates mod p the oracle's.
"""

import os

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from test_ops import _edge_entries  # noqa: E402
from tendermint_tpu.crypto import _edwards as E  # noqa: E402
from tendermint_tpu.ops import pallas_verify as pv  # noqa: E402
from tendermint_tpu_torch.ops import fe, point  # noqa: E402

# The plain versions run thousands of small tensor ops: one intra-op
# thread keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = E.P


@pytest.fixture(scope="module")
def encodings() -> np.ndarray:
    """(32, B) uint8: battery keys, battery R's, seeded random bytes."""
    ents = _edge_entries()
    encs = [p for p, _, _ in ents] + [s[:32] for _, _, s in ents]
    rng = np.random.default_rng(21)
    encs += [rng.bytes(32) for _ in range(8)]
    return np.frombuffer(b"".join(encs), dtype=np.uint8).reshape(-1, 32).T.copy()


def _jax(fn, *xs):
    return jax.jit(fn)(*xs)


def _np(pt) -> list:
    return [np.asarray(c) for c in pt]


def _decompress_port(enc: np.ndarray):
    y, sign = point.unpack_limbs(torch.from_numpy(enc.astype(np.int32)))
    return point.decompress(y, sign)


def _decompress_jax(enc: np.ndarray):
    def f(b):
        y, sign = pv._unpack_limbs(b)
        return pv.decompress(y, sign)

    return _jax(f, jnp.asarray(enc.astype(np.int32)))


def _affine(pt) -> list:
    """Affine (x, y) mod p of each column of a limb-tensor point."""
    xs, ys, zs = (fe.to_ints(c) for c in pt[:3])
    out = []
    for x, y, z in zip(xs, ys, zs):
        zi = pow(z % P, P - 2, P)
        out.append((x * zi % P, y * zi % P))
    return out


def _oracle_affine(p) -> tuple:
    x, y, z, _ = p
    zi = pow(z % P, P - 2, P)
    return x * zi % P, y * zi % P


def test_unpack_limbs_matches_pallas_verify(encodings):
    y, sign = point.unpack_limbs(torch.from_numpy(encodings.astype(np.int32)))
    yj, sj = _jax(pv._unpack_limbs, jnp.asarray(encodings.astype(np.int32)))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(sj))


def test_unpack_digits_match_pallas_verify(encodings):
    scal = encodings.astype(np.int32)
    scal[31] &= 0x1F  # a scalar below 2^253, as the lane scalars are
    got = point.unpack_digits2_grouped(torch.from_numpy(scal)).numpy()
    want = np.asarray(_jax(pv._unpack_digits2_grouped, jnp.asarray(scal)))
    np.testing.assert_array_equal(got, want)
    # digit t sits at digit_row(t): bits 2t, 2t+1 of the scalar
    for col in range(3):
        k = int.from_bytes(bytes(scal[:, col].astype(np.uint8)), "little")
        digits = [(k >> (2 * t)) & 3 for t in range(128)]
        assert [int(got[point.digit_row(t), col]) for t in range(128)] == digits


def test_decompress_matches_pallas_verify_and_oracle(encodings):
    ok, pt = _decompress_port(encodings)
    okj, ptj = _decompress_jax(encodings)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    for c, cj in zip(pt, ptj):
        np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
    oracle = [E.decompress(bytes(encodings[:, i])) for i in range(encodings.shape[1])]
    assert ok[0].tolist() == [p is not None for p in oracle]
    assert not all(p is not None for p in oracle)  # the battery has rejects
    for got, want in zip(_affine(pt), oracle):
        if want is not None:
            assert got == _oracle_affine(want)


@pytest.fixture(scope="module")
def points(encodings):
    """(P, Q): the decompressable encodings' points and the same points
    rotated by one column."""
    ok, pt = _decompress_port(encodings)
    keep = ok[0]
    p = tuple(c[:, keep].contiguous() for c in pt)
    q = tuple(torch.roll(c, 1, dims=1).contiguous() for c in p)
    return p, q


OPS = {
    "point_add": (lambda p, q: point.point_add(p, q), lambda p, q: pv.point_add(p, q)),
    "point_double": (lambda p, q: point.point_double(p), lambda p, q: pv.point_double(p)),
    "point_double_no_t": (
        lambda p, q: point.point_double(p, need_t=False)[:3],
        lambda p, q: pv.point_double(p, need_t=False)[:3],
    ),
    "point_neg": (lambda p, q: point.point_neg(p), lambda p, q: pv.point_neg(p)),
    "to_niels": (lambda p, q: point.to_niels(p), lambda p, q: pv.to_niels(p)),
    "point_add_niels": (
        lambda p, q: point.point_add_niels(p, point.to_niels(q)),
        lambda p, q: pv.point_add_niels(p, pv.to_niels(q)),
    ),
    "point_add_niels_no_t": (
        lambda p, q: point.point_add_niels(p, point.to_niels(q), need_t=False)[:3],
        lambda p, q: pv.point_add_niels(p, pv.to_niels(q), need_t=False)[:3],
    ),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_point_op_matches_pallas_verify(op, points):
    port, ref = OPS[op]
    p, q = points
    got = port(p, q)
    want = _jax(ref, tuple(jnp.asarray(c.numpy()) for c in p),
                tuple(jnp.asarray(c.numpy()) for c in q))
    assert len(got) == len(want)
    for c, cj in zip(got, want):
        np.testing.assert_array_equal(c.numpy(), np.asarray(cj))


def _oracle_points(p) -> list:
    cols = [fe.to_ints(c) for c in p]
    return [tuple(v % P for v in col) for col in zip(*cols)]


def test_point_add_and_double_match_oracle(points):
    p, q = points
    op, oq = _oracle_points(p), _oracle_points(q)
    assert _affine(point.point_add(p, q)) == [
        _oracle_affine(E.point_add(a, b)) for a, b in zip(op, oq)
    ]
    assert _affine(point.point_double(p)) == [
        _oracle_affine(E.point_double(a)) for a in op
    ]
    # acc + Niels entry is the same sum as the extended addition
    assert _affine(point.point_add_niels(p, point.to_niels(q))) == _affine(
        point.point_add(p, q)
    )
