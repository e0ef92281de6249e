"""The port's RLC path (tendermint_tpu_torch/ops/rlc.py) on the CPU
against the JAX package's (tendermint_tpu/ops/pallas_rlc.py) and the
ZIP-215 oracle.

- prepare_rlc: byte-equal to the JAX prepare_rlc for the same
  coefficients z (TM_TPU_RLC_SEED on the JAX side; its _gen_z output is
  handed to the port).
- K1-K3: the JAX kernel bodies run eagerly (tests/pallas_bodies.py) in
  one module-scoped fixture at 16 signatures (the ladder body is slow
  on the CPU); K1's coords, flags and digits and K2's table equal the
  port's plain versions limb for limb, and the lane verdicts are equal.
- verify_batch_rlc: per-signature verdicts equal to verify_zip215.

Tolerance: none; every compared value is an integer or a flag.
"""

import os

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pallas_bodies import run_body  # noqa: E402
from test_ops import _edge_entries  # noqa: E402
from tendermint_tpu.crypto import _edwards as E  # noqa: E402
from tendermint_tpu.crypto import ed25519 as jed  # noqa: E402
from tendermint_tpu.ops import pallas_rlc  # noqa: E402
from tendermint_tpu_torch.ops import kernels, rlc  # noqa: E402
from tendermint_tpu_torch.ops.entry_block import EntryBlock  # noqa: E402

# The plain versions run thousands of small tensor ops: one intra-op
# thread keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

RLC_SEED = "20261016"


def _signed(n: int, tag: int) -> list:
    rng = np.random.default_rng(tag)
    out = []
    for i in range(n):
        sk = jed.gen_priv_key(rng.bytes(32))
        msg = b"rlc-%d-%d-" % (tag, i) + rng.bytes(int(rng.integers(0, 40)))
        out.append((sk.pub_key().bytes(), msg, sk.sign(msg)))
    return out


def _prepare_both(entries: list, bucket: int):
    """(JAX args, port args) of prepare_rlc over `entries` with the same
    seeded coefficients."""
    n = len(entries)
    live = min((n + rlc.M - 1) // rlc.M, bucket // rlc.M) * rlc.M
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TM_TPU_RLC_SEED", RLC_SEED)
        jax_args = pallas_rlc.prepare_rlc(entries, bucket)
        z = np.zeros((bucket, 32), dtype=np.uint8)
        z[:live] = pallas_rlc._gen_z(live)
    port_args = rlc.prepare_rlc(EntryBlock.from_entries(entries), bucket, z=z)
    return jax_args, port_args


def _lanes_port(args) -> np.ndarray:
    a_t, r_t, scal_t, sok = (torch.from_numpy(np.ascontiguousarray(a)) for a in args)
    coords, ok, dig = rlc.k1_rlc(a_t, r_t, scal_t)
    tbl = rlc.k2_rlc(coords)
    return rlc.k3_rlc(tbl, dig, coords, ok, sok).numpy()[0].astype(bool)


@pytest.mark.parametrize("n, bucket", [(22, 32), (150, 256), (256, 256)])
def test_prepare_rlc_byte_equal_to_jax(n, bucket):
    entries = (_edge_entries() + _signed(n, n))[:n]
    jax_args, port_args = _prepare_both(entries, bucket)
    assert len(jax_args) == len(port_args) == 4
    for j, p in zip(jax_args, port_args):
        assert j.dtype == p.dtype and j.shape == p.shape
        np.testing.assert_array_equal(j, p)


@pytest.fixture(scope="module")
def sixteen():
    """16 signatures in 4 lanes: all valid; one tampered and one wrong
    message; all small-order keys (the cofactored equation accepts them
    for any message); s >= L, a corrupted key, random bytes. Returns
    (entries, JAX args, port args, JAX lane verdicts, JAX (coords, ok,
    dig, tbl)), from the three JAX kernel bodies run eagerly."""
    e = _edge_entries()
    entries = [e[i] for i in (0, 1, 2, 3, 4, 6, 5, 7, 10, 11, 12, 13, 9, 8, 14, 17)]
    jax_args, port_args = _prepare_both(entries, 16)
    coords, ok, dig = run_body(pallas_rlc._k1_rlc_kernel, jax_args[:3],
                               [rlc.COORD_ROWS, 2 * rlc.M, rlc.DIG_ROWS])
    (tbl,) = run_body(pallas_rlc._k2_rlc_kernel, [coords], [rlc.TBL_ROWS])
    (out,) = run_body(pallas_rlc._k3_rlc_kernel, [tbl, dig, coords, ok, jax_args[3]], [1])
    return entries, jax_args, port_args, out[0].astype(bool), (coords, ok, dig, tbl)


def test_lane_verdicts_match_pallas_interpret(sixteen):
    entries, jax_args, port_args, jax_lanes, jax_k12 = sixteen
    for j, p in zip(jax_args, port_args):
        np.testing.assert_array_equal(j, p)
    a_t, r_t, scal_t, _ = (torch.from_numpy(np.ascontiguousarray(a)) for a in port_args)
    coords, ok, dig = rlc.k1_rlc_plain(a_t, r_t, scal_t)
    tbl = rlc.k2_rlc_plain(coords)
    for name, got, want in zip(("coords", "ok", "dig", "tbl"), (coords, ok, dig, tbl), jax_k12):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert jax_lanes.tolist() == [True, False, True, False]
    assert _lanes_port(port_args).tolist() == jax_lanes.tolist()


def test_all_small_order_lane_fast_accepts(sixteen):
    entries, _, port_args, _, _ = sixteen
    assert all(E.verify_zip215(*entries[i]) for i in range(8, 12))
    assert _lanes_port(port_args)[2]
    got = rlc.verify_batch_rlc(EntryBlock.from_entries(entries[8:12]), device="cpu")
    assert got.tolist() == [True] * 4


def test_per_signature_verdicts_match_oracle():
    """The whole battery plus two signatures, so the last lane straddles
    into padding slots: per-signature verdicts equal verify_zip215."""
    entries = _edge_entries() + _signed(2, 5)
    assert len(entries) % rlc.M
    oracle = [E.verify_zip215(*e) for e in entries]
    got = rlc.verify_batch_rlc(EntryBlock.from_entries(entries), device="cpu")
    assert got.tolist() == oracle
    assert any(oracle) and not all(oracle)


def test_tampered_lane_blames_only_the_bad_signature():
    entries = _signed(12, 9)
    pk, msg, sig = entries[6]
    bad = bytearray(sig)
    bad[40] ^= 0x10
    entries[6] = (pk, msg, bytes(bad))
    got = rlc.verify_batch_rlc(EntryBlock.from_entries(entries), device="cpu")
    assert got.tolist() == [i != 6 for i in range(12)]


def test_padding_lanes_verify():
    args = rlc.prepare_rlc(EntryBlock.from_entries(_signed(5, 11)), 32)
    a_t, r_t, scal_t, sok = args
    assert (a_t[np.arange(rlc.M) * 32, 2:] == 1).all()
    assert (r_t[np.arange(rlc.M) * 32, 2:] == 1).all()
    assert not scal_t[:, 2:].any() and (sok[:, 2:] == 1).all()
    assert _lanes_port(args).tolist() == [True] * 8


@pytest.mark.parametrize("g", [96, 3, 129, 0])
def test_lane_count_plan_bucket_would_not_give_raises(g):
    a = torch.zeros((rlc.M * 32, g), dtype=torch.uint8)
    s = torch.zeros((rlc.N_SCAL * 32, g), dtype=torch.uint8)
    with pytest.raises(ValueError, match="plan_bucket"):
        rlc.k1_rlc(a, a, s)
    with pytest.raises(ValueError, match="plan_bucket"):
        rlc.check_lanes(g)


@pytest.mark.parametrize("n", [1, 5, 100, 512, 513, 2048, 10000, 10240, 90000])
def test_plan_bucket_matches_jax(n):
    assert rlc.plan_bucket(n) == pallas_rlc.plan_bucket(n)[:2]
    _, g = rlc.plan_bucket(n)
    rlc.check_lanes(g)


def test_wrappers_check_dtype_shape_and_contiguity():
    g = 8
    a = torch.zeros((rlc.M * 32, g), dtype=torch.uint8)
    s = torch.zeros((rlc.N_SCAL * 32, g), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        rlc.k1_rlc(a.to(torch.int32), a, s)
    with pytest.raises(ValueError, match="must be"):
        rlc.k1_rlc(a, a[:-1], s)
    with pytest.raises(ValueError, match="contiguous"):
        rlc.k1_rlc(a, torch.zeros((g, rlc.M * 32), dtype=torch.uint8).T, s)
    with pytest.raises(ValueError, match="must be"):
        rlc.k2_rlc(torch.zeros((rlc.COORD_ROWS, g), dtype=torch.int64))


def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    kernels.reset_launches()
    args = rlc.prepare_rlc(EntryBlock.from_entries(_signed(4, 13)), 4)
    assert _lanes_port(args).tolist() == [True]
    assert set(kernels.LAUNCHES) >= {"k1_rlc", "k2_rlc", "k3_rlc"}
    assert set(kernels.LAUNCHES.values()) == {0}


def test_coefficients_are_fresh_per_batch():
    """Without z, every batch draws new coefficients: the z rows of the
    scalar array (and so the combined scalars) differ between calls."""
    block = EntryBlock.from_entries(_signed(8, 15))
    first = rlc.prepare_rlc(block, 8)[2]
    second = rlc.prepare_rlc(block, 8)[2]
    z_rows = slice((rlc.M + 1) * 32, rlc.N_SCAL * 32)
    assert first[z_rows].any()
    assert not np.array_equal(first[z_rows], second[z_rows])
    assert not np.array_equal(first[:32], second[:32])  # S
    # the top 16 bytes of every coefficient are zero (z < 2^128)
    for q in range(rlc.M + 1, rlc.N_SCAL):
        assert not first[q * 32 + 16 : (q + 1) * 32].any()


def test_explicit_z_is_checked():
    block = EntryBlock.from_entries(_signed(4, 17))
    with pytest.raises(ValueError, match="uint8"):
        rlc.prepare_rlc(block, 4, z=np.zeros((8, 32), dtype=np.uint8))
    big = np.zeros((4, 32), dtype=np.uint8)
    big[:, 20] = 1
    with pytest.raises(ValueError, match="2\\^128"):
        rlc.prepare_rlc(block, 4, z=big)
