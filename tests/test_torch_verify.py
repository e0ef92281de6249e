"""The port's per-signature path (tendermint_tpu_torch/ops/verify.py) on
the CPU against the JAX package's (tendermint_tpu/ops/pallas_verify.py)
and the ZIP-215 oracle.

- prepare_compact: byte-equal to the JAX prepare_compact; the bucket
  rule equal to backend._pallas_bucket.
- K1, K2: the plain versions equal the JAX kernel bodies run eagerly
  (tests/pallas_bodies.py) limb for limb, at 16 signatures.
- K3: verdicts equal to verify_zip215, the plain reference the JAX
  package's own Pallas tests hold its kernels to (tests/test_pallas.py),
  over the edge battery, padding and a tampered signature.
- The batch path: TM_TPU_RLC=0 routes the device verifier here, and a
  64-signature commit gives the same verdicts and blame as under RLC and
  as the JAX package.

Tolerance: none; every compared value is an integer or a flag.
"""

import os

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pallas_bodies import run_body  # noqa: E402
from test_ops import _edge_entries  # noqa: E402
from test_torch_commit import CHAIN_ID, _both, _make, _outcome, _tampered  # noqa: E402
from tendermint_tpu.crypto import _edwards as E  # noqa: E402
from tendermint_tpu.crypto import batch as jbatch  # noqa: E402
from tendermint_tpu.ops import backend as jbackend  # noqa: E402
from tendermint_tpu.ops import pallas_verify as pv  # noqa: E402
from tendermint_tpu.types.block import Commit as JCommit  # noqa: E402
from tendermint_tpu.types.block import CommitSig as JCommitSig  # noqa: E402
from tendermint_tpu_torch import convert  # noqa: E402
from tendermint_tpu_torch.ops import backend, epoch_cache, kernels, rlc, verify  # noqa: E402
from tendermint_tpu_torch.ops.entry_block import EntryBlock  # noqa: E402
from tendermint_tpu_torch.types import validation  # noqa: E402
from tendermint_tpu_torch.types.block import BlockID  # noqa: E402

# The plain versions run thousands of small tensor ops: one intra-op
# thread keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cold_cache():
    """The epoch cache off: these tests are about the path switch."""
    epoch_cache.reset(depth=0)
    yield
    epoch_cache.reset()


def _tamper(entry):
    pk, msg, sig = entry
    return pk, msg, sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:]


def _tensors(args):
    return [torch.from_numpy(np.array(a)) for a in args]


@pytest.fixture(scope="module")
def sixteen():
    """16 signatures: valid ones, a corrupted signature, a wrong message,
    a corrupted key, s >= L, small-order and non-canonical keys, random
    bytes; the JAX K1 and K2 bodies' outputs on them."""
    e = _edge_entries()
    entries = [e[i] for i in (0, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 1)]
    args = pv.prepare_compact(entries, 16)
    k1 = run_body(pv._k1_decompress_kernel, args[:4],
                  [verify.COORD_ROWS, 2, verify.DIG_ROWS, verify.DIG_ROWS])
    (tbl,) = run_body(pv._k2_table_kernel, [k1[0]], [verify.TBL_ROWS])
    return entries, args, k1, tbl


@pytest.mark.parametrize("n, bucket", [(20, 24), (20, 512), (0, 512)])
def test_prepare_compact_byte_equal_to_jax(n, bucket):
    entries = _edge_entries()[:n]
    want = pv.prepare_compact(entries, bucket)
    got = verify.prepare_compact(EntryBlock.from_entries(entries), bucket)
    assert len(got) == len(want) == 5
    for j, p in zip(want, got):
        assert j.dtype == p.dtype and j.shape == p.shape
        np.testing.assert_array_equal(j, p)


@pytest.mark.parametrize("n", [1, 64, 512, 513, 1500, 10240, 20000])
def test_bucket_rule_matches_jax(n):
    assert verify.bucket_for(n) == jbackend._pallas_bucket(n)


def test_k1_decompress_matches_jax_body(sixteen):
    _, args, want, _ = sixteen
    got = verify.k1_decompress(*_tensors(args[:4]))
    for name, g, w in zip(("coords", "ok", "sdig", "kdig"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert not want[1].all() and want[1].any()  # some keys fail to decompress


def test_k2_table_matches_jax_body(sixteen):
    _, _, k1, want = sixteen
    got = verify.k2_table(*_tensors(k1[:1]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_k3_verdicts_match_oracle_with_padding():
    """The whole battery, a tampered signature and 5 padding signatures:
    K1-K3 verdicts equal verify_zip215, padding verifies."""
    entries = _edge_entries() + [_tamper(_edge_entries()[2])]
    n = len(entries)
    args = verify.prepare_compact(EntryBlock.from_entries(entries), n + 5)
    coords, ok, sdig, kdig = verify.k1_decompress(*_tensors(args[:4]))
    tbl = verify.k2_table(coords)
    out = verify.k3_ladder(tbl, sdig, kdig, coords, ok, _tensors(args[4:])[0])
    got = out.numpy()[0].astype(bool)
    oracle = [E.verify_zip215(*e) for e in entries]
    assert got[:n].tolist() == oracle
    assert got[n:].all()
    assert any(oracle) and not all(oracle) and not oracle[-1]


def test_verify_batch_compact_matches_oracle():
    """The battery padded to one bucket of 512 through the batch path:
    verdicts equal verify_zip215; an empty block gives none."""
    entries = _edge_entries() + [_tamper(_edge_entries()[0])]
    block = EntryBlock.from_entries(entries)
    got = verify.verify_batch_compact(block, device="cpu")
    assert got.tolist() == [E.verify_zip215(*e) for e in entries]
    assert verify.verify_batch_compact(block[:0], device="cpu").shape == (0,)


def test_verify_compact_rejects_a_batch_off_the_block():
    args = _tensors(verify.prepare_compact(EntryBlock.from_entries(_edge_entries()[:4]), 8))
    with pytest.raises(ValueError, match="BLOCK"):
        verify.verify_compact(*args)


def test_wrappers_check_and_launch_nothing_on_the_cpu():
    kernels.reset_launches()
    a = torch.zeros((32, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        verify.k1_decompress(a.to(torch.int32), a, a, a)
    with pytest.raises(ValueError, match="must be"):
        verify.k2_table(torch.zeros((verify.COORD_ROWS, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        verify.k1_decompress(a, torch.zeros((8, 32), dtype=torch.uint8).T, a, a)
    verify.k1_decompress(a, a, a, a)
    assert set(kernels.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("env, path", [(None, "rlc"), ("1", "rlc"), ("0", "per_sig"),
                                        ("2", "rlc")])
def test_tm_tpu_rlc_picks_the_path_at_call_time(env, path, monkeypatch):
    if env is None:
        monkeypatch.delenv("TM_TPU_RLC", raising=False)
    else:
        monkeypatch.setenv("TM_TPU_RLC", env)
    assert backend.use_rlc() == (path == "rlc")
    calls = []

    class AllValid:
        """A prepared batch whose launch gives every row valid."""

        bucket = 1
        args = (np.zeros(1, np.uint8),)

        def __init__(self, n):
            self.n = n

        def launch(self, dev_args):
            return torch.ones((1, self.n), dtype=torch.int32)

        def conclude(self, row):
            return row[0].astype(bool)

    # the dispatcher's host stage of each path
    monkeypatch.setattr(rlc, "prepare_batch", lambda b: calls.append("rlc") or AllValid(len(b)))
    monkeypatch.setattr(verify, "prepare_batch",
                        lambda b: calls.append("per_sig") or AllValid(len(b)))
    bv = backend.Ed25519DeviceBatchVerifier(device=torch.device("cpu"))
    entries = _edge_entries()
    bv.add_block(EntryBlock.from_entries(entries * (backend.DEVICE_THRESHOLD // len(entries) + 1)))
    assert bv.verify()[0]
    assert calls == [path]


@pytest.fixture(scope="module")
def commit64():
    """64 validators, all signing: the smallest commit that reaches the
    device verifier (backend.DEVICE_THRESHOLD)."""
    return _make(64, 21)


def _low_power(commit):
    sigs = [JCommitSig.absent() if i % 3 else cs for i, cs in enumerate(commit.signatures)]
    return JCommit(commit.height, commit.round, commit.block_id, sigs)


@pytest.mark.parametrize("case", ["valid", "tampered", "low_power"])
def test_commit_per_signature_matches_rlc_and_jax(case, commit64, monkeypatch):
    """verify_commit with TM_TPU_RLC=0 against the RLC path and the JAX
    package's host path: the same outcome and blame string."""
    monkeypatch.setattr(jbatch, "_device_verifier_factory", None)
    vset, bid, commit = commit64
    commit = {"valid": commit, "tampered": _tampered(commit, 37),
              "low_power": _low_power(commit)}[case]
    monkeypatch.setenv("TM_TPU_RLC", "1")
    want, rlc_got = _both("verify_commit", vset, bid, commit.height, commit)
    monkeypatch.setenv("TM_TPU_RLC", "0")
    pvals, pcommit = convert.state_from_wire(vset.encode(), commit.encode())
    per_sig_got = _outcome(lambda: validation.verify_commit(
        CHAIN_ID, pvals, BlockID.decode(bid.encode()), commit.height, pcommit, device="cpu"))
    assert rlc_got == want and per_sig_got == want
    outcomes = {"1": rlc_got, "0": per_sig_got}
    assert outcomes["0"] == outcomes["1"]
    if case == "valid":
        assert outcomes["0"] is None
    else:
        prefix = {"tampered": "wrong signature (#37): ",
                  "low_power": "invalid commit -- insufficient"}[case]
        assert outcomes["0"][1].startswith(prefix)
