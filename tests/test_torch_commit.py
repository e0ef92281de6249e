"""The port's commit verification (tendermint_tpu_torch/types/
validation.py) against the JAX package's on the same commits.

Commits of 8 and 80 validators are built and signed with the JAX
package, carried into the port as their protobuf encodings
(convert.state_from_wire), and verified by both. The JAX side runs on its
host batch verifier (crypto.batch's device factory unset); the port runs
on device="cpu", where its 80-validator commits take the RLC batch path
through the plain versions of the kernels. Every case must give the same
outcome: None, or the same exception type and a byte-identical message.
"""

import dataclasses
import hashlib
import os

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tendermint_tpu.crypto import batch as jbatch  # noqa: E402
from tendermint_tpu.crypto import ed25519 as jed  # noqa: E402
from tendermint_tpu.types import validation as jvalidation  # noqa: E402
from tendermint_tpu.types.block import (  # noqa: E402
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    BlockID as JBlockID,
    Commit as JCommit,
    CommitSig as JCommitSig,
    PartSetHeader as JPartSetHeader,
)
from tendermint_tpu.types.validator_set import (  # noqa: E402
    Validator as JValidator,
    ValidatorSet as JValidatorSet,
)
from tendermint_tpu.wire.canonical import Timestamp as JTimestamp  # noqa: E402
from tendermint_tpu_torch import convert  # noqa: E402
from tendermint_tpu_torch.ops import backend, rlc  # noqa: E402
from tendermint_tpu_torch.types import validation  # noqa: E402
from tendermint_tpu_torch.types.block import BlockID  # noqa: E402

# The plain versions run thousands of small tensor ops: one intra-op
# thread keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

CHAIN_ID = "torch-port-chain"
HEIGHT = 12


@pytest.fixture(autouse=True)
def _jax_host_verifier(monkeypatch):
    monkeypatch.setattr(jbatch, "_device_verifier_factory", None)


def _make(n: int, seed: int, nil=(), absent=()):
    """(JValidatorSet, JBlockID, signed JCommit) of n validators with
    seeded powers; indices in `nil` vote nil, in `absent` are absent."""
    rng = np.random.default_rng(seed)
    sks = [jed.gen_priv_key(rng.bytes(32)) for _ in range(n)]
    powers = rng.integers(1, 100, n)
    vset = JValidatorSet.new(
        [JValidator.new(sk.pub_key(), int(p)) for sk, p in zip(sks, powers)]
    )
    by_addr = {sk.pub_key().address(): sk for sk in sks}
    h = hashlib.sha256(b"block %d" % seed).digest()
    bid = JBlockID(hash=h, part_set_header=JPartSetHeader(total=3, hash=h[::-1]))
    sigs = []
    for i, v in enumerate(vset.validators):
        if i in absent:
            sigs.append(JCommitSig.absent())
            continue
        flag = BLOCK_ID_FLAG_NIL if i in nil else BLOCK_ID_FLAG_COMMIT
        sigs.append(JCommitSig(flag, v.address, JTimestamp(1_700_000_000 + i, 7 * i), b""))
    commit = JCommit(height=HEIGHT, round=1, block_id=bid, signatures=sigs)
    signed = []
    for i, cs in enumerate(sigs):
        if not cs.is_absent():
            sk = by_addr[vset.validators[i].address]
            cs = dataclasses.replace(cs, signature=sk.sign(commit.vote_sign_bytes(CHAIN_ID, i)))
        signed.append(cs)
    commit.signatures = signed
    return vset, bid, commit


def _tampered(commit, idx: int):
    sigs = list(commit.signatures)
    bad = bytearray(sigs[idx].signature)
    bad[40] ^= 0x10
    sigs[idx] = dataclasses.replace(sigs[idx], signature=bytes(bad))
    return JCommit(commit.height, commit.round, commit.block_id, sigs)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome under test is the exception itself
        return type(e).__name__, str(e)
    return None


def _both(mode: str, vset, bid, height: int, commit):
    """(JAX outcome, port outcome) of verify_commit{,_light}."""
    jfn = getattr(jvalidation, mode)
    pfn = getattr(validation, mode)
    pvals, pcommit = convert.state_from_wire(vset.encode(), commit.encode())
    pbid = BlockID.decode(bid.encode())
    want = _outcome(lambda: jfn(CHAIN_ID, vset, bid, height, commit))
    got = _outcome(lambda: pfn(CHAIN_ID, pvals, pbid, height, pcommit, device="cpu"))
    return want, got


@pytest.fixture(scope="module")
def small():
    return _make(8, 1, nil=(2,), absent=(5,))


@pytest.fixture(scope="module")
def large():
    return _make(80, 2, nil=(9,), absent=(5, 31))


def _case(name: str, vset, bid, commit):
    """(vset, bid, height, commit, expected outcome prefix or None)."""
    if name == "valid":
        return vset, bid, HEIGHT, commit, None
    if name == "tampered":
        return vset, bid, HEIGHT, _tampered(commit, 3), "wrong signature (#3): "
    if name == "tampered_nil_vote":
        return vset, bid, HEIGHT, _tampered(commit, 2 if vset.size() < 80 else 9), None
    if name == "low_power":
        sigs = [JCommitSig.absent() if i % 3 else cs for i, cs in enumerate(commit.signatures)]
        low = JCommit(commit.height, commit.round, commit.block_id, sigs)
        return vset, bid, HEIGHT, low, "invalid commit -- insufficient voting power"
    if name == "wrong_set_size":
        other, _, _ = _make(vset.size() + 1, 99)
        return other, bid, HEIGHT, commit, "invalid commit -- wrong set size"
    if name == "wrong_height":
        return vset, bid, HEIGHT + 1, commit, "invalid commit height"
    if name == "wrong_block_id":
        other = JBlockID(hash=bytes(32), part_set_header=bid.part_set_header)
        return vset, other, HEIGHT, commit, "invalid commit -- wrong block ID"
    raise AssertionError(name)


CASES = ["valid", "tampered", "tampered_nil_vote", "low_power",
         "wrong_set_size", "wrong_height", "wrong_block_id"]


@pytest.mark.parametrize("mode", ["verify_commit", "verify_commit_light"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("size", ["small", "large"])
def test_verify_commit_matches_jax(size, case, mode, request):
    vset, bid, commit = request.getfixturevalue(size)
    vset, bid, height, commit, expect = _case(case, vset, bid, commit)
    want, got = _both(mode, vset, bid, height, commit)
    assert got == want
    if case == "tampered_nil_vote":
        # a nil vote is verified by verify_commit, skipped by the light walk
        expect = "wrong signature (#" if mode == "verify_commit" else None
    if expect is None:
        assert got is None
    else:
        assert got is not None and got[1].startswith(expect), got


def test_large_commit_takes_the_rlc_batch_path(large, monkeypatch):
    vset, bid, commit = large
    assert vset.size() >= backend.DEVICE_THRESHOLD
    calls = []
    real = rlc.prepare_batch  # the dispatcher's host stage on the RLC path
    monkeypatch.setattr(rlc, "prepare_batch",
                        lambda *a, **k: calls.append(len(a[0])) or real(*a, **k))
    _, got = _both("verify_commit", vset, bid, HEIGHT, _tampered(commit, 40))
    assert got[1].startswith("wrong signature (#40): ")
    assert calls == [vset.size() - 2]  # every signature but the two absent


def test_light_walk_stops_before_a_late_bad_signature(large):
    """verify_commit_light stops at +2/3: a bad signature past that point
    fails verify_commit only, in both packages."""
    vset, bid, commit = large
    bad = _tampered(commit, 79)
    assert _both("verify_commit_light", vset, bid, HEIGHT, bad) == (None, None)
    want, got = _both("verify_commit", vset, bid, HEIGHT, bad)
    assert got == want and got[1].startswith("wrong signature (#79): ")


def test_state_from_wire_round_trips(large):
    vset, _, commit = large
    pvals, pcommit = convert.state_from_wire(vset.encode(), commit.encode())
    assert pvals.encode() == vset.encode()
    assert pcommit.encode() == commit.encode()
    assert pvals.total_voting_power() == vset.total_voting_power()
    assert pvals.get_proposer().address == vset.get_proposer().address
    for i in range(len(commit.signatures)):
        assert pcommit.vote_sign_bytes(CHAIN_ID, i) == commit.vote_sign_bytes(CHAIN_ID, i)
    for_block = [i for i, cs in enumerate(commit.signatures) if cs.for_block()]
    for idxs in (for_block, list(range(len(commit.signatures)))):
        pbuf, poffs = pcommit.vote_sign_bytes_block(CHAIN_ID, idxs)
        jbuf, joffs = commit.vote_sign_bytes_block(CHAIN_ID, idxs)
        assert bytes(pbuf) == bytes(jbuf)
        np.testing.assert_array_equal(poffs, joffs)


def test_validator_set_new_matches_jax():
    """The port's ValidatorSet.new orders the set and picks the proposer
    as the JAX package does."""
    from tendermint_tpu_torch.crypto import ed25519 as ped
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

    rng = np.random.default_rng(4)
    seeds = [rng.bytes(32) for _ in range(20)]
    powers = [int(p) for p in rng.integers(1, 1000, 20)]
    jset = JValidatorSet.new([
        JValidator.new(jed.gen_priv_key(s).pub_key(), p) for s, p in zip(seeds, powers)
    ])
    pset = ValidatorSet.new([
        Validator.new(ped.gen_priv_key(s).pub_key(), p) for s, p in zip(seeds, powers)
    ])
    assert pset.encode() == jset.encode()
    assert pset.get_proposer().address == jset.get_proposer().address


def test_entries_from_arrays_builds_a_verifiable_block(small):
    vset, _, commit = small
    idxs = [i for i, cs in enumerate(commit.signatures) if not cs.is_absent()]
    buf, offsets = commit.vote_sign_bytes_block(CHAIN_ID, idxs)
    pub = np.stack([np.frombuffer(vset.validators[i].pub_key.bytes(), np.uint8) for i in idxs])
    sig = np.stack([np.frombuffer(commit.signatures[i].signature, np.uint8) for i in idxs])
    block = convert.entries_from_arrays(pub, sig, buf, offsets.astype(np.int32))
    assert len(block) == len(idxs)
    got = rlc.verify_batch_rlc(block, device="cpu")
    assert got.tolist() == [True] * len(idxs)
    with pytest.raises(ValueError, match="integers"):
        convert.entries_from_arrays(pub, sig, buf, offsets.astype(np.float64))


@pytest.mark.parametrize("n", [1, 5, 70])
def test_sign_bytes_block_matches_jax_composer(n):
    """Timestamps with zero, negative and multi-byte varint fields."""
    from tendermint_tpu.wire import canonical as jcanon
    from tendermint_tpu_torch.wire import canonical as pcanon

    rng = np.random.default_rng(n)
    secs = rng.choice([0, 1, -62135596800, 1_700_000_000, 2**40], n)
    nanos = rng.choice([0, 1, 999_999_999, 128], n)
    tpl = jcanon.canonical_vote_template(CHAIN_ID, 2, HEIGHT, 0, None)
    assert pcanon.canonical_vote_template(CHAIN_ID, 2, HEIGHT, 0, None) == tpl
    jts = [jcanon.Timestamp(int(s), int(ns)) for s, ns in zip(secs, nanos)]
    pts = [pcanon.Timestamp(int(s), int(ns)) for s, ns in zip(secs, nanos)]
    pbuf, poffs = pcanon.compose_vote_sign_bytes_block(tpl, pts)
    jbuf, joffs = jcanon.compose_vote_sign_bytes_block(tpl, jts)
    assert bytes(pbuf) == bytes(jbuf)
    np.testing.assert_array_equal(poffs, joffs)
    assert [bytes(pbuf[poffs[i]:poffs[i + 1]]) for i in range(n)] == [
        pcanon.compose_vote_sign_bytes(tpl, t) for t in pts
    ]
