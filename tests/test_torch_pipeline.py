"""The port's asynchronous dispatcher (tendermint_tpu_torch/ops/pipeline.py,
ops/device_pool.py) on the CPU, against the JAX package's
(tendermint_tpu/ops/pipeline.py).

Most scheduling tests run a stage stand-in (`Tagged`: a prepared batch
whose verdict of row i is whether pub[i, 0] is odd, and whose launch
can wait on a gate) instead of the plain kernels, which cost about two
seconds a batch here. A few run the plain kernels end to end: the
verdict arrays of numpy-seeded batches against the JAX package's
AsyncBatchVerifier, and verify_commits_pipelined and
verify_headers_pipelined against the JAX package's, with the largest
batch made 16 signatures on both sides so jobs straddle two batches.
On the JAX side of those two the kernels are a stand-in (the host
oracle's verdicts, through the JAX dispatcher's own threads), which
keeps its XLA compiles out of this file; the verdicts are exact either
way.

Every future.result() and every join carries a timeout, every
verifier is closed in a finally or a fixture, and the shared verifiers
are reset around each test.
"""

import dataclasses
import hashlib
import os
import threading
import time

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tendermint_tpu.crypto import ed25519 as jed  # noqa: E402
from tendermint_tpu.ops import backend as jbackend  # noqa: E402
from tendermint_tpu.ops import pipeline as jpl  # noqa: E402
from tendermint_tpu.types.block import (  # noqa: E402
    BLOCK_ID_FLAG_ABSENT,
    Commit as JCommit,
    CommitSig as JCommitSig,
)
from tendermint_tpu_torch import convert  # noqa: E402
from tendermint_tpu_torch.crypto import _edwards  # noqa: E402
from tendermint_tpu_torch.ops import backend, device_pool, epoch_cache  # noqa: E402
from tendermint_tpu_torch.ops import pipeline as pl  # noqa: E402
from tendermint_tpu_torch.ops import verify as pverify  # noqa: E402
from tendermint_tpu_torch.ops.entry_block import EntryBlock  # noqa: E402
from tendermint_tpu_torch.types.block import BlockID  # noqa: E402
from tests.test_torch_light import CHAIN_ID, _block, _vset  # noqa: E402

# The plain versions run thousands of small tensor ops: one intra-op
# thread keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

WAIT = 60  # seconds any one future or join may take


@pytest.fixture(autouse=True)
def _fresh_shared():
    pl.reset_shared()
    epoch_cache.reset()
    yield
    pl.reset_shared()
    epoch_cache.reset()


# -- the stage stand-in --------------------------------------------------------


class Tagged:
    """A prepared batch: row i is valid iff pub[i, 0] is odd. Its launch
    records the batch's first tag byte (pub[0, 1]) in `log` and waits on
    `gate` when one is set; its conclude waits on `hold` when set."""

    def __init__(self, entries, log, gate=None, hold=None, fail_launch=False):
        self.entries = entries
        self.bucket = len(entries)
        self.args = (np.ascontiguousarray(entries.pub[:, 0]),)
        self.tag = int(entries.pub[0, 1])
        self._log, self._gate, self._hold = log, gate, hold
        self._fail = fail_launch

    def launch(self, dev_args):
        self._log.append(self.tag)
        if self._gate is not None:
            assert self._gate.wait(WAIT)
        if self._fail:
            raise RuntimeError("launch exploded")
        return (dev_args[0] % 2 == 1).to(torch.int32)[None, :]

    def conclude(self, row):
        if self._hold is not None:
            assert self._hold.wait(WAIT)
        return row[0].astype(bool)


def _block_of(n: int, tag: int, valid=None, key=None) -> EntryBlock:
    """n rows tagged `tag`; row i valid unless valid says otherwise."""
    valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    pub = np.zeros((n, 32), np.uint8)
    pub[:, 0] = np.where(valid, 1, 2)
    pub[:, 1] = tag
    return EntryBlock(pub, np.zeros((n, 64), np.uint8), b"", np.zeros(n + 1, np.int64),
                      epoch_key=key)


def _verifier(log, **kw):
    gate = kw.pop("gate", None)
    hold = kw.pop("hold", None)
    fail = kw.pop("fail", ())

    def prepare(entries):
        if len(entries) in fail:
            raise ValueError("prep exploded")
        return Tagged(entries, log, gate if int(entries.pub[0, 1]) == 0 else None,
                      hold if int(entries.pub[0, 1]) == 0 else None)

    return pl.AsyncBatchVerifier("cpu", prepare=prepare, **kw)


def _until(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


# -- behaviour -------------------------------------------------------------------


def test_batches_launch_in_arrival_order():
    """One class: a batch queued behind a launch waits its turn, and the
    jobs of different epochs launch in the order they came."""
    log, gate = [], threading.Event()
    v = _verifier(log, depth=1, gate=gate)
    try:
        first = v.submit(_block_of(4, 0, key=b"a"))
        _until(lambda: log == [0], "the first launch")
        queued = [v.submit(_block_of(4, t, key=bytes([t]))) for t in (1, 2, 3)]
        _until(lambda: v._dispatch_q.qsize() >= 2, "batches queued behind the launch")
        gate.set()
        for f in [first] + queued:
            assert f.result(timeout=WAIT).all()
        assert log == [0, 1, 2, 3]
    finally:
        gate.set()
        v.close()


def test_two_layouts_under_backlog_never_stall_the_dispatcher():
    """One slot per layout and two launch slots: a backlog of batches of
    two layouts (8 and 12 rows, distinct epochs so none fuse) from four
    callers all resolve, and every slot comes back. The dispatcher holds
    at most one unlaunched slot, so a wait for one always ends."""
    log = []
    v = _verifier(log, depth=2, pool_depth=1)
    try:
        futs = []

        def caller(t):
            for k in range(6):
                n = 8 if (t + k) % 2 else 12
                futs.append(v.submit(_block_of(n, 1 + t, key=bytes([t, k]))))

        threads = [threading.Thread(target=caller, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
        for f in futs:
            assert f.result(timeout=WAIT).all()
        assert len(futs) == 24 and len(log) == 24
        _until(lambda: v._pool.in_flight() == 0, "every slot back")
        assert v._pool.misses == 2
    finally:
        v.close()


def test_oversized_submit_is_split_and_rejoined():
    lens = []
    log = []

    def prepare(entries):
        lens.append(len(entries))
        return Tagged(entries, log)

    v = pl.AsyncBatchVerifier("cpu", prepare=prepare, max_batch=8)
    try:
        valid = np.arange(20) % 7 != 3
        got = v.submit(_block_of(20, 5, valid)).result(timeout=WAIT)
        assert got.tolist() == valid.tolist()
        assert sorted(lens) == [4, 8, 8]
        assert v.submit(_block_of(0, 5)).result(timeout=WAIT).shape == (0,)
    finally:
        v.close()


def test_a_failing_job_fails_alone_and_the_dispatcher_survives():
    log = []
    v = _verifier(log, depth=2, fail=(3,))
    try:
        bad = v.submit(_block_of(3, 1))
        with pytest.raises(pl.DispatchError) as ei:
            bad.result(timeout=WAIT)
        assert "batch prep failed" in str(ei.value)
        assert "bucket=0, epoch=uncached" in str(ei.value)
        assert isinstance(ei.value.__cause__, ValueError)
        assert v.submit(_block_of(5, 2)).result(timeout=WAIT).all()
        # a launch that raises fails its batch alone too
        v._prepare = lambda e: Tagged(e, log, fail_launch=len(e) == 6)
        with pytest.raises(pl.DispatchError, match="launch exploded") as ei:
            v.submit(_block_of(6, 3, key=b"\x09" * 8)).result(timeout=WAIT)
        assert "bucket=6, epoch=0909090909090909" in str(ei.value)
        assert v.submit(_block_of(5, 4)).result(timeout=WAIT).all()
        assert v._dispatch_thread.is_alive() and v._resolve_thread.is_alive()
        _until(lambda: v._pool.in_flight() == 0, "every slot back")
    finally:
        v.close()


def test_one_dispatch_thread():
    log = []
    v = _verifier(log)
    try:
        futs = []

        def caller(t):
            futs.extend(v.submit(_block_of(4, t, key=bytes([t]))) for _ in range(3))

        threads = [threading.Thread(target=caller, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
        for f in futs:
            assert f.result(timeout=WAIT).all()
        assert v.dispatch_thread_idents == {v._dispatch_thread.ident}
        assert threading.get_ident() not in v.dispatch_thread_idents
    finally:
        v.close()


def test_many_callers_under_a_short_switch_interval():
    """16 threads, distinct verdict patterns: each caller gets exactly
    its own verdicts and every slot comes back (a lost update in the
    shared counters or a mixed-up span would break one of these)."""
    import sys

    log = []
    v = _verifier(log, depth=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    got, want = {}, {}
    try:
        def caller(t):
            rng = np.random.default_rng(t)
            for k in range(6):
                valid = rng.random(5 + t % 7) < 0.6
                f = v.submit(_block_of(len(valid), 1 + t, valid, key=bytes([t % 3])))
                want[(t, k)] = valid.tolist()
                got[(t, k)] = f.result(timeout=WAIT).tolist()

        threads = [threading.Thread(target=caller, args=(t,)) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        v.close()
    assert got == want and len(got) == 96
    assert v._pool.in_flight() == 0


def test_delivered_verdicts_stay_unchanged_after_later_batches():
    """Fault class 1: the verdicts of the first batches are host-owned
    copies, not views of the readback buffers the later batches reuse."""
    log = []
    v = _verifier(log, depth=1, pool_depth=1)
    try:
        rng = np.random.default_rng(13)
        first = []
        for t in range(3):
            valid = rng.random(16) < 0.5
            first.append((valid, v.submit(_block_of(16, t + 1, valid)).result(timeout=WAIT)))
        for t in range(8):
            v.submit(_block_of(16, t + 4, rng.random(16) < 0.5)).result(timeout=WAIT)
        for valid, got in first:
            assert got.flags.owndata
            assert got.tolist() == valid.tolist()
        assert v._pool.misses == 1 and v._pool.hits == 10
    finally:
        v.close()


def test_close_returns_within_its_timeouts():
    log = []
    v = _verifier(log)
    v.submit(_block_of(4, 1)).result(timeout=WAIT)
    t0 = time.monotonic()
    v.close()
    assert time.monotonic() - t0 < 2.0
    for t in (v._thread, v._dispatch_thread, v._resolve_thread):
        assert not t.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        v.submit(_block_of(4, 1))


def test_pool_transfer_and_readback_on_the_cpu():
    pool = device_pool.DeviceBufferPool(2, torch.device("cpu"))
    args = (np.arange(6, dtype=np.int32).reshape(2, 3), np.ones(4, np.uint8))
    key = device_pool.layout_key(8, args)
    slot = pool.acquire(key, args)
    dev = device_pool.transfer(slot, args)
    assert [d.tolist() for d in dev] == [a.tolist() for a in args]
    assert device_pool.read_back(slot, dev[0] * 2) is None
    got = device_pool.owned_verdicts(slot)
    slot.readback.zero_()
    assert got.tolist() == (args[0] * 2).tolist()
    pool.release(slot)
    assert pool.acquire(key, args) is slot and (pool.hits, pool.misses) == (1, 1)
    pool.release(slot)
    assert pool.in_flight() == 0


def test_default_verifier_submits_through_the_shared_dispatcher(monkeypatch):
    """backend.py:1048-1055: from DEVICE_THRESHOLD to BUCKETS[-1]
    signatures the ed25519 verifier waits on shared_verifier(device)."""
    log = []
    monkeypatch.setattr(backend, "prepare_ed25519", lambda e: Tagged(e, log))
    bv = backend.Ed25519DeviceBatchVerifier(device=torch.device("cpu"))
    valid = np.arange(backend.DEVICE_THRESHOLD) != 5
    bv.add_block(_block_of(backend.DEVICE_THRESHOLD, 7, valid))
    ok, got = bv.verify()
    assert not ok and got == valid.tolist()
    assert log == [7]
    v = pl.shared_verifier("cpu")
    assert v is pl.shared_verifier(torch.device("cpu"))
    assert len(v.dispatch_thread_idents) == 1
    assert backend.BUCKETS == pverify.BUCKETS and backend.BUCKETS[-1] == 10240


def test_default_verifier_splits_an_oversized_block_in_the_dispatcher(monkeypatch):
    """A block above the batch cap goes through the shared dispatcher
    too, split into slices of the cap, and its verdicts come back joined
    in order (the reference verifies it synchronously in the same
    chunks)."""
    lens = []

    def prepare(entries):
        lens.append(len(entries))
        return Tagged(entries, [])

    monkeypatch.setattr(backend, "prepare_ed25519", prepare)
    monkeypatch.setattr(backend, "max_coalesce", lambda scheme="ed25519": 64)
    bv = backend.Ed25519DeviceBatchVerifier(device=torch.device("cpu"))
    valid = np.arange(150) % 11 != 4
    bv.add_block(_block_of(150, 9, valid))
    ok, got = bv.verify()
    assert not ok and got == valid.tolist()
    assert sorted(lens) == [22, 64, 64]
    assert pl.shared_verifier("cpu").dispatch_thread_idents


# -- against the JAX package -------------------------------------------------------


def _signed(n: int, tag: int, bad=()):
    """n numpy-seeded (pub, msg, sig) triples, the rows in `bad` tampered."""
    rng = np.random.default_rng(tag)
    out = []
    for i in range(n):
        seed = hashlib.sha256(b"pipe %d %d" % (tag, i)).digest()
        msg = rng.bytes(int(rng.integers(40, 140)))
        sig = _edwards.sign(seed, msg)
        if i in bad:
            sig = sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:]
        out.append((_edwards.pubkey_from_seed(seed), msg, sig))
    return out


BATCHES = [(8, 0, ()), (8, 1, (3,)), (8, 2, (0, 7))]


@pytest.fixture(scope="module")
def jax_verdicts():
    """The JAX package's dispatcher over BATCHES (its XLA kernels on the
    CPU)."""
    v = jpl.AsyncBatchVerifier(depth=2)
    try:
        futs = [v.submit(_signed(*b)) for b in BATCHES]
        return [np.asarray(f.result(timeout=300)).tolist() for f in futs]
    finally:
        v.close()


@pytest.mark.parametrize("rlc_env", ["1", "0"])
def test_verdicts_equal_the_jax_pipeline(jax_verdicts, rlc_env, monkeypatch):
    monkeypatch.setenv("TM_TPU_RLC", rlc_env)
    monkeypatch.setattr(pverify, "BLOCK", 16)  # the per-signature bucket: 16, not 512
    v = pl.AsyncBatchVerifier("cpu", depth=2)
    try:
        futs = [v.submit(EntryBlock.from_entries(_signed(*b))) for b in BATCHES]
        got = [f.result(timeout=WAIT).tolist() for f in futs]
    finally:
        v.close()
    assert got == jax_verdicts
    assert [r.count(False) for r in got] == [0, 1, 2]


def _oracle_prepare(entries):
    """The JAX dispatcher's _prepare with the host oracle as its kernel."""
    rows = np.array([jed.PubKey(p).verify_signature(m, s) for p, m, s in entries.iter_entries()],
                    dtype=bool)
    return (lambda: rows), (), None, len(entries)


@pytest.fixture
def small_batches(monkeypatch):
    """The largest pipelined batch made 16 signatures on both sides."""
    monkeypatch.setattr(jbackend, "BUCKETS", (16,))
    monkeypatch.setattr(backend, "BUCKETS", (16,))
    monkeypatch.setattr(jpl.AsyncBatchVerifier, "_prepare", staticmethod(_oracle_prepare))
    old = jpl._shared
    jpl._shared = None
    yield
    if jpl._shared is not None:
        jpl._shared.close()
    jpl._shared = old


@pytest.fixture(scope="module")
def range_chain():
    """Heights 1..6 of one 16-validator set (the light tests' chain
    builder), and 7 signed by another set."""
    v1, v2 = _vset(range(0, 16), 1), _vset(range(40, 56), 7)
    blocks, prev = {}, b""
    for h in range(1, 7):
        blocks[h] = _block(h, v1, v1, prev)
        prev = blocks[h].hash()
    blocks[7] = _block(7, v2, v2, prev)
    return blocks


def _tamper(commit, idx: int):
    sigs = list(commit.signatures)
    bad = bytearray(sigs[idx].signature)
    bad[40] ^= 0x10
    sigs[idx] = dataclasses.replace(sigs[idx], signature=bytes(bad))
    return JCommit(commit.height, commit.round, commit.block_id, sigs)


def _to_port(vset, commit):
    return convert.state_from_wire(vset.encode(), commit.encode())


def _selected(vset) -> int:
    """Signatures verify_commit_light selects from a full commit of vset
    (it stops past 2/3 of the power, in commit order)."""
    needed = vset.total_voting_power() * 2 // 3
    got = 0
    for i, v in enumerate(vset.validators):
        got += v.voting_power
        if got > needed:
            return i + 1
    raise AssertionError("the set cannot reach 2/3")


def test_verify_commits_pipelined_matches_jax(range_chain, small_batches):
    n = _selected(range_chain[1].validators)
    # jobs 1 and 2 take 2n signatures, so job 3 starts at 2n % 16 and
    # straddles two batches of 16; its last selected signature is bad
    assert (2 * n) // 16 != (3 * n - 1) // 16
    jobs = []
    for h in range(1, 7):
        sh, vset = range_chain[h].signed_header, range_chain[h].validators
        commit = sh.commit
        if h == 3:
            commit = _tamper(commit, n - 1)
        if h == 5:
            sigs = [JCommitSig(BLOCK_ID_FLAG_ABSENT) if i % 4 else cs
                    for i, cs in enumerate(commit.signatures)]
            commit = JCommit(commit.height, commit.round, commit.block_id, sigs)
        height = h + 100 if h == 4 else h
        jobs.append((vset, commit.block_id, height, commit))
    want = jpl.verify_commits_pipelined(CHAIN_ID, jobs)
    pjobs = []
    for vset, bid, height, commit in jobs:
        pvals, pcommit = _to_port(vset, commit)
        pjobs.append((pvals, BlockID.decode(bid.encode()), height, pcommit))
    v = pl.AsyncBatchVerifier("cpu")
    try:
        got = pl.verify_commits_pipelined(CHAIN_ID, pjobs, v)
    finally:
        v.close()
    assert got == want
    assert want[2] == f"wrong signature (entry {n - 1})"
    assert want[3].startswith("invalid commit height")
    assert want[4].startswith("invalid commit -- insufficient voting power")
    assert [w is None for w in want] == [True, True, False, False, False, True]


def _headers(blocks, heights, port: bool):
    out = []
    for h in heights:
        lb = blocks[h]
        if port:
            lb = convert.light_block_from_wire(lb.signed_header.header.encode(),
                                               lb.signed_header.commit.encode(),
                                               lb.validators.encode())
        out.append((lb.signed_header, lb.validators))
    return out


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome under test is the exception itself
        return type(e).__name__, str(e)
    return None


def test_verify_headers_pipelined_matches_jax(range_chain, small_batches):
    jtrusted = range_chain[1].signed_header
    ptrusted = _headers(range_chain, [1], True)[0][0]
    bad = dict(range_chain)
    lb = bad[5]
    bad[5] = dataclasses.replace(lb, signed_header=dataclasses.replace(
        lb.signed_header, commit=_tamper(lb.signed_header.commit, 2)))
    cases = [(range_chain, [2, 3, 4, 5, 6]), (bad, [2, 3, 4, 5, 6]),
             (range_chain, [2, 4]), (range_chain, [2, 3, 4, 5, 6, 7])]
    outcomes = []
    for blocks, heights in cases:
        want = _outcome(lambda: jpl.verify_headers_pipelined(
            CHAIN_ID, jtrusted, _headers(blocks, heights, False)))
        got = _outcome(lambda: pl.verify_headers_pipelined(
            CHAIN_ID, ptrusted, _headers(blocks, heights, True), device="cpu"))
        assert got == want
        outcomes.append(want)
    assert outcomes[0] is None
    assert outcomes[1][1].startswith("header 5: wrong signature (entry ")
    assert outcomes[2][1] == "headers must be adjacent: 4 after 2"
    assert outcomes[3][1] == "header 7 validators_hash breaks continuity"
