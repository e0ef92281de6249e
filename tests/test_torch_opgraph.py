"""The op-graph ed25519 path (TM_TPU_PALLAS=0): ops/ed25519_verify.py,
its batch stages and backend switch, against the JAX package.

(a) og_verify_plain with the challenges hashed by the plain
    sha512_challenge equals the reference's verify_kernel_device_hash
    (jitted_verify_device_hash, bucket 128) on tests/test_ops.py's
    ZIP-215 edge battery (small-order and non-canonical keys, s >= L,
    random bytes), padding rows included, and the oracle verify_zip215;
    the host-hash route gives the same verdicts.
(b) og_verify_cached_plain equals the reference's verify_kernel_cached
    (jitted_verify_cached) on a set with a key that does not decompress.
(c) The switches: TM_TPU_PALLAS and TM_TPU_HOST_HASH read at each call,
    the reference's buckets, and the device-hash rule (a message past
    DEVICE_HASH_MAX_MSG takes the host challenges).
(d) verify_commit(..., device="cpu") with TM_TPU_PALLAS=0 on an
    80-validator commit (77 signatures, above DEVICE_THRESHOLD), cold and
    warm, device hash and host hash: the JAX package's result, blame
    string and power error; the fused prep builds RAM columns only on the
    device-hash route, and the RLC path's builds none.
Only two JAX ladders compile here (about 15 s each on this CPU); every
other verdict is checked against crypto._edwards.verify_zip215. The
reference's TM_TPU_PALLAS and TM_TPU_HOST_HASH are never set in this
process (its _use_pallas is cached and HOST_HASH read at import): its
preps and jitted kernels are called directly, and its verify_commit
runs its host batch verifier, whose results are the same strings.
Tolerance: none; verdicts and strings are equal.
"""

import dataclasses
import os
import random

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tendermint_tpu.crypto import _edwards as E  # noqa: E402
from tendermint_tpu.crypto import batch as jbatch  # noqa: E402
from tendermint_tpu.crypto import ed25519 as jed  # noqa: E402
from tendermint_tpu.ops import backend as jbackend  # noqa: E402
from tendermint_tpu.ops import ed25519_verify as jev  # noqa: E402
from tendermint_tpu.ops import entry_block as jeb  # noqa: E402
from tendermint_tpu.ops import epoch_cache as jep  # noqa: E402
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
from tendermint_tpu_torch.crypto import _edwards  # noqa: E402
from tendermint_tpu_torch.ops import backend, commit_prep, epoch_cache, pipeline  # noqa: E402
from tendermint_tpu_torch.ops import ed25519_verify as og  # noqa: E402
from tendermint_tpu_torch.ops.entry_block import EntryBlock  # noqa: E402
from tendermint_tpu_torch.types import validation  # noqa: E402
from tendermint_tpu_torch.types.block import BlockID, Commit  # noqa: E402

torch.set_num_threads(1)

CHAIN_ID = "opgraph-chain"
HEIGHT = 16
BUCKET = 128


def _edge_entries() -> list:
    """tests/test_ops.py's _edge_entries, built the same way: valid
    signatures, a corrupted signature, a wrong message, a corrupted key,
    s >= L, small-order keys with R = [s]B (accepted for any message),
    their non-canonical encodings (accepted), random bytes."""
    rng = random.Random(11)
    entries = []
    for i in range(6):
        sk = jed.gen_priv_key(bytes([i + 1]) * 32)
        msg = b"msg-%d" % i
        entries.append((sk.pub_key().bytes(), msg, sk.sign(msg)))
    sk = jed.gen_priv_key(bytes(32))
    msg, pub = b"hello", sk.pub_key().bytes()
    sig = sk.sign(msg)
    bad = bytearray(sig)
    bad[5] ^= 1
    entries.append((pub, msg, bytes(bad)))
    entries.append((pub, b"other", sig))
    badpub = bytearray(pub)
    badpub[3] ^= 1
    entries.append((bytes(badpub), msg, sig))
    bad_s = bytearray(sig)
    bad_s[32:] = (E.L + 5).to_bytes(32, "little")
    entries.append((pub, msg, bytes(bad_s)))
    small = []
    for y in range(50):
        for sgn in (0, 1):
            enc = bytearray(y.to_bytes(32, "little"))
            enc[31] |= sgn << 7
            pt = E.decompress(bytes(enc))
            if pt is not None and E.is_identity(E.mult_by_cofactor(pt)):
                small.append(bytes(enc))
    for enc in small[:3]:
        s = rng.randrange(0, E.L)
        r = E.compress(E.scalar_mult(s, E.BASE))
        entries.append((enc, b"anything", r + s.to_bytes(32, "little")))
    for enc in small:
        y = int.from_bytes(enc, "little") & ((1 << 255) - 1)
        if y < 19:
            enc2 = ((y + E.P) | ((enc[31] >> 7) << 255)).to_bytes(32, "little")
            s = rng.randrange(0, E.L)
            r = E.compress(E.scalar_mult(s, E.BASE))
            entries.append((enc2, b"nc", r + s.to_bytes(32, "little")))
    for _ in range(3):
        entries.append((rng.randbytes(32), rng.randbytes(20), rng.randbytes(64)))
    return entries


@pytest.fixture(scope="module")
def edge():
    ents = _edge_entries()
    want = [_edwards.verify_zip215(*e) for e in ents]
    assert True in want and False in want
    return ents, want


def _run(batch) -> np.ndarray:
    """The batch's launch and conclude on the CPU (the plain versions),
    padding rows kept."""
    return batch.launch([torch.from_numpy(a) for a in batch.args]).numpy()


# -- (a), (b) the kernels' plain versions against the reference's kernels ---------


def test_og_verify_device_hash_equals_reference_kernel(edge):
    """The port's device-hash batch (R || A || M laid out columnar, k by
    the plain sha512_challenge, then og_verify_plain) against the JAX
    package's verify_kernel_device_hash at bucket 128, every row."""
    ents, want = edge
    batch = og.prepare_batch(EntryBlock.from_entries(ents), device_hash=True)
    assert batch.bucket == BUCKET and len(batch.args) == 7
    got = _run(batch)
    ref = np.asarray(jev.jitted_verify_device_hash()(
        *jbackend.prepare_batch_device_hash(ents, BUCKET)))
    assert got.astype(bool).tolist() == ref.tolist()
    assert got[: len(ents)].astype(bool).tolist() == want and got[len(ents):].all()


def test_og_verify_host_hash_equals_the_oracle(edge):
    ents, want = edge
    batch = og.prepare_batch(EntryBlock.from_entries(ents), device_hash=False)
    assert len(batch.args) == 5 and batch.args[3].shape == (BUCKET, 32)
    got = _run(batch)
    assert got[: len(ents)].astype(bool).tolist() == want and got[len(ents):].all()


def test_og_verify_cached_equals_reference_kernel(edge):
    """A warm set holding every key of the battery and one more that does
    not decompress (y = 2 is on no point), in sorted order, not the
    signatures': the port's cached batch (A from the epoch table) against
    the JAX package's verify_kernel_cached."""
    ents, want = edge
    ents = ents + [((2).to_bytes(32, "little"), ents[0][1], ents[0][2])]
    want = want + [False]
    keys = sorted({p for p, _, _ in ents})
    row = {k: i for i, k in enumerate(keys)}
    assert [k for k in keys if _edwards.decompress(k) is None] == [ents[-1][0]]
    pub_col = np.frombuffer(b"".join(keys), np.uint8).reshape(-1, 32)
    idx = np.array([row[p] for p, _, _ in ents], np.int32)
    ep = epoch_cache.EpochEntry(b"opgraph set", pub_col)
    block = EntryBlock(*(getattr(EntryBlock.from_entries(ents), k)
                         for k in ("pub", "sig", "msgs", "offsets")),
                       val_idx=idx, epoch_key=ep.key)
    cold = og.prepare_batch(EntryBlock.from_entries(ents), device_hash=False)
    args = (epoch_cache.table_columns(block, BUCKET, ep),) + cold.args[1:]
    got = _run(og.OgBatch(block, BUCKET, ep, False, args))
    jblock = jeb.EntryBlock.from_entries(ents)
    jblock.val_idx = idx
    jentry = jep.EpochEntry(b"opgraph set", pub_col)
    ref = np.asarray(jev.jitted_verify_cached()(
        *jentry.xla_tables(), *jbackend.prepare_batch_cached(jblock, BUCKET, jentry)))
    assert got.astype(bool).tolist() == ref.tolist()
    assert got[: len(ents)].astype(bool).tolist() == want and got[len(ents):].all()


# -- (c) the switches -----------------------------------------------------------------


def test_switches_are_read_at_each_call(monkeypatch):
    monkeypatch.delenv("TM_TPU_PALLAS", raising=False)
    monkeypatch.delenv("TM_TPU_HOST_HASH", raising=False)
    assert backend.use_pallas() and not backend.host_hash()
    monkeypatch.setenv("TM_TPU_PALLAS", "0")
    assert not backend.use_pallas()
    assert [backend.quantized_bucket(n) for n in (1, 128, 129, 1024, 1025, 10240, 20000)] == [
        jbackend._bucket_for(n) for n in (1, 128, 129, 1024, 1025, 10240, 20000)] == [
        128, 128, 1024, 1024, 10240, 10240, 10240]
    assert backend.max_coalesce() == 10240
    monkeypatch.setenv("TM_TPU_RLC", "1")
    assert backend.quantized_bucket(100) == 128  # RLC is a Pallas-path choice
    monkeypatch.setenv("TM_TPU_HOST_HASH", "1")
    assert backend.host_hash()
    monkeypatch.setenv("TM_TPU_PALLAS", "1")
    assert backend.use_pallas() and backend.max_coalesce() == backend.rlc.MAX_SIGS


@pytest.mark.parametrize("host_hash", ["0", "1"])
def test_device_hash_rule(monkeypatch, host_hash):
    """The dispatcher's host stage on the op-graph path: a batch whose
    longest message is DEVICE_HASH_MAX_MSG bytes hashes on the card unless
    TM_TPU_HOST_HASH=1; one byte more takes the host challenges."""
    monkeypatch.setenv("TM_TPU_PALLAS", "0")
    monkeypatch.setenv("TM_TPU_HOST_HASH", host_hash)
    m = commit_prep.DEVICE_HASH_MAX_MSG
    for length, device in ((m, host_hash == "0"), (m + 1, False)):
        ents = [(bytes([1]) + bytes(31), bytes(length), bytes(64)), (bytes(32), b"", bytes(64))]
        batch = backend.prepare_ed25519(EntryBlock.from_entries(ents))
        assert isinstance(batch, og.OgBatch) and batch.device_hash == device
        assert len(batch.args) == (7 if device else 5) and batch.bucket == BUCKET


# -- (d) the slice as a whole -------------------------------------------------------


@pytest.fixture(autouse=True)
def _jax_host_verifier(monkeypatch):
    monkeypatch.setattr(jbatch, "_device_verifier_factory", None)


@pytest.fixture(scope="module")
def signed():
    """(JValidatorSet, JBlockID, signed JCommit) of 80 validators, two
    absent and one voting nil: 77 signatures, one bucket of 128."""
    rng = np.random.default_rng(16)
    n = 80
    sks = [jed.gen_priv_key(rng.bytes(32)) for _ in range(n)]
    vset = JValidatorSet.new([JValidator.new(sk.pub_key(), int(p))
                              for sk, p in zip(sks, rng.integers(1, 100, n))])
    by_addr = {sk.pub_key().address(): sk for sk in sks}
    bid = JBlockID(hash=bytes([16]) * 32, part_set_header=JPartSetHeader(
        total=1, hash=bytes([17]) * 32))
    sigs = []
    for i, v in enumerate(vset.validators):
        if i in (5, 31):
            sigs.append(JCommitSig.absent())
        else:
            flag = BLOCK_ID_FLAG_NIL if i == 9 else BLOCK_ID_FLAG_COMMIT
            sigs.append(JCommitSig(flag, v.address, JTimestamp(1_700_000_000 + i, 7 * i), b""))
    commit = JCommit(height=HEIGHT, round=0, block_id=bid, signatures=sigs)
    commit.signatures = [
        cs if cs.is_absent() else dataclasses.replace(
            cs, signature=by_addr[cs.validator_address].sign(commit.vote_sign_bytes(CHAIN_ID, i)))
        for i, cs in enumerate(sigs)
    ]
    return vset, bid, commit


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome under test is the exception itself
        return type(e).__name__, str(e)
    return None


def _tampered(jc: JCommit, idx: int) -> JCommit:
    sigs = list(jc.signatures)
    bad = bytearray(sigs[idx].signature)
    bad[40] ^= 0x10
    sigs[idx] = dataclasses.replace(sigs[idx], signature=bytes(bad))
    return JCommit(jc.height, jc.round, jc.block_id, sigs)


@pytest.mark.parametrize("route", ["device_hash", "host_hash"])
def test_verify_commit_on_the_op_graph_path(signed, monkeypatch, route):
    """Cold then warm on one set: the valid commit, a tampered one and
    one below 2/3, each against the JAX package's verify_commit. Every
    batch takes the op-graph stage (a spy on ed25519_verify.prepare_batch),
    on the route asked, cold then warm, the device-hash route from the
    fused prep's RAM columns."""
    monkeypatch.setenv("TM_TPU_PALLAS", "0")
    monkeypatch.setenv("TM_TPU_HOST_HASH", "1" if route == "host_hash" else "0")
    seen = []
    real = og.prepare_batch

    def spy(entries, device_hash):
        batch = real(entries, device_hash)
        seen.append((device_hash, entries.ram_hi is not None, batch.ep is not None))
        return batch

    monkeypatch.setattr(og, "prepare_batch", spy)
    vset, bid, jc = signed
    pvals, pc = convert.state_from_wire(vset.encode(), jc.encode())
    pbid = BlockID.decode(bid.encode())
    jbad = _tampered(jc, 3)
    jlow = JCommit(jc.height, jc.round, jc.block_id, [
        JCommitSig.absent() if i % 3 else cs for i, cs in enumerate(jc.signatures)])
    cases = (("valid", jc), ("tampered", jbad), ("low", jlow))
    try:
        # the epoch cache off: every call cold; then on: the set's first
        # call cold, the next ones warm
        for depth, calls in ((0, cases), (epoch_cache.DEFAULT_DEPTH, cases[:1] + cases)):
            epoch_cache.reset(depth=depth)
            for name, jcase in calls:
                want = _outcome(lambda: jvalidation.verify_commit(CHAIN_ID, vset, bid, HEIGHT,
                                                                  jcase))
                got = _outcome(lambda: validation.verify_commit(
                    CHAIN_ID, pvals, pbid, HEIGHT, Commit.decode(jcase.encode()), device="cpu"))
                assert got == want, (name, depth)
            assert want[0] == "ErrNotEnoughVotingPowerSigned"
    finally:
        epoch_cache.reset()
        pipeline.reset_shared()
    assert _outcome(lambda: jvalidation.verify_commit(CHAIN_ID, vset, bid, HEIGHT, jbad))[1] \
        .startswith("wrong signature (#3): ")
    d = route == "device_hash"
    assert seen == [(d, d, False)] * 3 + [(d, d, True)] * 2


def test_rlc_path_builds_no_ram_columns(signed, monkeypatch):
    """TM_TPU_PALLAS unset: the fused prep is asked for no RAM columns."""
    monkeypatch.delenv("TM_TPU_PALLAS", raising=False)
    asked = []
    real = commit_prep.prep_commit_from

    def spy(*a, **k):
        asked.append(k.get("ram", False))
        return real(*a, **k)

    monkeypatch.setattr(commit_prep, "prep_commit_from", spy)
    vset, bid, jc = signed
    pvals, pc = convert.state_from_wire(vset.encode(), jc.encode())
    got = validation._fused_commit_prep(CHAIN_ID, pvals, pc, 10**9, validation._ignore_absent,
                                        validation._count_for_block, True)
    assert asked == [False] and got[2] is None  # below the threshold: no block
    monkeypatch.setenv("TM_TPU_PALLAS", "0")
    got = validation._fused_commit_prep(CHAIN_ID, pvals, pc, 0, validation._ignore_absent,
                                        validation._count_for_block, True)
    assert asked == [False, True] and got[2].ram_hi is not None
    monkeypatch.setenv("TM_TPU_HOST_HASH", "1")
    got = validation._fused_commit_prep(CHAIN_ID, pvals, pc, 0, validation._ignore_absent,
                                        validation._count_for_block, True)
    assert asked[-1] is False and got[2].ram_hi is None
