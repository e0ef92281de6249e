"""The port's columnar commits, fused commit prep and host C helpers
(types/block.py, ops/commit_prep.py, ops/host.py over
csrc/host_prep.cpp) against their Python oracles and the JAX package.

(a) A commit decoded from the JAX package's wire bytes has the columns
    of the JAX commit_block(); its signatures are a lazy view that
    detaches on mutation; a non-canonical commit decodes to objects.
(b) prep_commit (the C call), the port's _prep_commit_numpy and the JAX
    package's prep_commit(..., ram_max_len=0) agree byte for byte over
    every mode and ABSENT/NIL/COMMIT mix, at thresholds around the tally.
(c) Each C helper equals its Python oracle and the JAX native function
    (where tendermint_tpu.native.load() gives a module) on the same
    buffers, with the host library on 1 and on 4 threads.
(d) verify_commit and verify_commit_light on device="cpu" reach the JAX
    package's verdicts, errors and blame with the Python and numpy
    oracles made to raise, so the fused C path is the one that ran;
    a tampered signature is blamed exactly whether the commit was
    decoded and then mutated or built from a list and then mutated.
"""

import dataclasses
import hashlib
import os

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tendermint_tpu import native as jnative  # noqa: E402
from tendermint_tpu.crypto import batch as jbatch  # noqa: E402
from tendermint_tpu.crypto import ed25519 as jed  # noqa: E402
from tendermint_tpu.ops import commit_prep as jcp  # noqa: E402
from tendermint_tpu.types import validation as jvalidation  # noqa: E402
from tendermint_tpu.types.block import (  # noqa: E402
    BLOCK_ID_FLAG_ABSENT,
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
from tendermint_tpu_torch.crypto._edwards import L  # noqa: E402
from tendermint_tpu_torch.ops import backend, commit_prep, epoch_cache, host, rlc  # noqa: E402
from tendermint_tpu_torch.types import validation  # noqa: E402
from tendermint_tpu_torch.types.block import (  # noqa: E402
    BlockID,
    Commit,
    CommitSigs,
    _commit_sig_columns,
)
from tendermint_tpu_torch.wire import canonical as pcanon  # noqa: E402
from tendermint_tpu_torch.wire.proto import ProtoWriter  # noqa: E402

# The plain versions run thousands of small tensor ops: one intra-op
# thread keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

CHAIN_ID = "commit-prep-chain"
HEIGHT = 21
COLUMNS = ("flags", "val_idx", "sig", "ts_seconds", "ts_nanos", "addr")
# Timestamps with zero, negative (the Go zero time) and multi-byte varints
SECONDS = (0, 1, -62135596800, 1_700_000_000, 2**40, -1)
NANOS = (0, 1, 127, 128, 999_999_999)
MIXES = {  # P(ABSENT), P(COMMIT), P(NIL)
    "all_commit": (0.0, 1.0, 0.0),
    "mixed": (0.2, 0.6, 0.2),
    "nil_heavy": (0.1, 0.2, 0.7),
}


def _bid(seed: int) -> JBlockID:
    h = hashlib.sha256(b"commit-prep block %d" % seed).digest()
    return JBlockID(hash=h, part_set_header=JPartSetHeader(total=2, hash=h[::-1]))


def _random_commit(n: int, seed: int, mix=MIXES["mixed"]) -> JCommit:
    """A JAX commit of n canonical-shaped votes with random addresses,
    signature bytes and timestamps (nothing here verifies)."""
    rng = np.random.default_rng(seed)
    flags = rng.choice([BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL],
                       n, p=mix)
    sigs = []
    for f in flags:
        if f == BLOCK_ID_FLAG_ABSENT:
            sigs.append(JCommitSig.absent())
        else:
            ts = JTimestamp(int(rng.choice(SECONDS)), int(rng.choice(NANOS)))
            sigs.append(JCommitSig(int(f), rng.bytes(20), ts, rng.bytes(64)))
    return JCommit(height=HEIGHT, round=3, block_id=_bid(seed), signatures=sigs)


def _port(jcommit: JCommit) -> Commit:
    return Commit.decode(jcommit.encode())


def _assert_columns_equal(got, want) -> None:
    for c in COLUMNS:
        g, w = getattr(got, c), getattr(want, c)
        assert g.dtype == w.dtype and g.shape == w.shape, c
        np.testing.assert_array_equal(g, w, err_msg=c)


# -- (a) columnar decode ------------------------------------------------------


@pytest.mark.parametrize("n", [4, 37, 300])
def test_decoded_columns_equal_jax_commit_block(n):
    jc = _random_commit(n, n)
    pc = _port(jc)
    assert isinstance(pc.signatures, CommitSigs)
    blk = pc.commit_block()
    assert blk is pc.signatures.block()  # the decode's columns, no rebuild
    assert all(x is None for x in pc.signatures._items)  # nothing materialized
    _assert_columns_equal(blk, jc.commit_block())  # JAX: built from objects
    _assert_columns_equal(blk, JCommit.decode(jc.encode()).commit_block())
    # the port's object build gives the same columns
    _assert_columns_equal(_commit_sig_columns(list(pc.signatures)), blk)
    assert pc.encode() == jc.encode()
    for flag in (BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL):
        assert pc.sign_bytes_template(CHAIN_ID, flag) == jc.sign_bytes_template(CHAIN_ID, flag)


def test_lazy_view_materializes_per_index_and_detaches_on_mutation():
    jc = _random_commit(40, 5)
    pc = _port(jc)
    sigs = pc.signatures
    for i in (3, -1, 0):
        got, want = sigs[i], jc.signatures[i]
        assert (got.block_id_flag, got.validator_address, tuple(got.timestamp),
                got.signature) == (want.block_id_flag, want.validator_address,
                                   tuple(want.timestamp), want.signature)
    assert sum(x is not None for x in sigs._items) == 3
    assert sigs[3] is sigs[3]  # one object per index
    assert [cs.encode() for cs in sigs[5:9]] == [cs.encode() for cs in jc.signatures[5:9]]
    with pytest.raises(IndexError):
        sigs[40]
    assert sigs == list(sigs) and len(sigs) == 40

    # setitem detaches: the list is the truth, the columns rebuild from it
    i = next(k for k, cs in enumerate(jc.signatures) if not cs.is_absent())
    bad = bytes(64)
    sigs[i] = dataclasses.replace(sigs[i], signature=bad)
    assert sigs.block() is None
    assert pc.commit_block() is not pc.commit_block()  # fresh at every call
    assert pc.commit_block().sig[i].tobytes() == bad
    # delitem and insert detach too
    for mutate in (lambda s: s.__delitem__(0), lambda s: s.insert(0, JCommitSig.absent())):
        pc2 = _port(jc)
        mutate(pc2.signatures)
        assert pc2.signatures.block() is None
        assert len(pc2.signatures) in (39, 41)


def _commit_bytes(jc: JCommit, records) -> bytes:
    w = ProtoWriter()
    w.write_varint(1, jc.height)
    w.write_varint(2, jc.round)
    w.write_message(3, jc.block_id.encode(), always=True)
    for rec in records:
        w.write_message(4, rec, always=True)
    return w.bytes()


@pytest.mark.parametrize("case", ["short_sig", "absent_with_addr", "unknown_flag",
                                  "duplicate_field", "no_timestamp"])
def test_non_canonical_commit_decodes_to_objects(case):
    jc = _random_commit(12, 7, MIXES["mixed"])
    i = next(k for k, cs in enumerate(jc.signatures) if not cs.is_absent())
    a = next(k for k, cs in enumerate(jc.signatures) if cs.is_absent())
    recs = [cs.encode() for cs in jc.signatures]
    cs = jc.signatures[i]
    if case == "short_sig":
        recs[i] = dataclasses.replace(cs, signature=cs.signature[:63]).encode()
    elif case == "absent_with_addr":
        recs[a] = dataclasses.replace(jc.signatures[a], validator_address=bytes(20)).encode()
    elif case == "unknown_flag":
        recs[i] = dataclasses.replace(cs, block_id_flag=7).encode()
    elif case == "duplicate_field":
        recs[i] += b"\x08\x02"  # block_id_flag a second time
    else:  # a COMMIT vote with no timestamp field decodes to seconds 0
        recs[i] = b"\x08\x02\x12\x14" + cs.validator_address + b"\x22\x40" + cs.signature
    data = _commit_bytes(jc, recs)
    jd = JCommit.decode(data)
    pd = Commit.decode(data)
    assert [c.encode() for c in pd.signatures] == [c.encode() for c in jd.signatures]
    if case == "no_timestamp":  # canonical shape all the same: columnar
        assert isinstance(pd.signatures, CommitSigs) and not isinstance(jd.signatures, list)
        _assert_columns_equal(pd.commit_block(), jd.commit_block())
        return
    assert type(pd.signatures) is list and type(jd.signatures) is list
    if case == "duplicate_field":  # the objects are canonical: columns from them
        _assert_columns_equal(pd.commit_block(), jd.commit_block())
    else:
        assert pd.commit_block() is None and jd.commit_block() is None


# -- (b) prep_commit three ways -----------------------------------------------


def _set_columns(n: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed + 1000)
    return (rng.integers(0, 256, (n, 32), dtype=np.uint8),
            rng.integers(1, 1000, n).astype(np.int64))


def _assert_prep_equal(got, want) -> None:
    (gs, gt, gb), (ws, wt, wb) = got, want
    np.testing.assert_array_equal(gs, ws)
    assert gs.dtype == np.int64 and gt == wt
    assert (gb is None) == (wb is None)
    if gb is None:
        return
    np.testing.assert_array_equal(gb.pub, wb.pub)
    np.testing.assert_array_equal(gb.sig, wb.sig)
    np.testing.assert_array_equal(gb.offsets, wb.offsets)
    assert bytes(gb.msgs) == bytes(wb.msgs)


def _prep_three_ways(jc: JCommit, pub, power, threshold: int, mode: int) -> None:
    pc = _port(jc)
    tpl_c = pc.sign_bytes_template(CHAIN_ID, BLOCK_ID_FLAG_COMMIT)
    tpl_n = pc.sign_bytes_template(CHAIN_ID, BLOCK_ID_FLAG_NIL)
    args = (pub, power, tpl_c[0], tpl_n[0], tpl_c[1], threshold, mode)
    c = commit_prep.prep_commit(pc.commit_block(), *args)
    _assert_prep_equal(c, commit_prep._prep_commit_numpy(pc.commit_block(), *args))
    _assert_prep_equal(c, jcp.prep_commit(jc.commit_block(), *args, ram_max_len=0))
    if c[2] is not None:  # each lane's sign bytes are the per-vote composer's
        blk = c[2]
        assert [blk.msg(j) for j in range(len(blk))] == [
            jc.vote_sign_bytes(CHAIN_ID, int(i)) for i in c[0]]


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("mode", range(8))
def test_prep_commit_c_numpy_and_jax_agree(mode, mix):
    for n in (4, 300):
        jc = _random_commit(n, 11 * n + mode, MIXES[mix])
        pub, power = _set_columns(n, n)
        flags = jc.commit_block().flags
        # the tally without early stop: thresholds at, below and above it
        sel = flags == BLOCK_ID_FLAG_COMMIT if mode & 1 else flags != BLOCK_ID_FLAG_ABSENT
        counted = sel & (flags == BLOCK_ID_FLAG_COMMIT) if mode & 2 else sel
        full = int(power[counted].sum())
        for threshold in sorted({0, full // 3, full // 2, full - 1, full, full + 1}):
            _prep_three_ways(jc, pub, power, threshold, mode)


# -- (c) the C helpers --------------------------------------------------------


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native module, or None where it does not build."""
    return jnative.load()


@pytest.fixture(params=[1, 4], ids=["1_thread", "4_threads"])
def width(request, monkeypatch):
    monkeypatch.setenv("TM_NATIVE_THREADS", str(request.param))
    assert host.threads() == request.param
    return request.param


def _messages(n: int, seed: int) -> tuple:
    """(buffer, (n+1,) int64 offsets): lengths that put R || A || M at
    and next to the SHA-512 block edges (111/112, 239/240 bytes), empty
    messages, and random lengths."""
    rng = np.random.default_rng(seed)
    edges = np.array([0, 46, 47, 48, 49, 174, 175, 176, 177])
    lens = np.where(rng.random(n) < 0.5, rng.choice(edges, n), rng.integers(0, 300, n))
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    return rng.bytes(int(offs[-1])), offs


def _split(buf: bytes, offs) -> list:
    return [buf[offs[i] : offs[i + 1]] for i in range(len(offs) - 1)]


def test_challenges_buf_equals_oracle_and_jax(width, jax_native):
    n = 2100  # past the C call's 2,048-row serial cut
    rng = np.random.default_rng(31)
    rs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    pubs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    buf, offs = _messages(n, 32)
    got = host.ed25519_challenges_buf(rs, pubs, buf, offs)
    assert got.tobytes() == backend._challenges(rs, pubs, _split(buf, offs))
    if jax_native is not None:
        assert got.tobytes() == jax_native.ed25519_challenges_buf(
            rs.tobytes(), pubs.tobytes(), buf, offs.tobytes())


def _edge_scalars(rng, n: int) -> np.ndarray:
    """(n, 32) s values: random, 2^256 - 1, L - 1, L, L + 1, 2^253."""
    s = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    for i, v in enumerate((2**256 - 1, L - 1, L, L + 1, 2**253, 0)):
        s[7 * i + 1] = np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)
    return s


def test_rlc_prep_equals_oracle_and_jax(width, jax_native):
    n, total = 1030, 1032  # 258 lanes, past the 256-lane serial cut; 2 padding rows
    rng = np.random.default_rng(41)
    pubs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sigs = np.concatenate([rng.integers(0, 256, (n, 32), dtype=np.uint8),
                           _edge_scalars(rng, n)], axis=1)
    buf, offs = _messages(n, 42)
    z = np.zeros((total, 32), dtype=np.uint8)
    z[:, :16] = rng.integers(0, 256, (total, 16), dtype=np.uint8)
    z[5, :16] = 0xFF  # 2^128 - 1
    k, S, U, s_ok = host.ed25519_rlc_prep(pubs, sigs, buf, offs, z, rlc.M, total)

    k_want = backend._challenges(np.ascontiguousarray(sigs[:, :32]), pubs, _split(buf, offs))
    assert k.tobytes() == k_want
    s_enc = np.zeros((total, 32), dtype=np.uint8)
    s_enc[:n] = sigs[:, 32:]
    k_enc = np.zeros((total, 32), dtype=np.uint8)
    k_enc[:n] = k
    assert S.tobytes() + U.tobytes() == rlc._rlc_scalars_py(
        s_enc.tobytes(), k_enc.tobytes(), z.tobytes(), rlc.M)
    np.testing.assert_array_equal(s_ok, backend._s_below_l(s_enc, n, total))
    assert not U[n:].any() and s_ok[n:].all()  # padding rows
    if jax_native is not None:
        jk, jsu, jsok = jax_native.ed25519_rlc_prep(
            pubs.tobytes(), sigs.tobytes(), buf, offs.tobytes(), z.tobytes(), rlc.M, total)
        assert (k.tobytes(), S.tobytes() + U.tobytes(), s_ok.tobytes()) == (jk, jsu, jsok)


def test_mod_l_many_equals_oracle(width):
    n = 2100
    d = np.random.default_rng(51).integers(0, 256, (n, 64), dtype=np.uint8)
    for i, v in enumerate((0, L - 1, L, 2 * L, 2**512 - 1, 2**256 - 1, L * (2**259))):
        d[i] = np.frombuffer(v.to_bytes(64, "little"), dtype=np.uint8)
    got = host.mod_l_many(d)
    want = b"".join((int.from_bytes(r.tobytes(), "little") % L).to_bytes(32, "little")
                    for r in d)
    assert got.tobytes() == want


def test_vote_sign_bytes_equal_composer_and_jax(width, jax_native):
    rng = np.random.default_rng(61)
    n = 70
    times = np.stack([rng.choice(SECONDS, n), rng.choice(NANOS + (-5,), n)], axis=1)
    for flag in (BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL):
        prefix, suffix = _port(_random_commit(4, 1)).sign_bytes_template(CHAIN_ID, flag)
        buf, offs = host.vote_sign_bytes_batch_buf(prefix, suffix, times)
        ts = [pcanon.Timestamp(int(s), int(ns)) for s, ns in times]
        wbuf, woffs = pcanon.compose_vote_sign_bytes_block((prefix, suffix), ts)
        assert bytes(buf) == bytes(wbuf)
        np.testing.assert_array_equal(offs, woffs)
        if jax_native is not None:
            jbuf, joffs = jax_native.vote_sign_bytes_batch_buf(prefix, suffix, times.tobytes())
            assert (bytes(buf), offs.tobytes()) == (jbuf, joffs)


@pytest.mark.parametrize("mode", [0, 2, 5])
def test_commit_prep_at_both_widths_equals_numpy_and_jax(width, mode):
    n = 1100  # the reference threads from 1,024 rows; the port runs serially
    jc = _random_commit(n, 71)
    pub, power = _set_columns(n, 71)
    _prep_three_ways(jc, pub, power, int(power.sum()) // 4, mode)


def test_host_wrappers_refuse_bad_inputs():
    rs = np.zeros((3, 32), dtype=np.uint8)
    sig = np.zeros((3, 64), dtype=np.uint8)
    buf = bytes(30)
    z = np.zeros((4, 32), dtype=np.uint8)
    for offs in ([0, 10, 5, 20], [1, 10, 20, 30], [0, 10, 20, 31]):
        offs = np.array(offs, dtype=np.int64)
        with pytest.raises(ValueError, match="bad columnar challenge inputs"):
            host.ed25519_challenges_buf(rs, rs, buf, offs)
        with pytest.raises(ValueError, match="bad rlc prep inputs"):
            host.ed25519_rlc_prep(rs, sig, buf, offs, z, 4, 4)
    good = np.array([0, 10, 20, 30], dtype=np.int64)
    for bad_rs in (rs[:2], rs.astype(np.int32), np.zeros((3, 64), np.uint8)[:, ::2]):
        with pytest.raises(ValueError):
            host.ed25519_challenges_buf(bad_rs, rs, buf, good)
    with pytest.raises(ValueError, match="offsets"):
        host.ed25519_challenges_buf(rs, rs, buf, good.astype(np.int32))
    with pytest.raises(ValueError, match="multiple of m"):
        host.ed25519_rlc_prep(rs, sig, buf, good, np.zeros((6, 32), np.uint8), 4, 6)
    with pytest.raises(ValueError, match="z must be"):
        host.ed25519_rlc_prep(rs, sig, buf, good, z[:3], 4, 4)
    with pytest.raises(ValueError, match="times"):
        host.vote_sign_bytes_batch_buf(b"", b"", np.zeros((3, 2), np.int32))
    with pytest.raises(ValueError, match="digests"):
        host.mod_l_many(np.zeros((3, 32), np.uint8))
    with pytest.raises(ValueError, match="power"):
        host.commit_prep_fused(np.zeros(3, np.uint8), sig, np.zeros(3, np.int64),
                               np.zeros(3, np.int32), rs, np.zeros(3, np.int32),
                               b"", b"", b"", 0, 0)


# -- (d) verify_commit through the fused C path -------------------------------


@pytest.fixture(autouse=True)
def _jax_host_verifier(monkeypatch):
    monkeypatch.setattr(jbatch, "_device_verifier_factory", None)


@pytest.fixture(scope="module")
def signed():
    """(JValidatorSet, JBlockID, signed JCommit) of 80 validators, two
    absent and one voting nil."""
    rng = np.random.default_rng(81)
    n = 80
    sks = [jed.gen_priv_key(rng.bytes(32)) for _ in range(n)]
    vset = JValidatorSet.new([JValidator.new(sk.pub_key(), int(p))
                              for sk, p in zip(sks, rng.integers(1, 100, n))])
    by_addr = {sk.pub_key().address(): sk for sk in sks}
    bid = _bid(81)
    sigs = []
    for i, v in enumerate(vset.validators):
        if i in (5, 31):
            sigs.append(JCommitSig.absent())
        else:
            flag = BLOCK_ID_FLAG_NIL if i == 9 else BLOCK_ID_FLAG_COMMIT
            sigs.append(JCommitSig(flag, v.address, JTimestamp(1_700_000_000 + i, 13 * i), b""))
    commit = JCommit(height=HEIGHT, round=1, block_id=bid, signatures=sigs)
    commit.signatures = [
        cs if cs.is_absent() else dataclasses.replace(
            cs, signature=by_addr[cs.validator_address].sign(commit.vote_sign_bytes(CHAIN_ID, i)))
        for i, cs in enumerate(sigs)
    ]
    return vset, bid, commit


def _raise(*_a, **_k):
    raise AssertionError("an oracle ran on the verify path")


@pytest.fixture
def fused_only(monkeypatch):
    """Make every Python/numpy oracle of the host path raise; count the
    fused C calls."""
    for mod, name in ((commit_prep, "_prep_commit_numpy"), (commit_prep, "select_and_tally"),
                      (commit_prep, "_compose_selected"), (backend, "_challenges"),
                      (rlc, "_rlc_scalars_py"), (validation, "_select_commit_sigs")):
        monkeypatch.setattr(mod, name, _raise)
    calls = []
    real = host.commit_prep_fused
    monkeypatch.setattr(host, "commit_prep_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
    yield calls
    epoch_cache.reset()


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome under test is the exception itself
        return type(e).__name__, str(e)
    return None


def _tamper(sigs: list, idx: int) -> None:
    bad = bytearray(sigs[idx].signature)
    bad[40] ^= 0x10
    sigs[idx] = dataclasses.replace(sigs[idx], signature=bytes(bad))


def _jax_outcome(mode, vset, bid, height, jc):
    return _outcome(lambda: getattr(jvalidation, mode)(CHAIN_ID, vset, bid, height, jc))


def _port_outcome(mode, pvals, pbid, height, pc):
    return _outcome(lambda: getattr(validation, mode)(CHAIN_ID, pvals, pbid, height, pc,
                                                      device="cpu"))


@pytest.mark.parametrize("path", ["rlc", "per_signature"])
@pytest.mark.parametrize("mode", ["verify_commit", "verify_commit_light"])
def test_verify_commit_runs_the_fused_path(signed, fused_only, mode, path, monkeypatch):
    if path == "per_signature":
        monkeypatch.setenv("TM_TPU_RLC", "0")
        monkeypatch.setattr(rlc, "prepare_batch", _raise)
    from tendermint_tpu_torch.ops import verify

    monkeypatch.setattr(verify, "BLOCK", 16)  # the per-signature bucket: 80, not 512
    vset, bid, jc = signed
    pvals, pc = convert.state_from_wire(vset.encode(), jc.encode())
    pbid = BlockID.decode(bid.encode())
    ran = []

    def check(name, jcase, pcase):
        want = _jax_outcome(mode, vset, bid, HEIGHT, jcase)
        got = _port_outcome(mode, pvals, pbid, HEIGHT, pcase)
        assert got == want, name
        ran.append(name)
        return got

    check("valid", jc, pc)
    check("valid, warm", jc, pc)
    jbad = JCommit(jc.height, jc.round, jc.block_id, list(jc.signatures))
    _tamper(jbad.signatures, 3)
    # stale columns: a decoded commit mutated in place (the view detaches)
    decoded = Commit.decode(jc.encode())
    decoded.commit_block()
    _tamper(decoded.signatures, 3)
    got = check("tampered after decode", jbad, decoded)
    assert got[1].startswith("wrong signature (#3): "), got
    # and an object-built commit verified, then mutated (no cached columns)
    built = Commit(pc.height, pc.round, pc.block_id, list(pc.signatures))
    check("valid, object-built", jc, built)
    _tamper(built.signatures, 3)
    assert check("tampered object-built", jbad, built) == got
    # a bad nil vote: verify_commit checks it, the light walk skips it
    jnil = JCommit(jc.height, jc.round, jc.block_id, list(jc.signatures))
    _tamper(jnil.signatures, 9)
    got = check("tampered nil vote", jnil, Commit.decode(jnil.encode()))
    assert (got is None) == (mode == "verify_commit_light"), got
    # below 2/3: no sign bytes, no kernels
    jlow = JCommit(jc.height, jc.round, jc.block_id, [
        JCommitSig.absent() if i % 3 else cs for i, cs in enumerate(jc.signatures)])
    got = check("low power", jlow, Commit.decode(jlow.encode()))
    assert got[0] == "ErrNotEnoughVotingPowerSigned", got
    assert len(fused_only) == len(ran)  # every case went through the C prep


def test_non_columnar_commit_takes_the_object_path(signed, monkeypatch):
    """A commit with a wrong-length signature has no columns: the object
    path gives the reference's error, and the fused prep never runs."""
    monkeypatch.setattr(host, "commit_prep_fused", _raise)
    vset, bid, jc = signed
    jbad = JCommit(jc.height, jc.round, jc.block_id, list(jc.signatures))
    jbad.signatures[4] = dataclasses.replace(jbad.signatures[4],
                                             signature=jbad.signatures[4].signature[:63])
    pvals, pc = convert.state_from_wire(vset.encode(), jbad.encode())
    assert type(pc.signatures) is list
    want = _jax_outcome("verify_commit", vset, bid, HEIGHT, jbad)
    got = _port_outcome("verify_commit", pvals, BlockID.decode(bid.encode()), HEIGHT, pc)
    assert got == want == ("ValueError", "invalid signature length")
