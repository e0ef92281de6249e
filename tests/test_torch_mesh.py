"""The mesh dispatcher of the port (tendermint_tpu_torch/ops/mesh.py, the
mesh mode of ops/pipeline.py, device_pool.PlacedSlots) and the mixed
committee's scheme split (types/validation.prepare_commit_scheme_split,
ValidatorSet.scheme_rows), on the CPU, against the JAX package's
(tendermint_tpu/ops/mesh.py, types/validation.py, types/validator_set.py).

(a) The packing half, numpy only on both sides: on the same jobs
    (tests/test_mesh.py's shapes: mixed job sizes on one and two lanes,
    mixed epochs, one warm epoch, a pure padding lane, a hold-over, an
    empty job, a secp256k1 lane beside ed25519 ones) pack_jobs' plan
    (lanes, their keys, schemes and jobs, lane_bucket, n_lanes, bucket,
    live, pad, held and empty jobs) and build_superblock's demux spans and
    rows (every column of every row, padding included) equal the
    reference's. The reference reads its lane capacity from
    TM_TPU_MESH_LANE_BUCKET, set to the port's cap.
(b) The dispatcher in mesh mode with a stand-in host stage (a row is
    valid iff its pub[0] is odd), as tests/test_torch_pipeline.py's:
    demux, hold-over, chunking at the lane capacity, a failed pack and a
    failed prep failing only their jobs, a placement on
    Mesh(("cpu", "cpu")) launching lane by lane, an AggBlock refused;
    then the real host stage with the plain kernels on two CPU lanes,
    placed and simulated, against the ZIP-215 oracle.
(c) prepare_commit_scheme_split and scheme_rows on a small committee of
    ed25519 and secp256k1 validators against the reference's: blocks,
    the power error, the blame of every single bad row and of two; then
    its two blocks through a mesh-mode dispatcher in one superbatch of
    two segments (the plain op-graph and secp256k1 kernels).
Every wait is bounded (WAIT). Tolerance: none.
"""

import dataclasses
import hashlib
import os
import threading

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tendermint_tpu.crypto import ed25519 as jed  # noqa: E402
from tendermint_tpu.crypto import secp256k1 as jsecp  # noqa: E402
from tendermint_tpu.crypto import sr25519 as jsr  # noqa: E402
from tendermint_tpu.ops import entry_block as jeb  # noqa: E402
from tendermint_tpu.ops import epoch_cache as jep  # noqa: E402
from tendermint_tpu.ops import mesh as jms  # noqa: E402
from tendermint_tpu.types import validation as jvalidation  # noqa: E402
from tendermint_tpu.types.block import (  # noqa: E402
    BLOCK_ID_FLAG_COMMIT,
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
from tendermint_tpu_torch.crypto import _edwards, secp256k1  # noqa: E402
from tendermint_tpu_torch.ops import epoch_cache, mesh, sharded  # noqa: E402
from tendermint_tpu_torch.ops import pipeline as pl  # noqa: E402
from tendermint_tpu_torch.ops.entry_block import AggBlock, EntryBlock  # noqa: E402
from tendermint_tpu_torch.types import validation  # noqa: E402
from tendermint_tpu_torch.types.validator_set import ErrNotEnoughVotingPowerSigned  # noqa: E402
from tests.test_torch_pipeline import WAIT  # noqa: E402

torch.set_num_threads(1)

CHAIN_ID = "torch-mesh-chain"
HEIGHT = 17
CAP = 128


@pytest.fixture(autouse=True)
def _fresh():
    pl.reset_shared()
    epoch_cache.reset(4)
    jep.reset(depth=4)
    yield
    pl.reset_shared()
    epoch_cache.reset()
    jep.reset()


# -- (a) packing ------------------------------------------------------------------


class _J:
    def __init__(self, entries):
        self.entries = entries


def _cols(n: int, tag: int, scheme: str = "ed25519") -> dict:
    """Random rows of one job (the packer never reads their crypto)."""
    rng = np.random.default_rng(1000 * tag + n)
    lens = rng.integers(0, 40, n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return {"pub": rng.integers(0, 256, (n, 32), dtype=np.uint8),
            "sig": rng.integers(0, 256, (n, 64), dtype=np.uint8),
            "msgs": rng.bytes(int(offsets[-1])), "offsets": offsets, "scheme": scheme,
            "pub_aux": (rng.integers(2, 4, n).astype(np.uint8)
                        if scheme == "secp256k1" else None)}


def _jobs(specs):
    """(port jobs, reference jobs) of the same rows: specs are (n, tag,
    epoch key or None, scheme); a keyed job's val_idx is its rows 0..n-1."""
    port, ref = [], []
    for n, tag, key, scheme in specs:
        c = _cols(n, tag, scheme)
        vidx = np.arange(n, dtype=np.int32) if key is not None else None
        port.append(_J(EntryBlock(c["pub"], c["sig"], c["msgs"], c["offsets"], val_idx=vidx,
                                  epoch_key=key, scheme=scheme, pub_aux=c["pub_aux"])))
        ref.append(_J(jeb.EntryBlock(c["pub"], c["sig"], c["msgs"], c["offsets"], val_idx=vidx,
                                     epoch_key=key, scheme=scheme, pub_aux=c["pub_aux"])))
    return port, ref


def _warm(key: bytes, v: int) -> None:
    pub = np.random.default_rng(v).integers(0, 256, (v, 32), dtype=np.uint8)
    for c in (epoch_cache.cache(), jep.cache()):
        c.note(key, pub)
        assert c.note(key, pub) is not None


def _plan_view(plan, held, jobs) -> dict:
    ix = {id(j): i for i, j in enumerate(jobs)}
    return {"lanes": [(l.key, l.scheme, l.n, [ix[id(j)] for j in l.jobs]) for l in plan.lanes],
            "lane_bucket": plan.lane_bucket, "n_lanes": plan.n_lanes, "bucket": plan.bucket,
            "live": plan.live, "pad": plan.pad, "epoch_key": plan.epoch_key(),
            "held": [ix[id(j)] for j in held],
            "empty": [ix[id(j)] for j in plan.empty_jobs]}


def _block_view(b) -> dict:
    return {"pub": b.pub.tobytes(), "sig": b.sig.tobytes(), "msgs": bytes(b.msgs),
            "offsets": b.offsets.tolist(), "scheme": b.scheme, "epoch_key": b.epoch_key,
            "val_idx": None if b.val_idx is None else b.val_idx.tolist(),
            "pub_aux": None if b.pub_aux is None else b.pub_aux.tolist()}


def _super_view(block) -> list:
    if hasattr(block, "parts"):
        return [(s, off, _block_view(b)) for s, b, off in block.parts]
    return [(block.scheme, 0, _block_view(block))]


PACKS = {
    # name: (jobs (n, tag, key, scheme), max_lanes, forced n_lanes, warm keys)
    "one_lane_mixed_sizes": ([(96, 1, None, "ed25519"), (31, 2, None, "ed25519"),
                              (5, 3, None, "ed25519")], 1, None, ()),
    "two_lanes": ([(96, 10, None, "ed25519"), (31, 11, None, "ed25519"),
                   (128, 12, None, "ed25519"), (64, 13, None, "ed25519"),
                   (7, 14, None, "ed25519")], 2, None, ()),
    "pure_pad_lane": ([(100, 20, None, "ed25519")], 2, 2, ()),
    "mixed_epochs": ([(40, 30, b"ek-1", "ed25519"), (50, 31, b"ek-2", "ed25519"),
                      (30, 32, None, "ed25519")], 4, None, (b"ek-1", b"ek-2")),
    "one_warm_epoch": ([(20, 40, b"mesh-warm", "ed25519"), (28, 41, b"mesh-warm", "ed25519")],
                       2, 2, (b"mesh-warm",)),
    "hold_over_and_empty": ([(100, 50, None, "ed25519"), (0, 51, None, "ed25519"),
                             (90, 52, b"ek-1", "ed25519"), (70, 53, None, "ed25519"),
                             (60, 54, b"ek-2", "ed25519")], 2, None, ()),
    "secp_beside_ed25519": ([(12, 60, None, "ed25519"), (9, 61, None, "secp256k1"),
                             (3, 62, None, "secp256k1")], 4, None, ()),
    "secp_alone_warm_key": ([(9, 70, b"sk", "secp256k1")], 2, 2, ()),
}


@pytest.mark.parametrize("name", sorted(PACKS))
def test_pack_and_superblock_equal_reference(monkeypatch, name):
    monkeypatch.setenv("TM_TPU_MESH_LANE_BUCKET", str(CAP))
    specs, max_lanes, force, warm = PACKS[name]
    for key in warm:
        _warm(key, 60)
    port, ref = _jobs(specs)
    plan, held = mesh.pack_jobs(port, max_lanes, CAP)
    jplan, jheld = jms.pack_jobs(ref, max_lanes, CAP)
    if force:
        plan.n_lanes = jplan.n_lanes = force
    got = _plan_view(plan, held, port)
    assert got == _plan_view(jplan, jheld, ref)
    block, spans = mesh.build_superblock(plan)
    jblock, jspans = jms.build_superblock(jplan)
    ix = {id(j): i for i, j in enumerate(port)}
    jix = {id(j): i for i, j in enumerate(ref)}
    assert [(ix[id(j)], o, n) for j, o, n in spans] == [(jix[id(j)], o, n) for j, o, n in jspans]
    assert len(block) == len(jblock) == plan.bucket
    assert _super_view(block) == _super_view(jblock)
    if name == "one_warm_epoch":
        assert block.epoch_key == b"mesh-warm" and got["lanes"][0][3] == [0, 1]
    if name == "hold_over_and_empty":
        assert got["held"] and got["empty"] == [1]


def test_warm_superbatch_takes_the_tables_padding_column(monkeypatch):
    """A one-warm-epoch superbatch on the op-graph path preps its cached
    arguments: the padding rows gather the table's padding column vp - 1,
    which epoch_cache.table_columns admits; a column past the set that is
    not the padding one is still refused."""
    monkeypatch.setenv("TM_TPU_PALLAS", "0")
    _warm(b"w", 60)
    ep = epoch_cache.cache().get(b"w")
    assert (ep.n_vals, ep.vp) == (60, 64)
    plan, _ = mesh.pack_jobs(_jobs([(20, 80, b"w", "ed25519")])[0], 1, CAP)
    block, _ = mesh.build_superblock(plan)
    batch = mesh.prepare_superbatch(block, plan)
    assert batch.placement is None and len(batch.args) == 7
    assert batch.args[0].tolist() == list(range(20)) + [ep.vp - 1] * (plan.bucket - 20)
    for col in (60, 62, -1):
        bad = EntryBlock(block.pub, block.sig, block.msgs, block.offsets,
                         val_idx=np.full(len(block), col, np.int32), epoch_key=b"w")
        with pytest.raises(ValueError, match="outside the epoch's 60 validators"):
            epoch_cache.table_columns(bad, len(block), ep)


def test_lane_cap_clamps_as_the_reference(monkeypatch):
    for lb in (1, 16, 100, 1024, 99_999):
        monkeypatch.setenv("TM_TPU_MESH_LANE_BUCKET", str(lb))
        assert mesh.lane_cap(lb) == jms.lane_cap()
    monkeypatch.delenv("TM_TPU_MESH_LANE_BUCKET")
    assert mesh.lane_cap(None) == jms.lane_cap() == 10240
    assert mesh._secp_pad_row() == jms._secp_pad_row()
    with pytest.raises(ValueError, match="job of 200 sigs exceeds the 128-sig lane capacity"):
        mesh.pack_jobs(_jobs([(200, 1, None, "ed25519")])[0], 2, CAP)


# -- (b) the dispatcher in mesh mode -------------------------------------------------


def _block_of(n: int, tag: int, valid=None, key=None) -> EntryBlock:
    valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    pub = np.zeros((n, 32), np.uint8)
    pub[:, 0] = np.where(valid, 1, 2)
    pub[:, 1] = tag
    return EntryBlock(pub, np.zeros((n, 64), np.uint8), b"", np.zeros(n + 1, np.int64),
                      val_idx=None if key is None else np.zeros(n, np.int32), epoch_key=key)


class _Stage:
    """The stand-in host stage: a row is valid iff pub[0] is odd (padding
    rows are: the identity encoding's first byte is 1). Records each
    plan's lanes and each launch's rows; with `placement_mesh` the batch
    is placed lane by lane on it."""

    def __init__(self, placement_mesh=None, fail_tag=None):
        self.plans, self.launches = [], []
        self._mesh = placement_mesh
        self._fail = fail_tag
        self._mtx = threading.Lock()

    def __call__(self, block, plan):
        tags = {int(t) for l in plan.lanes for j in l.jobs for t in j.entries.pub[:, 1]}
        if self._fail in tags:
            raise ValueError("prep exploded")
        with self._mtx:
            self.plans.append([(l.key, [len(j.entries) for j in l.jobs]) for l in plan.lanes])
        args = (np.ascontiguousarray(block.pub[:, 0]).astype(np.int32),)

        def launch(dev_args):
            with self._mtx:
                self.launches.append(int(dev_args[0].shape[0]))
            return (dev_args[0] % 2 == 1).to(torch.int32)

        placement = None
        if self._mesh is not None:
            placement = sharded.Placement(self._mesh.prefix(plan.n_lanes), (0,))
        return mesh.MeshBatch(args, plan.bucket, launch, placement)


def _verifier(stage, **kw):
    kw.setdefault("lane_bucket", 16)
    return pl.AsyncBatchVerifier("cpu", prepare=stage, mesh_lanes=kw.pop("lanes", 2), **kw)


def _results(futs) -> list:
    return [f.result(timeout=WAIT) for f in futs]


def _together(v, blocks, seen=None) -> list:
    """Submit `blocks` so that one drain of the coalescer takes them all:
    a one-row primer's host stage holds the coalescer until they are
    queued, then fails the primer alone. Returns their verdicts; `seen`
    collects each later superbatch's (block, plan)."""
    entered, gate = threading.Event(), threading.Event()
    inner = v._prepare

    def held(block, plan):
        if not gate.is_set():
            entered.set()
            assert gate.wait(WAIT)
            raise RuntimeError("the primer's stage")
        if seen is not None:
            seen.append((block, plan))
        return inner(block, plan)

    v._prepare = held
    primer = v.submit(_block_of(1, 255))
    assert entered.wait(WAIT)
    futs = [v.submit(b) for b in blocks]
    gate.set()
    with pytest.raises(pl.DispatchError, match="the primer's stage"):
        primer.result(timeout=WAIT)
    return _results(futs)


def test_demux_and_hold_over():
    """Jobs of four epoch keys on two lanes: no lane mixes keys, the jobs
    that fit no lane wait for the next superbatch, every job gets its own
    rows' verdicts."""
    stage = _Stage()
    v = _verifier(stage)
    try:
        blocks = [_block_of(5 + i, i, valid=[k != i % 3 for k in range(5 + i)],
                            key=bytes([i % 4])) for i in range(8)]
        res = _results([v.submit(b) for b in blocks])
    finally:
        v.close()
    for b, r in zip(blocks, res):
        assert r.dtype == bool and r.tolist() == (b.pub[:, 0] == 1).tolist()
    assert len(stage.plans) >= 2  # four keys, two lanes a superbatch
    for lanes in stage.plans:
        assert len(lanes) <= 2 and all(sum(ns) <= 16 for _, ns in lanes)
        assert len({k for k, _ in lanes}) == len(lanes)
    assert sum(len(ns) for lanes in stage.plans for _, ns in lanes) == 8


def test_submit_chunks_at_the_lane_capacity():
    stage = _Stage()
    v = _verifier(stage, lanes=4)
    try:
        blk = _block_of(40, 1, valid=[i % 7 != 3 for i in range(40)])
        got = v.submit(blk).result(timeout=WAIT)
    finally:
        v.close()
    assert got.tolist() == [i % 7 != 3 for i in range(40)]
    assert sorted(n for lanes in stage.plans for _, ns in lanes for n in ns) == [8, 16, 16]


def test_failed_pack_and_prep_fail_only_their_jobs(monkeypatch):
    stage = _Stage(fail_tag=9)
    v = _verifier(stage)
    real = mesh.pack_jobs

    def pack(jobs, lanes, cap):
        if any(int(j.entries.pub[0, 1]) == 7 for j in jobs):
            raise RuntimeError("pack exploded")
        return real(jobs, lanes, cap)

    monkeypatch.setattr(mesh, "pack_jobs", pack)
    try:
        with pytest.raises(pl.DispatchError, match="mesh pack failed"):
            v.submit(_block_of(4, 7)).result(timeout=WAIT)
        with pytest.raises(pl.DispatchError, match="batch prep failed"):
            v.submit(_block_of(4, 9)).result(timeout=WAIT)
        assert v.submit(_block_of(4, 1, valid=[1, 0, 1, 1])).result(
            timeout=WAIT).tolist() == [True, False, True, True]
    finally:
        v.close()


def test_placement_on_two_cpu_lanes():
    """Mesh(("cpu", "cpu")): both lanes' rows go to the one device's slot
    stacked, each lane launches on its own, the row joins in lane order."""
    m = sharded.Mesh(["cpu", "cpu"])
    stage = _Stage(placement_mesh=m)
    v = _verifier(stage, mesh=m)
    try:
        res = _together(v, [_block_of(10, 1, valid=[i != 4 for i in range(10)], key=b"a"),
                            _block_of(12, 2, valid=[i != 11 for i in range(12)], key=b"b")])
    finally:
        v.close()
    assert [r.tolist() for r in res] == [[i != 4 for i in range(10)],
                                         [i != 11 for i in range(12)]]
    assert v.mesh is m and list(v._pools) == [torch.device("cpu")]
    assert stage.launches == [16, 16]  # lane by lane, 16 rows each


def test_placement_split_and_join():
    m = sharded.Mesh(["cpu", "cpu", "cpu", "cpu"])
    p = sharded.Placement(m, (0, -1))
    a, b = np.arange(16).reshape(8, 2), np.arange(24).reshape(3, 8)
    host = p.split((a, b))
    assert list(host) == [torch.device("cpu")]
    assert host[torch.device("cpu")][0].shape == (4, 2, 2)
    assert host[torch.device("cpu")][1].shape == (4, 3, 2)
    lane2 = p.lane_args([torch.from_numpy(x) for x in host[torch.device("cpu")]], 2)
    assert lane2[0].tolist() == a[4:6].tolist() and lane2[1].tolist() == b[:, 4:6].tolist()
    assert p.join({torch.device("cpu"): np.arange(8)}).tolist() == list(range(8))
    with pytest.raises(ValueError, match="specs cover"):
        sharded.mesh_arg_shardings(m, "pallas", 4)


def test_one_lane_placement_is_a_view():
    """A batch without a lane placement runs as one lane on the
    dispatcher's device: its arrays reach the slot as one-lane views (no
    copy) and its row comes back as the device gave it (codes included)."""
    p = sharded.Placement(sharded.Mesh(["cpu"]), (0, -1))
    a, b = np.arange(16).reshape(8, 2), np.arange(24).reshape(3, 8)
    host = p.split((a, b))[torch.device("cpu")]
    assert [x.shape for x in host] == [(1, 8, 2), (1, 3, 8)]
    assert np.shares_memory(host[0], a) and np.shares_memory(host[1], b)
    codes = np.arange(6, dtype=np.int32).reshape(2, 3)
    assert p.join({torch.device("cpu"): codes}).shape == (2, 3)


def test_aggblock_refused_in_mesh_mode():
    v = _verifier(_Stage())
    try:
        with pytest.raises(ValueError, match="ROADMAP.md queue 1"):
            v.submit(AggBlock.pad(1))
    finally:
        v.close()


def _signed(n: int, tag: int, bad=()) -> list:
    out = []
    for i in range(n):
        seed = hashlib.sha256(b"mesh %d %d" % (tag, i)).digest()
        m = b"mesh-%d-%d" % (tag, i)
        sig = _edwards.sign(seed, m)
        if i in bad:
            sig = sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:]
        out.append((_edwards.pubkey_from_seed(seed), m, sig))
    return out


@pytest.mark.parametrize("pallas,placed", [("0", True), ("1", True), ("0", False)])
def test_real_stage_two_lanes(monkeypatch, pallas, placed):
    """The real host stage (prepare_superbatch) with the plain kernels:
    two jobs in two lanes of 16 on Mesh(("cpu", "cpu")) (placed) or on
    the dispatcher's one device (simulated lanes); the op-graph check
    (TM_TPU_PALLAS=0) or the per-signature kernels."""
    monkeypatch.setenv("TM_TPU_PALLAS", pallas)
    m = sharded.Mesh(["cpu", "cpu"]) if placed else None
    seen = []
    real = mesh.prepare_superbatch

    def spy(block, plan, mesh=None):
        b = real(block, plan, mesh)
        seen.append(b.placement is not None)
        return b

    monkeypatch.setattr(mesh, "prepare_superbatch", spy)
    jobs = [_signed(9, 1, bad=(4,)), _signed(11, 2)]
    v = pl.AsyncBatchVerifier("cpu", mesh_lanes=2, lane_bucket=16, mesh=m)
    try:
        res = _together(v, [EntryBlock.from_entries(j) for j in jobs])
    finally:
        v.close()
    assert [r.tolist() for r in res] == [[_edwards.verify_zip215(*e) for e in j] for j in jobs]
    assert not res[0][4] and res[1].all()
    assert seen == [placed]


# -- (c) the scheme split -------------------------------------------------------------


def _mixed_set(n: int, seed: int, absent=(), bad=(), key_of=None):
    """(JValidatorSet, JBlockID, signed JCommit): validator i's key is
    secp256k1 when i % 3 == 1, else ed25519 (key_of overrides); powers
    10 + i."""
    rng = np.random.default_rng(seed)
    key_of = key_of or (lambda i: jsecp.PrivKey if i % 3 == 1 else jed.gen_priv_key)
    sks = [key_of(i)(rng.bytes(32)) for i in range(n)]
    vset = JValidatorSet.new([JValidator.new(sk.pub_key(), 10 + i) for i, sk in enumerate(sks)])
    by_addr = {sk.pub_key().address(): sk for sk in sks}
    h = hashlib.sha256(b"mesh block %d" % seed).digest()
    bid = JBlockID(hash=h, part_set_header=JPartSetHeader(total=1, hash=h[::-1]))
    sigs = [JCommitSig.absent() if i in absent else
            JCommitSig(BLOCK_ID_FLAG_COMMIT, v.address, JTimestamp(1_700_000_000 + i, i), b"")
            for i, v in enumerate(vset.validators)]
    commit = JCommit(height=HEIGHT, round=0, block_id=bid, signatures=sigs)
    signed = []
    for i, cs in enumerate(sigs):
        if cs.is_absent():
            signed.append(cs)
            continue
        sig = by_addr[cs.validator_address].sign(commit.vote_sign_bytes(CHAIN_ID, i))
        if i in bad:
            sig = sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:]
        signed.append(dataclasses.replace(cs, signature=sig))
    commit.signatures = signed
    return vset, bid, commit


@pytest.fixture(scope="module")
def mixed():
    return _mixed_set(9, 5)


def _split_both(vset, commit, needed):
    pvals, pcommit = convert.state_from_wire(vset.encode(), commit.encode())
    got = validation.prepare_commit_scheme_split(CHAIN_ID, pvals, pcommit, needed)
    ref = jvalidation.prepare_commit_scheme_split(CHAIN_ID, vset, commit, needed)
    return pvals, got, ref


def _host_verdicts(block) -> list:
    if block.scheme == "secp256k1":
        return [secp256k1.PubKey(p).verify_signature(m, s) for p, m, s in block.iter_entries()]
    return [_edwards.verify_zip215(*e) for e in block.iter_entries()]


def test_scheme_rows_and_split_equal_reference(mixed):
    vset, _, commit = mixed
    pvals, (blocks, conclude), (jblocks, jconclude) = _split_both(
        vset, commit, vset.total_voting_power() * 2 // 3)
    got_rows, ref_rows = pvals.scheme_rows(), vset.scheme_rows()
    assert all(np.array_equal(a, b) for a, b in zip(got_rows, ref_rows))
    assert got_rows[0].tolist().count(1) == 3
    assert [_block_view(b) for b in blocks] == [_block_view(b) for b in jblocks]
    assert [b.scheme for b in blocks] == ["ed25519", "secp256k1"]
    row = np.concatenate([_host_verdicts(b) for b in blocks])
    assert row.all() and conclude(row) is None and jconclude(row) is None


def test_scheme_split_blame_and_power_error_equal_reference(mixed):
    vset, _, commit = mixed
    needed = vset.total_voting_power() * 2 // 3
    _, (blocks, conclude), (_, jconclude) = _split_both(vset, commit, needed)
    n = sum(len(b) for b in blocks)
    for bad in [(i,) for i in range(n)] + [(1, n - 1), (0, n - 2)]:
        row = np.ones(n, bool)
        row[list(bad)] = False
        with pytest.raises(ValueError) as e1:
            conclude(row)
        with pytest.raises(ValueError) as e2:
            jconclude(row)
        assert str(e1.value) == str(e2.value)
    few = _mixed_set(9, 5, absent=(0, 2, 3, 5, 6, 8))
    with pytest.raises(ErrNotEnoughVotingPowerSigned) as e1:
        _split_both(few[0], few[2], needed)
    with pytest.raises(Exception) as e2:
        jvalidation.prepare_commit_scheme_split(CHAIN_ID, few[0], few[2], needed)
    assert str(e1.value) == str(e2.value)
    sr = _mixed_set(3, 6, key_of=lambda i: jsr.PrivKey if i == 2 else jed.gen_priv_key)
    pvals, pcommit = convert.state_from_wire(sr[0].encode(), sr[2].encode())
    assert pvals.scheme_rows() is None and sr[0].scheme_rows() is None
    with pytest.raises(validation.PrepareUnsupported, match="non-device key schemes"):
        validation.prepare_commit_scheme_split(CHAIN_ID, pvals, pcommit, 1)


def test_scheme_split_through_one_superbatch():
    """The committee with validators 3 (ed25519) and 4 (secp256k1)
    tampered, both inside the early stop: its two blocks through a
    mesh-mode dispatcher land in one superbatch of two segments; conclude
    raises the blame of #3."""
    vset, _, commit = _mixed_set(9, 5, bad=(3, 4))
    pvals, pcommit = convert.state_from_wire(vset.encode(), commit.encode())
    blocks, conclude = validation.prepare_commit_scheme_split(
        CHAIN_ID, pvals, pcommit, vset.total_voting_power() * 2 // 3)
    seen = []
    v = pl.AsyncBatchVerifier("cpu", mesh_lanes=2, lane_bucket=16)
    try:
        res = _together(v, blocks, seen)
    finally:
        v.close()
    assert [[(s, len(b)) for s, b, _ in block.parts] for block, _ in seen] == [
        [("ed25519", 16), ("secp256k1", 16)]]
    assert [r.tolist() for r in res] == [_host_verdicts(b) for b in blocks]
    assert res[0].tolist().count(False) == res[1].tolist().count(False) == 1
    with pytest.raises(ValueError, match=r"wrong signature \(#3\)"):
        conclude(np.concatenate(res))
