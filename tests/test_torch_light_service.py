"""The port's asynchronous seam of types/validation.py (prepare_commit_*),
SigCheck.prepare and the batched light service (light/batch.py,
light/service.py) against the JAX package's.

The chain is tests/test_torch_light.py's (16-validator ed25519 sets,
signed with the JAX package, carried over as wire bytes). The
prepare_commit_* cases compare the prepared batches column by column
and every conclude outcome over the host oracle's verdict row. The
service runs once end to end on the plain kernels (device="cpu") and
otherwise over a dispatcher whose stage is the host oracle; its
verdicts must equal the JAX package's sequential light.verifier.verify
for the same requests: the same outcome, error type and string.

Every wait has a timeout; verifiers are closed in a finally, and the
shared ones reset around each test.
"""

import dataclasses
import os

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tendermint_tpu.crypto import batch as jbatch  # noqa: E402
from tendermint_tpu.crypto import ed25519 as jed  # noqa: E402
from tendermint_tpu.light import batch as jlbatch  # noqa: E402
from tendermint_tpu.light import service as jservice  # noqa: E402
from tendermint_tpu.light import verifier as jverifier  # noqa: E402
from tendermint_tpu.types import validation as jvalidation  # noqa: E402
from tendermint_tpu.types.block import (  # noqa: E402
    BLOCK_ID_FLAG_ABSENT,
    Commit as JCommit,
    CommitSig as JCommitSig,
)
from tendermint_tpu.types.validation import Fraction as JFraction  # noqa: E402
from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet  # noqa: E402
from tendermint_tpu.wire.canonical import Timestamp as JTimestamp  # noqa: E402
from tendermint_tpu_torch.crypto import _edwards  # noqa: E402
from tendermint_tpu_torch.light import batch as plbatch  # noqa: E402
from tendermint_tpu_torch.light import service as pservice  # noqa: E402
from tendermint_tpu_torch.light import verifier as pverifier  # noqa: E402
from tendermint_tpu_torch.ops import epoch_cache  # noqa: E402
from tendermint_tpu_torch.ops import pipeline as pl  # noqa: E402
from tendermint_tpu_torch.types import block as pblock  # noqa: E402
from tendermint_tpu_torch.types import validation as pvalidation  # noqa: E402
from tendermint_tpu_torch.types import validator_set as pvalidator_set  # noqa: E402
from tendermint_tpu_torch.wire.canonical import Timestamp as PTimestamp  # noqa: E402
from tests.test_torch_light import (  # noqa: E402
    CHAIN_ID,
    DRIFT,
    NOW,
    PERIOD,
    _block,
    _port,
    _tampered_commit,
    _vset,
    chain,
)

# The plain versions run thousands of small tensor ops: one intra-op
# thread keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

WAIT = 120  # seconds any one verdict stream may take

assert chain  # the module-scoped chain fixture, imported for its use here


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setattr(jbatch, "_device_verifier_factory", None)
    pl.reset_shared()
    epoch_cache.reset()
    yield
    pl.reset_shared()
    epoch_cache.reset()


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome under test is the exception itself
        return type(e).__name__, str(e)
    return None


def _oracle_row(entries) -> np.ndarray:
    return np.array([_edwards.verify_zip215(p, m, s) for p, m, s in entries.iter_entries()],
                    dtype=bool)


def _prepared_outcome(prep):
    """(outcome of the prepare, outcome of conclude over the oracle row,
    the block's columns) of one side."""
    got = []

    def run():
        entries, conclude = prep()
        got.append(entries)
        if conclude is not None:
            conclude(_oracle_row(entries))

    out = _outcome(run)
    blk = got[0] if got else None
    cols = None if blk is None else (blk.pub.tobytes(), blk.sig.tobytes(),
                                     bytes(memoryview(blk.msgs)[int(blk.offsets[0]):
                                                                int(blk.offsets[-1])]),
                                     None if blk.val_idx is None else blk.val_idx.tolist())
    return out, cols


def _low(commit, keep_every: int):
    sigs = [cs if i % keep_every == 0 else JCommitSig(BLOCK_ID_FLAG_ABSENT)
            for i, cs in enumerate(commit.signatures)]
    return JCommit(commit.height, commit.round, commit.block_id, sigs)


def _double(commit, frm: int, to: int):
    sigs = list(commit.signatures)
    sigs[to] = dataclasses.replace(sigs[to], validator_address=sigs[frm].validator_address)
    return JCommit(commit.height, commit.round, commit.block_id, sigs)


def _pc(commit):
    return None if commit is None else pblock.Commit.decode(commit.encode())


def _pv(vals):
    return None if vals is None else pvalidator_set.ValidatorSet.decode(vals.encode())


def _light_cases(chain):
    b2 = chain["blocks"][2]
    jv, jc = b2.validators, b2.signed_header.commit
    bid = jc.block_id
    return {
        "valid": (jv, bid, 2, jc),
        "tampered": (jv, bid, 2, _tampered_commit(jc, 1)),
        "low_power": (jv, bid, 2, _low(jc, 4)),
        "wrong_height": (jv, bid, 3, jc),
        "wrong_set_size": (JValidatorSet.new(jv.validators[:-1]), bid, 2, jc),
    }


@pytest.mark.parametrize("case", ["valid", "tampered", "low_power", "wrong_height",
                                  "wrong_set_size"])
def test_prepare_commit_light_matches_jax(chain, case):
    jv, bid, h, jc = _light_cases(chain)[case]
    from tendermint_tpu_torch.types.block import BlockID

    want = _prepared_outcome(lambda: jvalidation.prepare_commit_light(CHAIN_ID, jv, bid, h, jc))
    got = _prepared_outcome(lambda: pvalidation.prepare_commit_light(
        CHAIN_ID, _pv(jv), BlockID.decode(bid.encode()), h, _pc(jc)))
    assert got == want
    if case == "tampered":
        assert want[0][1].startswith("wrong signature (#1): ")


def _trusting_cases(chain):
    b10 = chain["blocks"][10].signed_header.commit
    b17 = chain["blocks"][17].signed_header.commit
    v1 = chain["v1"][0]
    idx = next(i for i, cs in enumerate(b10.signatures)
               if v1.get_by_address(cs.validator_address)[1] is not None)
    return {
        "valid": (v1, b10, (1, 3)),
        "tampered": (v1, _tampered_commit(b10, idx), (1, 3)),
        "not_enough_trust": (v1, b17, (1, 3)),
        "double_vote": (v1, _double(b10, idx, idx + 1), (1, 3)),
        "zero_denominator": (v1, b10, (1, 0)),
        "nil_commit": (v1, None, (1, 3)),
    }


@pytest.mark.parametrize("case", ["valid", "tampered", "not_enough_trust", "double_vote",
                                  "zero_denominator", "nil_commit"])
def test_prepare_commit_light_trusting_matches_jax(chain, case):
    jv, jc, (num, den) = _trusting_cases(chain)[case]
    want = _prepared_outcome(lambda: jvalidation.prepare_commit_light_trusting(
        CHAIN_ID, jv, jc, JFraction(num, den)))
    got = _prepared_outcome(lambda: pvalidation.prepare_commit_light_trusting(
        CHAIN_ID, _pv(jv), _pc(jc), pvalidation.Fraction(num, den)))
    assert got == want
    expect = {"valid": None, "tampered": "wrong signature (#",
              "not_enough_trust": "invalid commit -- insufficient voting power",
              "double_vote": "double vote from", "zero_denominator": "trustLevel has zero",
              "nil_commit": "nil commit"}[case]
    assert want[0] is None if expect is None else want[0][1].startswith(expect)


@pytest.mark.parametrize("case", ["valid", "tampered", "nil_vote"])
def test_prepare_commit_batch_with_verify_commit_predicates_matches_jax(chain, case):
    """verify_commit's predicates: every non-absent signature, nil votes
    included, power counted for the block only."""
    b3 = chain["blocks"][3]
    jv, jc = b3.validators, b3.signed_header.commit
    if case == "tampered":
        jc = _tampered_commit(jc, 15)
    if case == "nil_vote":
        sigs = list(jc.signatures)
        sigs[4] = dataclasses.replace(sigs[4], block_id_flag=3)  # a nil vote, its sig now bad
        jc = JCommit(jc.height, jc.round, jc.block_id, sigs)
    need = jv.total_voting_power() * 2 // 3
    want = _prepared_outcome(lambda: jvalidation.prepare_commit_batch(
        CHAIN_ID, jv, jc, need, jvalidation._ignore_absent, jvalidation._count_for_block,
        True, True))
    got = _prepared_outcome(lambda: pvalidation.prepare_commit_batch(
        CHAIN_ID, _pv(jv), _pc(jc), need, pvalidation._ignore_absent,
        pvalidation._count_for_block, True, True))
    assert got == want
    assert want[0] is None if case == "valid" else want[0][1].startswith("wrong signature (#")


def test_prepare_commit_range_matches_jax(chain):
    blocks = chain["blocks"]
    jv = blocks[1].validators
    items = [(h, blocks[h].signed_header.commit.block_id, blocks[h].signed_header.commit)
             for h in (1, 2, 3)]
    jprep, jsynced = jvalidation.prepare_commit_range(CHAIN_ID, jv, items)
    pv = _pv(jv)
    from tendermint_tpu_torch.types.block import BlockID

    pprep, psynced = pvalidation.prepare_commit_range(
        CHAIN_ID, pv, [(h, BlockID.decode(b.encode()), _pc(c)) for h, b, c in items])
    assert psynced == jsynced == []
    assert [h for h, _, _ in pprep] == [h for h, _, _ in jprep] == [1, 2, 3]
    for (_, pe, _), (_, je, _) in zip(pprep, jprep):
        assert pe.pub.tobytes() == je.pub.tobytes() and pe.sig.tobytes() == je.sig.tobytes()
    # a one-validator set rides the single-signature path: synced at once
    lone = _block(1, _vset(range(60, 61), 9), _vset(range(60, 61), 9))
    lc = lone.signed_header.commit
    got = pvalidation.prepare_commit_range(
        CHAIN_ID, _pv(lone.validators), [(1, BlockID.decode(lc.block_id.encode()), _pc(lc))])
    assert got == ([], [1])
    assert jvalidation.prepare_commit_range(CHAIN_ID, lone.validators,
                                            [(1, lc.block_id, lc)]) == ([], [1])
    # a host failure raises what verify_commit_light raises for its height
    bad = items[:1] + [(5, items[1][1], items[1][2])]
    want = _outcome(lambda: jvalidation.prepare_commit_range(CHAIN_ID, jv, bad))
    got = _outcome(lambda: pvalidation.prepare_commit_range(
        CHAIN_ID, pv, [(h, BlockID.decode(b.encode()), _pc(c)) for h, b, c in bad]))
    assert got == want and want[1].startswith("invalid commit height")


def test_sig_check_prepare_wraps_as_run_sync(chain):
    b1, b10 = _port(chain["blocks"][1]), _port(chain["blocks"][10])
    checks = pverifier.prepare_non_adjacent(
        b1.signed_header, b1.validators, b10.signed_header, b10.validators,
        PERIOD, PTimestamp(*NOW), DRIFT, pvalidation.DEFAULT_TRUST_LEVEL, device="cpu")
    assert [c.kind for c in checks] == ["trusting", "light"]
    for chk in checks:
        entries, conclude = chk.prepare()
        row = _oracle_row(entries)
        conclude(row)
        row[0] = False
        with pytest.raises(pverifier.ErrInvalidHeader, match=r"wrong signature \(#"):
            conclude(row)


# -- the service --------------------------------------------------------------------


def _requests(chain, module, now):
    """(name, request) pairs for one package's light.batch.HeaderRequest."""
    port = module is plbatch
    conv = _port if port else (lambda lb: lb)
    b = {h: conv(lb) for h, lb in chain["blocks"].items()}
    lb2 = chain["blocks"][2]
    forged = dataclasses.replace(lb2, signed_header=dataclasses.replace(
        lb2.signed_header, commit=_tampered_commit(lb2.signed_header.commit, 3)))
    forged = conv(forged)

    def req(t, u, at=None):
        return module.HeaderRequest(b[t].signed_header, b[t].validators, b[u].signed_header,
                                    b[u].validators, PERIOD, now=at or now)

    late = (JTimestamp if not port else PTimestamp)(NOW[0] + int(PERIOD) + 100, 0)
    return [
        ("adjacent", req(1, 2)),
        ("skipping", req(1, 10)),
        ("no_trust", req(1, 17)),
        ("forged", module.HeaderRequest(b[1].signed_header, b[1].validators,
                                        forged.signed_header, forged.validators, PERIOD,
                                        now=now)),
        ("expired", req(1, 3, at=late)),
        ("backwards", req(3, 2)),
    ]


def _sequential(chain) -> list:
    """The JAX package's sequential verifier's verdict dicts."""
    out = []
    for i, (_, r) in enumerate(_requests(chain, jlbatch, JTimestamp(*NOW))):
        o = _outcome(lambda: jverifier.verify(
            r.trusted_header, r.trusted_vals, r.untrusted_header, r.untrusted_vals,
            r.trusting_period, r.now, r.max_clock_drift, r.trust_level))
        out.append({"index": i, "height": str(r.untrusted_header.header.height),
                    "ok": o is None, "error": None if o is None else o[1],
                    "error_type": None if o is None else o[0]})
    return out


class _OracleBatch:
    """A prepared batch whose kernel is the host oracle."""

    def __init__(self, entries, log):
        self.bucket = len(entries)
        self.args = (np.zeros(1, np.uint8),)
        self._row = _oracle_row(entries)
        log.append(len(entries))

    def launch(self, dev_args):
        return torch.from_numpy(self._row.astype(np.int32))[None, :]

    def conclude(self, row):
        return row[0].astype(bool)


def test_light_service_on_the_plain_kernels_matches_the_sequential_verifier(chain):
    want = _sequential(chain)
    svc = pservice.LightVerifyService(device="cpu")
    try:
        reqs = [r for _, r in _requests(chain, plbatch, PTimestamp(*NOW))]
        got = svc.submit_many(reqs).results(timeout=WAIT)
    finally:
        svc.close()
    assert got == want
    assert [v["ok"] for v in got] == [True, True, False, False, False, False]
    assert got[2]["error_type"] == "ErrNotEnoughTrust"
    assert got[3]["error_type"] == "ErrInvalidHeader" and "wrong signature (#3)" in got[3]["error"]
    assert len(pl.shared_verifier("cpu").dispatch_thread_idents) == 1


def test_light_service_memo_single_flight_and_stats(chain):
    want = _sequential(chain)
    log = []
    v = pl.AsyncBatchVerifier("cpu", prepare=lambda e: _OracleBatch(e, log))
    svc = pservice.LightVerifyService(verifier=v)
    try:
        reqs = [r for _, r in _requests(chain, plbatch, PTimestamp(*NOW))]
        first = svc.submit_many(reqs + reqs[:2])
        got = first.results(timeout=WAIT)
        assert got[: len(reqs)] == want
        assert [dict(g, index=i) for i, g in enumerate(got[len(reqs):])] == want[:2]
        launched = len(log)
        again = svc.submit_many(reqs).results(timeout=WAIT)
        assert again == want and len(log) == launched  # all from the memo
        s = svc.stats()
        assert s["requests"] == 2 * len(reqs) + 2
        assert s["unique"] == len(reqs)
        assert s["memo_hits"] + s["inflight_joins"] == len(reqs) + 2
        assert s["rejected"] == 4 and s["inflight"] == 0
        # a closed dispatcher is an infrastructure failure: reported, not kept
        v.close()
        fresh = _requests(chain, plbatch, PTimestamp(NOW[0] + 1, 0))[0][1]
        failed = svc.submit(fresh, timeout=WAIT)
        assert failed["error_type"] == "RuntimeError" and "closed" in failed["error"]
        assert svc.stats()["memo_entries"] == len(reqs)
    finally:
        svc.close()
        v.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit_many(reqs)


def test_verdict_stream_deadline():
    vb = pservice.VerdictBatch(2)
    vb._push({"index": 1})
    it = vb.stream(timeout=0.05)
    assert next(it) == {"index": 1}
    with pytest.raises(TimeoutError, match="1 of 2"):
        next(it)


def test_fingerprint_and_json_forms_match_jax(chain):
    jreqs = _requests(chain, jlbatch, JTimestamp(*NOW))
    preqs = _requests(chain, plbatch, PTimestamp(*NOW))
    for (name, jr), (_, pr) in zip(jreqs, preqs):
        assert pservice.request_to_json(pr) == jservice.request_to_json(jr), name
        back = pservice.request_from_json(jservice.request_to_json(jr))
        assert plbatch.fingerprint(back, back.now) == plbatch.fingerprint(pr, pr.now), name
        assert plbatch.fingerprint(pr, pr.now) == jlbatch.fingerprint(jr, jr.now), name
    incomplete = dataclasses.replace(preqs[0][1], untrusted_header=dataclasses.replace(
        preqs[0][1].untrusted_header, header=dataclasses.replace(
            preqs[0][1].untrusted_header.header, validators_hash=b"")))
    assert plbatch.fingerprint(incomplete, incomplete.now) is None


def test_group_stats_counts_stage_blocks_per_epoch(chain):
    reqs = [r for _, r in _requests(chain, plbatch, PTimestamp(*NOW))]
    plans = [plbatch.prepare_request(r, r.now, device="cpu") for r in reqs]
    groups = plbatch.group_stats(plans)
    # adjacent 1 (+2/3), skipping 2 (trusting, +2/3), forged 1; no_trust,
    # expired and backwards fail before any block
    assert sum(groups.values()) == 4
    assert [p.error is not None for p in plans] == [False, False, False, False, True, True]
    assert jed  # the JAX key type is the chain's
