"""The port's light-client path (tendermint_tpu_torch/light/, the
trusting check of types/validation.py, Header and SignedHeader of
types/block.py, types/evidence.py) against the JAX package's.

A chain of 16-validator ed25519 sets is built and signed with the JAX
package: heights 1, 2 and 3 by V1 (keys 0..15), 10 by V2 (keys 8..23)
and 17 by V3 (keys 16..31), each set with its own seeded powers, so
V2's rows are not V1's and V1 cannot trust V3 directly. Blocks cross
into the port as wire bytes (convert.light_block_from_wire). The JAX
side verifies on its host batch verifier (crypto.batch's device factory
unset); the port runs on device="cpu" through the plain versions of the
kernels, where a batch below 64 signatures verifies on the host and
the cases that lower that threshold run the RLC batch path. Every case
compares outcomes: None, or the same exception class name and a
byte-identical message.
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
from tendermint_tpu.db import MemDB as JMemDB  # noqa: E402
from tendermint_tpu.light import verifier as jverifier  # noqa: E402
from tendermint_tpu.light.client import Client as JClient  # noqa: E402
from tendermint_tpu.light.client import TrustOptions as JTrustOptions  # noqa: E402
from tendermint_tpu.light.client import make_attack_evidence as jmake_evidence  # noqa: E402
from tendermint_tpu.light.provider import ErrLightBlockNotFound as JNotFound  # noqa: E402
from tendermint_tpu.light.provider import LightBlock as JLightBlock  # noqa: E402
from tendermint_tpu.light.provider import Provider as JProvider  # noqa: E402
from tendermint_tpu.light.store import LightStore as JLightStore  # noqa: E402
from tendermint_tpu.types import validation as jvalidation  # noqa: E402
from tendermint_tpu.types.block import (  # noqa: E402
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BlockID as JBlockID,
    Commit as JCommit,
    CommitSig as JCommitSig,
    Header as JHeader,
    PartSetHeader as JPartSetHeader,
    SignedHeader as JSignedHeader,
    Version as JVersion,
)
from tendermint_tpu.types.evidence import LightClientAttackEvidence as JEvidence  # noqa: E402
from tendermint_tpu.types.validator_set import (  # noqa: E402
    Validator as JValidator,
    ValidatorSet as JValidatorSet,
)
from tendermint_tpu.wire.canonical import Timestamp as JTimestamp  # noqa: E402
from tendermint_tpu_torch import convert  # noqa: E402
from tendermint_tpu_torch import db as pdb  # noqa: E402
from tendermint_tpu_torch.light import client as pclient  # noqa: E402
from tendermint_tpu_torch.light import provider as pprovider  # noqa: E402
from tendermint_tpu_torch.light import store as pstore  # noqa: E402
from tendermint_tpu_torch.light import verifier as pverifier  # noqa: E402
from tendermint_tpu_torch.ops import backend, epoch_cache, rlc  # noqa: E402
from tendermint_tpu_torch.types import block as pblock  # noqa: E402
from tendermint_tpu_torch.types import evidence as pevidence  # noqa: E402
from tendermint_tpu_torch.types import validation as pvalidation  # noqa: E402
from tendermint_tpu_torch.types import validator_set as pvalidator_set  # noqa: E402
from tendermint_tpu_torch.wire.canonical import Timestamp as PTimestamp  # noqa: E402

# The plain versions run thousands of small tensor ops: one intra-op
# thread keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

CHAIN_ID = "torch-light"
T0 = 1_700_000_000
PERIOD = 14 * 24 * 3600.0
DRIFT = 10.0
NOW = (T0 + 1000, 0)
N = 16


@pytest.fixture(autouse=True)
def _jax_host_verifier(monkeypatch):
    monkeypatch.setattr(jbatch, "_device_verifier_factory", None)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome under test is the exception itself
        return type(e).__name__, str(e)
    return None


def _key(i: int):
    return jed.gen_priv_key(hashlib.sha256(b"torch light key %d" % i).digest())


def _vset(idxs, seed: int):
    """(JValidatorSet, address -> key) of the keys idxs, seeded powers."""
    sks = [_key(i) for i in idxs]
    powers = np.random.default_rng(seed).integers(1, 100, len(sks))
    vset = JValidatorSet.new([JValidator.new(sk.pub_key(), int(p)) for sk, p in zip(sks, powers)])
    return vset, {sk.pub_key().address(): sk for sk in sks}


def _sign(vset, sks, height: int, bid, round_: int = 0):
    """A JCommit of every validator of vset for bid."""
    sigs = [JCommitSig(BLOCK_ID_FLAG_COMMIT, v.address, JTimestamp(T0 + 10 * height, i + 1), b"")
            for i, v in enumerate(vset.validators)]
    commit = JCommit(height=height, round=round_, block_id=bid, signatures=sigs)
    commit.signatures = [
        dataclasses.replace(cs, signature=sks[cs.validator_address].sign(
            commit.vote_sign_bytes(CHAIN_ID, i)))
        for i, cs in enumerate(sigs)
    ]
    return commit


def _block(height: int, vs, next_vs, prev_hash: bytes = b"", round_: int = 0, **fields):
    vset, sks = vs
    h = hashlib.sha256(b"%d" % height).digest()
    hdr = JHeader(
        version=JVersion(11, 1), chain_id=CHAIN_ID, height=height,
        time=JTimestamp(T0 + 10 * height, 5),
        last_block_id=(JBlockID(prev_hash, JPartSetHeader(1, prev_hash[::-1]))
                       if prev_hash else JBlockID()),
        last_commit_hash=h, data_hash=h[::-1], validators_hash=vset.hash(),
        next_validators_hash=next_vs[0].hash(), consensus_hash=b"\x01" * 32,
        app_hash=b"\x02" * 32, evidence_hash=hashlib.sha256(h).digest(),
        proposer_address=vset.validators[0].address,
    )
    if fields:
        hdr = dataclasses.replace(hdr, **fields)
    bid = JBlockID(hdr.hash(), JPartSetHeader(2, hashlib.sha256(hdr.hash()).digest()))
    return JLightBlock(JSignedHeader(hdr, _sign(vset, sks, height, bid, round_)), vset)


@pytest.fixture(scope="module")
def chain():
    v1, v2, v3 = _vset(range(0, 16), 1), _vset(range(8, 24), 2), _vset(range(16, 32), 3)
    blocks = {}
    prev = b""
    for h, vs, nvs in ((1, v1, v1), (2, v1, v1), (3, v1, v1), (10, v2, v2), (17, v3, v3)):
        blocks[h] = _block(h, vs, nvs, prev)
        prev = blocks[h].hash()
    extra = {
        # height 2 signed by V2, whose hash header 1's next_validators_hash is not
        "2_v2": _block(2, v2, v2, blocks[1].hash()),
        # a lunatic header at 17 (forged app hash), signed by V3
        "17_lunatic": _block(17, v3, v3, blocks[10].hash(), app_hash=b"\x66" * 32),
        # an equivocation at 17: same state hashes, another block
        "17_equivocation": _block(17, v3, v3, blocks[10].hash(), data_hash=b"\x77" * 32),
        # the same at round 1 (amnesia: no byzantine validators deducible)
        "17_amnesia": _block(17, v3, v3, blocks[10].hash(), round_=1, data_hash=b"\x78" * 32),
    }
    return {"blocks": blocks, "extra": extra, "v1": v1, "v2": v2, "v3": v3}


_PORTED = {}


def _port(lb):
    """The port's LightBlock of a JAX one, carried as wire bytes (cached
    per block, so the port's sets keep their caches as a node's would)."""
    key = id(lb)
    if key not in _PORTED:
        sh = lb.signed_header
        _PORTED[key] = (lb, convert.light_block_from_wire(
            sh.header.encode(), sh.commit.encode(), lb.validators.encode()))
    return _PORTED[key][1]


def _ident(lb):
    return lb


JAX = (jverifier, _ident, JTimestamp(*NOW), {})
PORT = (pverifier, _port, PTimestamp(*NOW), {"device": "cpu"})


def _both(case):
    """(JAX outcome, port outcome) of case(verifier module, block
    converter, now, device kwargs)."""
    return _outcome(lambda: case(*JAX)), _outcome(lambda: case(*PORT))


def _tampered_commit(commit, idx: int):
    sigs = list(commit.signatures)
    bad = bytearray(sigs[idx].signature)
    bad[40] ^= 0x10
    sigs[idx] = dataclasses.replace(sigs[idx], signature=bytes(bad))
    return JCommit(commit.height, commit.round, commit.block_id, sigs)


def _early_stop(commit, trusted, num: int, den: int) -> int:
    """Signatures the trusting check of `trusted` selects before its tally
    passes num/den of its power (by address, in commit order)."""
    power = {v.address: v.voting_power for v in trusted.validators}
    needed = trusted.total_voting_power() * num // den
    got = 0
    for i, cs in enumerate(commit.signatures):
        got += power.get(cs.validator_address, 0)
        if got > needed:
            return i + 1
    return len(commit.signatures)


# -- ValidatorSet lookups -----------------------------------------------------


def test_get_by_address_and_index_match_the_reference(chain):
    jvals = chain["v2"][0]
    pvals = _port(chain["blocks"][10]).validators
    for v in chain["v1"][0].validators + jvals.validators:
        ji, jv = jvals.get_by_address(v.address)
        pi, pv = pvals.get_by_address(v.address)
        assert pi == ji
        assert repr(pv) == repr(jv)
    assert pvals.get_by_address(b"\x00" * 20) == (-1, None)
    for i in (-1, 0, 7, N - 1, N):
        ja, jv = jvals.get_by_index(i)
        pa, pv = pvals.get_by_index(i)
        assert (pa, repr(pv)) == (ja, repr(jv))
    # a copy: changing it leaves the set as it was
    _, pv = pvals.get_by_address(pvals.validators[3].address)
    pv.voting_power += 1
    assert pvals.validators[3].voting_power == pv.voting_power - 1


# -- verify_commit_light_trusting --------------------------------------------


def _trusting_both(jvals, commit, num: int, den: int):
    from tendermint_tpu.types.validation import Fraction as JFraction

    pvals = None if jvals is None else pvalidator_set.ValidatorSet.decode(jvals.encode())
    pcommit = None if commit is None else pblock.Commit.decode(commit.encode())
    want = _outcome(lambda: jvalidation.verify_commit_light_trusting(
        CHAIN_ID, jvals, commit, JFraction(num, den)))
    got = _outcome(lambda: pvalidation.verify_commit_light_trusting(
        CHAIN_ID, pvals, pcommit, pvalidation.Fraction(num, den), device="cpu"))
    return want, got


def _first_known(commit, vset) -> int:
    """Index of the first signature of commit whose address is in vset."""
    return next(i for i, cs in enumerate(commit.signatures)
                if vset.get_by_address(cs.validator_address)[1] is not None)


def _trusting_case(chain, name: str):
    """(trusted JValidatorSet, JCommit, num, den, expected prefix or None)."""
    v1 = chain["v1"][0]
    c1 = chain["blocks"][1].signed_header.commit
    c10 = chain["blocks"][10].signed_header.commit
    c17 = chain["blocks"][17].signed_header.commit
    if name == "valid_own_set":
        return v1, c1, 1, 3, None
    if name == "valid_unknown_addresses_skipped":
        return v1, c10, 1, 3, None
    if name == "valid_reordered_set":
        # V1's keys with other powers: the same size, another row order
        return _vset(range(0, 16), 5)[0], c1, 1, 3, None
    if name == "valid_bigger_set":
        return _vset(range(0, 24), 4)[0], c1, 1, 3, None
    if name == "full_trust_level":
        return v1, c1, 1, 1, "invalid commit -- insufficient voting power: got "
    if name == "not_enough_trust":
        return v1, c17, 1, 3, "invalid commit -- insufficient voting power: got 0"
    if name == "overflow":
        return v1, c1, 1 << 62, 1, "int64 overflow"
    if name == "zero_denominator":
        return v1, c1, 1, 0, "trustLevel has zero Denominator"
    if name == "nil_set":
        return None, c1, 1, 3, "nil validator set"
    if name == "nil_commit":
        return v1, None, 1, 3, "nil commit"
    if name == "double_vote":
        sigs = list(c1.signatures)
        sigs[1] = sigs[0]
        return v1, JCommit(c1.height, c1.round, c1.block_id, sigs), 1, 3, \
            "double vote from Validator("
    if name == "tampered_inside_early_stop":
        i = _first_known(c10, v1)
        return v1, _tampered_commit(c10, i), 1, 3, f"wrong signature (#{i}): "
    if name == "tampered_past_early_stop":
        return v1, _tampered_commit(c10, N - 1), 1, 3, None
    raise AssertionError(name)


TRUSTING_CASES = [
    "valid_own_set", "valid_unknown_addresses_skipped", "valid_reordered_set",
    "valid_bigger_set", "full_trust_level", "not_enough_trust", "overflow",
    "zero_denominator", "nil_set", "nil_commit", "double_vote",
    "tampered_inside_early_stop", "tampered_past_early_stop",
]


@pytest.mark.parametrize("name", TRUSTING_CASES)
def test_verify_commit_light_trusting_matches_the_reference(chain, name):
    jvals, commit, num, den, expected = _trusting_case(chain, name)
    want, got = _trusting_both(jvals, commit, num, den)
    assert got == want
    if expected is None:
        assert want is None
    else:
        assert want is not None and want[1].startswith(expected), want


def test_trusting_cases_reorder_rows_and_stop_early(chain):
    """The cases above mean what they say: the reordered set's rows of
    height 1's signers are not their indices in the commit (the fused
    prep, which selects by index, would check the wrong keys), and the
    signature tampered past the early stop is never selected."""
    c1 = chain["blocks"][1].signed_header.commit
    reordered = _trusting_case(chain, "valid_reordered_set")[0]
    assert reordered.size() == len(c1.signatures)
    rows = [reordered.get_by_address(cs.validator_address)[0] for cs in c1.signatures]
    assert sorted(rows) == list(range(N)) and rows != list(range(N))
    c10 = chain["blocks"][10].signed_header.commit
    assert _early_stop(c10, chain["v1"][0], 1, 3) < N - 1


@pytest.mark.parametrize("name", ["valid_reordered_set", "valid_unknown_addresses_skipped",
                                  "tampered_inside_early_stop"])
def test_trusting_by_address_cold_and_warm_on_the_batch_path(chain, name, monkeypatch):
    """The trusting check's batch on the RLC path (the plain kernels),
    first cold, then warm on the trusted set's epoch table: the key rows
    must be the trusted set's, not the signatures' indices."""
    monkeypatch.setattr(backend, "DEVICE_THRESHOLD", 2)
    # a lane the kernels reject is verified again on the host, which would
    # hide wrong key rows: every lane but a tampered one must pass on the
    # kernels themselves
    rejected = []
    expand = rlc.expand_lanes

    def spy(lane_valid, entries):
        rejected.append(int((~lane_valid).sum()))
        return expand(lane_valid, entries)

    monkeypatch.setattr(rlc, "expand_lanes", spy)
    epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
    try:
        jvals, commit, num, den, _ = _trusting_case(chain, name)
        outcomes = [_trusting_both(jvals, commit, num, den) for _ in range(2)]
        stats = epoch_cache.stats()
    finally:
        epoch_cache.reset()
    for want, got in outcomes:
        assert got == want
    assert (stats["misses"], stats["hits"]) == (1, 1)
    assert rejected == [int(name.startswith("tampered"))] * 2


@pytest.mark.parametrize("name", ["tampered_inside_early_stop", "not_enough_trust"])
def test_trusting_on_the_host_below_the_batch_threshold(chain, name, monkeypatch):
    """One signature: the single-signature path, by address."""
    jvals, commit, num, den, _ = _trusting_case(chain, name)
    one = JCommit(commit.height, commit.round, commit.block_id, list(commit.signatures)[:1])
    want, got = _trusting_both(jvals, one, num, den)
    assert got == want and want is not None


def test_validate_hash_matches_the_reference():
    for h in (b"", b"\x01" * 32, b"\x01" * 31, b"\x01" * 33):
        assert _outcome(lambda: pvalidation.validate_hash(h)) == \
            _outcome(lambda: jvalidation.validate_hash(h))


# -- Header -------------------------------------------------------------------


def _random_header(seed: int):
    rng = np.random.default_rng(seed)

    def b(n=32):
        return rng.bytes(n) if rng.random() < 0.8 else b""

    bid = JBlockID(b(), JPartSetHeader(int(rng.integers(0, 1 << 20)), b())) \
        if rng.random() < 0.8 else JBlockID()
    return JHeader(
        version=JVersion(int(rng.integers(0, 1 << 40)), int(rng.integers(0, 1 << 20))),
        chain_id="".join(chr(c) for c in rng.integers(0x20, 0x7f, int(rng.integers(0, 50)))),
        height=int(rng.integers(0, 1 << 62)) * (1 if rng.random() < 0.9 else -1),
        time=JTimestamp(int(rng.integers(-(1 << 40), 1 << 40)), int(rng.integers(0, 10**9))),
        last_block_id=bid, last_commit_hash=b(), data_hash=b(),
        validators_hash=rng.bytes(32) if seed % 4 else b"", next_validators_hash=b(),
        consensus_hash=b(), app_hash=b(int(rng.integers(0, 40))), last_results_hash=b(),
        evidence_hash=b(), proposer_address=b(20),
    )


@pytest.mark.parametrize("seed", range(8))
def test_header_hash_encode_decode_match_the_reference(seed):
    jh = _random_header(seed)
    raw = jh.encode()
    ph = pblock.Header.decode(raw)
    assert ph.encode() == raw
    assert ph.hash() == jh.hash()
    assert ph.hash() is ph.hash()  # memoized
    assert _outcome(ph.validate_basic) == _outcome(jh.validate_basic)
    assert dataclasses.replace(ph, app_hash=b"\x09" * 32).hash() == \
        dataclasses.replace(jh, app_hash=b"\x09" * 32).hash()


# -- validate_basic -----------------------------------------------------------


def _sh_case(chain, name: str):
    """A JSignedHeader for one validate_basic case."""
    lb = chain["blocks"][2]
    hdr, commit = lb.signed_header.header, lb.signed_header.commit
    sigs = list(commit.signatures)

    def with_sig(i, **kw):
        s = list(sigs)
        s[i] = dataclasses.replace(s[i], **kw)
        return JSignedHeader(hdr, JCommit(commit.height, commit.round, commit.block_id, s))

    cases = {
        "valid": lambda: lb.signed_header,
        "valid_with_absent": lambda: with_sig(4, block_id_flag=BLOCK_ID_FLAG_ABSENT,
                                              validator_address=b"", signature=b"",
                                              timestamp=JTimestamp.zero()),
        "other_chain": lambda: JSignedHeader(dataclasses.replace(hdr, chain_id="other"), commit),
        "height_mismatch": lambda: JSignedHeader(dataclasses.replace(hdr, height=5), commit),
        "hash_mismatch": lambda: JSignedHeader(dataclasses.replace(hdr, app_hash=b"\x03" * 32),
                                               commit),
        "chain_id_too_long": lambda: JSignedHeader(dataclasses.replace(hdr, chain_id="c" * 51),
                                                   commit),
        "zero_height": lambda: JSignedHeader(dataclasses.replace(hdr, height=0), commit),
        "negative_height": lambda: JSignedHeader(dataclasses.replace(hdr, height=-2), commit),
        "wrong_data_hash_size": lambda: JSignedHeader(
            dataclasses.replace(hdr, data_hash=b"\x01" * 31), commit),
        "wrong_proposer_size": lambda: JSignedHeader(
            dataclasses.replace(hdr, proposer_address=b"\x01" * 19), commit),
        "wrong_last_block_id": lambda: JSignedHeader(
            dataclasses.replace(hdr, last_block_id=JBlockID(b"\x01" * 5)), commit),
        "commit_negative_round": lambda: JSignedHeader(
            hdr, JCommit(commit.height, -1, commit.block_id, sigs)),
        "commit_nil_block": lambda: JSignedHeader(hdr, JCommit(commit.height, 0, JBlockID(), sigs)),
        "commit_no_signatures": lambda: JSignedHeader(
            hdr, JCommit(commit.height, 0, commit.block_id, [])),
        "sig_too_big": lambda: with_sig(3, signature=sigs[3].signature + b"\x00"),
        "sig_missing": lambda: with_sig(5, signature=b""),
        "address_size": lambda: with_sig(6, validator_address=b"\x01" * 19),
        "unknown_flag": lambda: with_sig(7, block_id_flag=9),
        "absent_with_address": lambda: with_sig(8, block_id_flag=BLOCK_ID_FLAG_ABSENT,
                                                signature=b"", timestamp=JTimestamp.zero()),
        "absent_with_time": lambda: with_sig(9, block_id_flag=BLOCK_ID_FLAG_ABSENT,
                                             validator_address=b"", signature=b""),
        "absent_with_signature": lambda: with_sig(10, block_id_flag=BLOCK_ID_FLAG_ABSENT,
                                                  validator_address=b"",
                                                  timestamp=JTimestamp.zero()),
    }
    return cases[name]()


SH_CASES = [
    "valid", "valid_with_absent", "other_chain", "height_mismatch", "hash_mismatch",
    "chain_id_too_long", "zero_height", "negative_height", "wrong_data_hash_size",
    "wrong_proposer_size", "wrong_last_block_id", "commit_negative_round", "commit_nil_block",
    "commit_no_signatures", "sig_too_big", "sig_missing", "address_size", "unknown_flag",
    "absent_with_address", "absent_with_time", "absent_with_signature",
]


@pytest.mark.parametrize("name", SH_CASES)
def test_signed_header_validate_basic_matches_the_reference(chain, name):
    jsh = _sh_case(chain, name)
    psh = pblock.SignedHeader(pblock.Header.decode(jsh.header.encode()),
                              pblock.Commit.decode(jsh.commit.encode()))
    columnar = psh.commit.commit_block() is not None
    # canonical records decode to columns; the non-canonical ones to objects
    assert columnar == (name.startswith(("valid", "other", "height", "hash", "chain", "zero",
                                         "negative", "wrong", "commit_negative",
                                         "commit_nil")))
    want = _outcome(lambda: jsh.validate_basic(CHAIN_ID))
    assert _outcome(lambda: psh.validate_basic(CHAIN_ID)) == want
    assert (want is None) == name.startswith("valid")
    # the same commit built from objects takes the loop and agrees
    obj = pblock.Commit(psh.commit.height, psh.commit.round, psh.commit.block_id,
                        list(psh.commit.signatures))
    assert _outcome(lambda: pblock.SignedHeader(psh.header, obj).validate_basic(CHAIN_ID)) == want


def test_signed_header_missing_parts_match_the_reference(chain):
    lb = chain["blocks"][1]
    phdr = pblock.Header.decode(lb.signed_header.header.encode())
    pcommit = pblock.Commit.decode(lb.signed_header.commit.encode())
    for jsh, psh in ((JSignedHeader(None, lb.signed_header.commit), pblock.SignedHeader(None, pcommit)),
                     (JSignedHeader(lb.signed_header.header, None), pblock.SignedHeader(phdr, None))):
        want = _outcome(lambda: jsh.validate_basic(CHAIN_ID))
        assert want is not None
        assert _outcome(lambda: psh.validate_basic(CHAIN_ID)) == want


def test_columnar_commit_validate_basic_builds_no_commit_sig(chain, monkeypatch):
    """A commit decoded from its wire bytes answers from its columns."""
    commit = pblock.Commit.decode(chain["blocks"][1].signed_header.commit.encode())
    assert commit.commit_block() is not None

    def _raise(self):
        raise AssertionError("CommitSig.validate_basic called")

    monkeypatch.setattr(pblock.CommitSig, "validate_basic", _raise)
    commit.validate_basic()
    assert all(x is None for x in commit.signatures._items)


# -- the verifier -------------------------------------------------------------


def _b(chain, h):
    return chain["blocks"][h] if isinstance(h, int) else chain["extra"][h]


def _verifier_case(chain, name: str):
    """case(verifier module, converter, now, kwargs) for one branch."""
    b = lambda h: _b(chain, h)  # noqa: E731

    def adjacent(t, u, vals=None, period=PERIOD, drift=DRIFT, now_shift=0):
        def case(m, cv, now, kw):
            now = type(now)(now.seconds + now_shift, now.nanos)
            uv = cv(b(u) if vals is None else b(vals)).validators
            m.verify_adjacent(cv(b(t)).signed_header, cv(b(u)).signed_header, uv,
                              period, now, drift, **kw)
        return case

    def non_adjacent(t, u, lvl=(1, 3), vals=None, fn="verify_non_adjacent", now_shift=0):
        def case(m, cv, now, kw):
            from tendermint_tpu.types.validation import Fraction as JFraction

            frac = (JFraction if m is jverifier else pvalidation.Fraction)(*lvl)
            now = type(now)(now.seconds + now_shift, now.nanos)
            uv = cv(b(u) if vals is None else b(vals)).validators
            getattr(m, fn)(cv(b(t)).signed_header, cv(b(t)).validators,
                           cv(b(u)).signed_header, uv, PERIOD, now, DRIFT, frac, **kw)
        return case

    def backwards(u, t, **fields):
        def case(m, cv, now, kw):
            ush = cv(b(u)).signed_header
            if fields:
                ts = type(ush.header.time)
                f = {k: ts(*v) if k == "time" else v for k, v in fields.items()}
                ush = type(ush)(dataclasses.replace(ush.header, **f), ush.commit)
            m.verify_backwards(ush, cv(b(t)).signed_header)
        return case

    cases = {
        "adjacent_ok": adjacent(1, 2),
        "adjacent_not_adjacent": adjacent(1, 3),
        "adjacent_expired": adjacent(1, 2, period=100.0),
        "adjacent_clock_drift": adjacent(1, 2, now_shift=-1000 + 20 - 30),
        "adjacent_validators_hash_mismatch": adjacent(1, 2, vals=10),
        "adjacent_next_validators_mismatch": adjacent(1, "2_v2"),
        "non_adjacent_ok": non_adjacent(1, 10),
        "non_adjacent_full_trust_level": non_adjacent(3, 17, lvl=(1, 1)),
        "non_adjacent_not_enough_trust": non_adjacent(1, 17),
        "non_adjacent_is_adjacent": non_adjacent(1, 2),
        "non_adjacent_trust_level_low": non_adjacent(1, 10, lvl=(1, 4)),
        "non_adjacent_trust_level_high": non_adjacent(1, 10, lvl=(4, 3)),
        "non_adjacent_trust_level_zero": non_adjacent(1, 10, lvl=(1, 0)),
        "non_adjacent_expired": non_adjacent(1, 10, now_shift=int(PERIOD)),
        "non_adjacent_older_height": non_adjacent(10, 3),
        "non_adjacent_validators_hash_mismatch": non_adjacent(1, 10, vals=17),
        "verify_adjacent_branch": non_adjacent(2, 3, fn="verify"),
        "verify_non_adjacent_branch": non_adjacent(3, 10, fn="verify"),
        "verify_not_enough_trust": non_adjacent(1, 17, fn="verify"),
        "backwards_ok": backwards(2, 3),
        "backwards_other_chain": backwards(2, 3, chain_id="other"),
        "backwards_time": backwards(2, 3, time=(T0 + 40, 0)),
        "backwards_hash": backwards(1, 3),
    }
    return cases[name]


VERIFIER_CASES = [
    "adjacent_ok", "adjacent_not_adjacent", "adjacent_expired", "adjacent_clock_drift",
    "adjacent_validators_hash_mismatch", "adjacent_next_validators_mismatch",
    "non_adjacent_ok", "non_adjacent_full_trust_level", "non_adjacent_not_enough_trust",
    "non_adjacent_is_adjacent", "non_adjacent_trust_level_low", "non_adjacent_trust_level_high",
    "non_adjacent_trust_level_zero", "non_adjacent_expired", "non_adjacent_older_height",
    "non_adjacent_validators_hash_mismatch", "verify_adjacent_branch",
    "verify_non_adjacent_branch", "verify_not_enough_trust", "backwards_ok",
    "backwards_other_chain", "backwards_time", "backwards_hash",
]


@pytest.mark.parametrize("name", VERIFIER_CASES)
def test_verifier_matches_the_reference(chain, name):
    want, got = _both(_verifier_case(chain, name))
    assert got == want
    assert (want is None) == name.endswith(("_ok", "_branch")), want


@pytest.mark.parametrize("where", ["inside", "past"])
def test_verify_adjacent_tampered_signature(chain, where):
    """The +2/3 check stops early: a bad signature inside the selected
    prefix is an ErrInvalidHeader with its blame; one past it is
    accepted, as the reference accepts it."""
    lb = chain["blocks"][2]
    vset, commit = lb.validators, lb.signed_header.commit
    stop = _early_stop(commit, vset, 2, 3)
    assert stop < N
    idx = 0 if where == "inside" else N - 1
    bad = JLightBlock(JSignedHeader(lb.signed_header.header, _tampered_commit(commit, idx)), vset)
    want, got = _both(lambda m, cv, now, kw: m.verify_adjacent(
        cv(_b(chain, 1)).signed_header, cv(bad).signed_header, cv(bad).validators,
        PERIOD, now, DRIFT, **kw))
    assert got == want
    if where == "inside":
        assert want[0] == "ErrInvalidHeader" and want[1].startswith("wrong signature (#0): ")
    else:
        assert want is None


def test_verify_non_adjacent_double_vote(chain):
    lb = chain["blocks"][10]
    c = lb.signed_header.commit
    v1 = chain["v1"][0]
    # the first V1 member of V2's commit signs twice
    i = next(k for k, cs in enumerate(c.signatures) if v1.get_by_address(cs.validator_address)[1])
    sigs = list(c.signatures)
    sigs[i + 1] = sigs[i]
    dbl = JLightBlock(JSignedHeader(lb.signed_header.header,
                                    JCommit(c.height, c.round, c.block_id, sigs)), lb.validators)
    want, got = _both(lambda m, cv, now, kw: m.verify_non_adjacent(
        cv(_b(chain, 1)).signed_header, cv(_b(chain, 1)).validators, cv(dbl).signed_header,
        cv(dbl).validators, PERIOD, now, DRIFT,
        (jvalidation.Fraction if m is jverifier else pvalidation.Fraction)(1, 3), **kw))
    assert got == want
    assert want[0] == "ErrInvalidHeader" and want[1].startswith("double vote from Validator(")


def test_light_entry_points_default_to_cuda(chain):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    lb1, lb2 = _port(_b(chain, 1)), _port(_b(chain, 2))
    now = PTimestamp(*NOW)
    calls = [
        lambda: pverifier.verify_adjacent(lb1.signed_header, lb2.signed_header,
                                          lb2.validators, PERIOD, now, DRIFT),
        lambda: pverifier.verify_non_adjacent(lb1.signed_header, lb1.validators,
                                              lb2.signed_header, lb2.validators, PERIOD, now,
                                              DRIFT, pvalidation.DEFAULT_TRUST_LEVEL),
        lambda: pverifier.verify(lb1.signed_header, lb1.validators, lb2.signed_header,
                                 lb2.validators, PERIOD, now, DRIFT,
                                 pvalidation.DEFAULT_TRUST_LEVEL),
        lambda: pvalidation.verify_commit_light_trusting(
            CHAIN_ID, lb1.validators, lb2.signed_header.commit, pvalidation.DEFAULT_TRUST_LEVEL),
        lambda: pclient.Client(CHAIN_ID, pclient.TrustOptions(PERIOD, 1, lb1.hash()),
                               _PProv("p", {1: lb1}), [], pstore.LightStore(pdb.MemDB())),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -- store ---------------------------------------------------------------------


def test_light_store_records_match_the_reference(chain):
    jdb, pdb_ = JMemDB(), pdb.MemDB()
    js, ps = JLightStore(jdb), pstore.LightStore(pdb_)
    for h in (3, 1, 10, 2):
        js.save_light_block(_b(chain, h))
        ps.save_light_block(_port(_b(chain, h)))
    assert list(pdb_.iterator()) == list(jdb.iterator())
    for q in ("first_light_block_height", "last_light_block_height"):
        assert getattr(ps, q)() == getattr(js, q)()
    assert ps.light_block(10).hash() == js.light_block(10).hash()
    assert ps.light_block(4) is None and js.light_block(4) is None
    assert ps.light_block_before(10).height == js.light_block_before(10).height == 3
    assert ps.latest_light_block().hash() == js.latest_light_block().hash()
    assert ps.prune(2) == js.prune(2) == 2
    assert list(pdb_.reverse_iterator()) == list(jdb.reverse_iterator())


# -- evidence ------------------------------------------------------------------


@pytest.mark.parametrize("form", ["17_lunatic", "17_equivocation", "17_amnesia"])
def test_attack_evidence_matches_the_reference(chain, form):
    conflicted, trusted, common = _b(chain, form), _b(chain, 17), _b(chain, 10)
    jev = jmake_evidence(conflicted, trusted, common)
    pev = pclient.make_attack_evidence(_port(conflicted), _port(trusted), _port(common))
    assert pev.encode() == jev.encode()
    assert pev.hash() == jev.hash()
    assert pev.common_height == jev.common_height == (10 if form == "17_lunatic" else 17)
    assert bool(jev.byzantine_validators) == (form != "17_amnesia")
    back = pevidence.LightClientAttackEvidence.decode(jev.encode())
    assert back.encode() == jev.encode()
    assert back.conflicting_block.header().hash() == conflicted.hash()
    assert _outcome(back.validate_basic) == _outcome(JEvidence.decode(jev.encode()).validate_basic)
    back.common_height = 0
    jback = JEvidence.decode(jev.encode())
    jback.common_height = 0
    want = _outcome(jback.validate_basic)
    assert want is not None and _outcome(back.validate_basic) == want


# -- the client ------------------------------------------------------------------


class _JProv(JProvider):
    def __init__(self, name, blocks):
        self.name, self.blocks, self.evidence, self.asked = name, blocks, [], []

    def light_block(self, height):
        self.asked.append(height)
        if height == 0:
            height = max(self.blocks)
        if height not in self.blocks:
            raise JNotFound(height)
        return self.blocks[height]

    def report_evidence(self, ev):
        self.evidence.append(ev.encode())


class _PProv(pprovider.Provider):
    def __init__(self, name, blocks):
        self.name, self.blocks, self.evidence, self.asked = name, blocks, [], []

    def light_block(self, height):
        self.asked.append(height)
        if height == 0:
            height = max(self.blocks)
        if height not in self.blocks:
            raise pprovider.ErrLightBlockNotFound(height)
        return self.blocks[height]

    def report_evidence(self, ev):
        self.evidence.append(ev.encode())


def _client_run(chain, side: str, root: int, providers: dict, witnesses: list, ops: list,
                sequential: bool = False):
    """Build one side's client from `providers` (name -> {height: block
    key}), run `ops`, and return (outcomes, stored heights and hashes,
    primary name, each provider's evidence and the heights it was asked
    for)."""
    if side == "jax":
        prov_cls, conv, store = _JProv, _ident, JLightStore(JMemDB())
        client_cls, opts_cls, kw = JClient, JTrustOptions, {}
        now = JTimestamp(*NOW)
    else:
        prov_cls, conv, store = _PProv, _port, pstore.LightStore(pdb.MemDB())
        client_cls, opts_cls, kw = pclient.Client, pclient.TrustOptions, {"device": "cpu"}
        now = PTimestamp(*NOW)
    provs = {name: prov_cls(name, {h: conv(_b(chain, k)) for h, k in blocks.items()})
             for name, blocks in providers.items()}
    outcomes = []
    client = None

    def build():
        nonlocal client
        client = client_cls(CHAIN_ID, opts_cls(PERIOD, root, _b(chain, root).hash()),
                            provs["primary"], [provs[w] for w in witnesses], store,
                            sequential=sequential, now_fn=lambda: now, **kw)

    outcomes.append(_outcome(build))
    if client is not None:
        for op, arg in ops:
            res = []

            def run():
                if op == "height":
                    res.append(client.verify_light_block_at_height(arg, now).hash())
                elif op == "header":
                    client.verify_header(conv(_b(chain, arg)).signed_header.header, now)
                elif op == "update":
                    lb = client.update(now)
                    res.append(None if lb is None else lb.hash())

            outcomes.append((_outcome(run), res))
    stored = [(h, lb.hash()) for h in range(1, 18)
              for lb in [store.light_block(h)] if lb is not None]
    primary = client.primary().name if client is not None else None
    return outcomes, stored, primary, {n: (p.evidence, p.asked) for n, p in provs.items()}


FULL = {h: h for h in (1, 2, 3, 10, 17)}

CLIENT_CASES = {
    "sequential": dict(root=1, providers={"primary": FULL, "w": FULL}, witnesses=["w"],
                       ops=[("height", 3)], sequential=True),
    "sequential_invalid_next_validators": dict(
        root=1, providers={"primary": {**FULL, 2: "2_v2"}, "w": FULL},
        witnesses=["w"], ops=[("height", 2)], sequential=True),
    "skipping_bisects": dict(root=1, providers={"primary": FULL, "w": FULL},
                             witnesses=["w"], ops=[("height", 17), ("height", 10)]),
    "skipping_then_update": dict(root=1, providers={"primary": FULL, "w": FULL},
                                 witnesses=["w"], ops=[("height", 10), ("update", None),
                                                       ("update", None)]),
    "backwards": dict(root=3, providers={"primary": FULL, "w": FULL}, witnesses=["w"],
                      ops=[("height", 1)]),
    "verify_header": dict(root=1, providers={"primary": FULL, "w": FULL}, witnesses=["w"],
                          ops=[("header", 17), ("header", 17), ("header", "17_lunatic")]),
    "no_witnesses": dict(root=1, providers={"primary": FULL}, witnesses=[], ops=[]),
    "root_conflict": dict(root=1, providers={"primary": FULL, "w": {**FULL, 1: 2}},
                          witnesses=["w"], ops=[]),
    "conflicting_witness": dict(
        root=1, providers={"primary": FULL, "w": {**FULL, 17: "17_lunatic"}},
        witnesses=["w"], ops=[("height", 17)]),
    "primary_lacks_block": dict(
        root=1, providers={"primary": {1: 1, 2: 2, 3: 3}, "w1": FULL, "w2": FULL},
        witnesses=["w1", "w2"], ops=[("height", 17)]),
    "witness_lacks_block": dict(root=1, providers={"primary": FULL, "w": {1: 1}},
                                witnesses=["w"], ops=[("height", 10)]),
}


@pytest.mark.parametrize("name", list(CLIENT_CASES))
def test_client_matches_the_reference(chain, name):
    spec = CLIENT_CASES[name]
    want = _client_run(chain, "jax", **spec)
    got = _client_run(chain, "port", **spec)
    assert got == want
    outcomes, stored, primary, provs = want
    if name == "skipping_bisects":
        # V1 cannot trust V3: the client bisects to 10, then reaches 17;
        # only the target is stored, and 10 lies below it with no
        # headers in between to walk back through
        assert provs["primary"][1] == [1, 17, 10, 16]
        assert [h for h, _ in stored] == [1, 17]
        assert outcomes[1] == (None, [_b(chain, 17).hash()])
        assert outcomes[2][0][0] == "ErrLightBlockNotFound"
    if name == "sequential":
        assert [h for h, _ in stored] == [1, 2, 3]
    if name == "backwards":
        assert [h for h, _ in stored] == [1, 2, 3]
    if name == "no_witnesses":
        assert outcomes[0][0] == "ErrNoWitnesses"
    if name == "conflicting_witness":
        assert outcomes[1][0][0] == "ErrLightClientAttack"
        assert provs["w"][0] and provs["primary"][0]
    if name == "primary_lacks_block":
        assert primary == "w1" and outcomes[1][0] is None
