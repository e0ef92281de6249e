"""The port's sr25519 path (tendermint_tpu_torch/ops/sr25519.py,
ops/mixed.py and the sr25519 branch of types/validation.py) on the CPU
against the JAX package's (tendermint_tpu/ops/pallas_sr25519.py,
ops/mixed.py, types/validation.py).

- K1r: the plain version equals the JAX _k1r_decode_kernel body run
  eagerly (tests/pallas_bodies.py) limb for limb, at 16 signatures over
  a ristretto edge battery (the identity, an odd encoding, encodings at
  and past p, 1 + s^2 = 0, a non-square, an odd t) and random valid keys;
  its flags equal the oracle's decode.
- prepare_sr25519: byte-equal to the JAX one (marker bit, s >= L, odd and
  non-canonical keys, the all-zero padding).
- K3r and the batch path: verdicts equal the JAX package's oracle
  (crypto.sr25519.verify), padding verifies; no ladder body runs eagerly.
- verify_commit and verify_commit_light on sr25519 sets carried over as
  protobuf: valid, one tampered signature (the blame string), below 2/3,
  a mixed set either way; the same outcome as the JAX package's. The
  device batches run at a 16-signature block (verify.BLOCK), which sizes
  the padding and not the verdicts.

Tolerance: none; every compared value is an integer or a flag.
"""

import dataclasses
import hashlib
import os

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pallas_bodies import run_body  # noqa: E402
from test_torch_commit import CHAIN_ID, HEIGHT, _outcome  # noqa: E402
from tendermint_tpu.crypto import _ristretto as jristretto  # noqa: E402
from tendermint_tpu.crypto import batch as jbatch  # noqa: E402
from tendermint_tpu.crypto import ed25519 as jed  # noqa: E402
from tendermint_tpu.crypto import sr25519 as jsr  # noqa: E402
from tendermint_tpu.ops import pallas_sr25519 as ps  # noqa: E402
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
from tendermint_tpu_torch.crypto import batch  # noqa: E402
from tendermint_tpu_torch.crypto import ed25519 as ped  # noqa: E402
from tendermint_tpu_torch.crypto import sr25519 as psr  # noqa: E402
from tendermint_tpu_torch.ops import epoch_cache, mixed, verify  # noqa: E402
from tendermint_tpu_torch.ops import sr25519 as osr  # noqa: E402
from tendermint_tpu_torch.ops.entry_block import EntryBlock  # noqa: E402
from tendermint_tpu_torch.types import validation  # noqa: E402
from tendermint_tpu_torch.types.block import BlockID  # noqa: E402

# The plain versions run thousands of small tensor ops: one intra-op
# thread keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = jristretto.P


def _enc(v: int) -> bytes:
    return v.to_bytes(32, "little")


# ristretto encodings over every decode branch: the identity; an odd
# encoding; p + 1 (even, not canonical); bit 255 set; the even square
# root of -1 (1 + s^2 = 0: y = 0); s = 8 (v u2^2 not square); s = 2 (t
# odd); s = 4 (decodes); p - 1 (even, canonical)
_SQRT_M1_EVEN = jristretto.SQRT_M1 if jristretto.SQRT_M1 % 2 == 0 else P - jristretto.SQRT_M1
EDGE_ENCODINGS = [_enc(0), _enc(1), _enc(P + 1), _enc(2**255 + 2), _enc(_SQRT_M1_EVEN),
                  _enc(8), _enc(2), _enc(4), _enc(P - 1)]


def _sr_keys(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [jsr.gen_priv_key(rng.bytes(32)) for _ in range(n)]


def _signed(n: int, seed: int) -> list:
    out = []
    for i, sk in enumerate(_sr_keys(n, seed)):
        msg = b"sr-%d-%d" % (seed, i)
        out.append((sk.pub_key().bytes(), msg, sk.sign(msg)))
    return out


def _sig_edges(signed: list) -> list:
    """Signed entries made wrong one way each: a tampered s, a wrong
    message, no v1 marker, s >= L with the marker, an odd key, a key past
    p, an R that does not decode; and a valid signature under the
    identity key (R = [s]B verifies for any message)."""
    (pk, msg, sig) = signed[0]
    s = 4242
    r = jristretto.encode(jristretto.scalar_mult(s, jristretto.BASE))
    return [
        (pk, msg, sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:]),
        (pk, msg + b"!", sig),
        (pk, msg, sig[:63] + bytes([sig[63] & 0x7F])),
        (pk, msg, sig[:32] + (jsr.L + 3 | 1 << 255).to_bytes(32, "little")),
        (_enc(1), msg, sig),
        (_enc(P + 1), msg, sig),
        (pk, msg, _enc(8) + sig[32:]),
        (_enc(0), b"identity key", r + (s | 1 << 255).to_bytes(32, "little")),
    ]


@pytest.fixture(scope="module")
def entries():
    signed = _signed(6, 1)
    return signed + _sig_edges(signed)


def _tensors(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def test_k1r_decode_matches_jax_body_and_the_oracle():
    """16 signatures: A runs over the edge battery and valid keys, R over
    the same in another order; s and k are random 253-bit scalars."""
    rng = np.random.default_rng(7)
    valid = [sk.pub_key().bytes() for sk in _sr_keys(7, 2)]
    a = EDGE_ENCODINGS + valid
    r = valid[::-1] + EDGE_ENCODINGS[::-1]
    rows = lambda encs: np.frombuffer(b"".join(encs), np.uint8).reshape(-1, 32)  # noqa: E731
    a_rows, r_rows = rows(a), rows(r)
    scal = rng.integers(0, 256, (2, 16, 32), dtype=np.uint8)
    scal[:, :, 31] &= 0x1F
    args = [np.ascontiguousarray(x.T) for x in (a_rows, r_rows, scal[0], scal[1])]
    args += [ps._canonical_even(x, 16, 16).astype(np.int32)[None, :] for x in (a_rows, r_rows)]
    want = run_body(ps._k1r_decode_kernel, args,
                    [osr.COORD_ROWS, 2, osr.DIG_ROWS, osr.DIG_ROWS])
    got = osr.k1r_decode(*_tensors(args))
    for name, g, w in zip(("coords", "ok", "sdig", "kdig"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    oracle = [[jristretto.decode(e) is not None for e in encs] for encs in (a, r)]
    assert want[1].astype(bool).tolist() == oracle
    assert oracle[0][:8] == [True] + [False] * 6 + [True]


@pytest.mark.parametrize("n, bucket", [(14, 16), (14, 512), (0, 16)])
def test_prepare_sr25519_byte_equal_to_jax(entries, n, bucket):
    ents = entries[:n]
    want = ps.prepare_sr25519(ents, bucket)
    got = osr.prepare_sr25519(EntryBlock.from_entries(ents), bucket)
    assert len(got) == len(want) == 7
    for j, p in zip(want, got):
        assert j.dtype == p.dtype and j.shape == p.shape
        np.testing.assert_array_equal(j, p)
    assert not got[0][:, n:].any() and got[4][0, n:].all()  # all-zero padding, flags 1


def test_k3r_verdicts_match_the_oracle_with_padding(entries):
    n = len(entries)
    args = _tensors(osr.prepare_sr25519(EntryBlock.from_entries(entries), n + 2))
    coords, ok, sdig, kdig = osr.k1r_decode(*args[:6])
    out = osr.k3r_ladder(verify.k2_table(coords), sdig, kdig, coords, ok, args[6])
    oracle = [jsr.verify(*e) for e in entries]
    assert out.numpy()[0].astype(bool).tolist() == oracle + [True, True]
    assert oracle == [True] * 6 + [False] * 7 + [True]


def test_the_verifier_checks_keys_and_takes_the_device_from_the_threshold(entries,
                                                                         monkeypatch):
    monkeypatch.setattr(verify, "BLOCK", 16)
    calls = []
    real = osr.verify_batch_sr25519
    monkeypatch.setattr(osr, "verify_batch_sr25519",
                        lambda b, device: calls.append(len(b)) or real(b, device=device))
    bv = batch.create_batch_verifier(psr.PubKey(entries[0][0]), device="cpu")
    assert isinstance(bv, mixed.Sr25519DeviceBatchVerifier) and bv.verify() == (False, [])
    with pytest.raises(TypeError, match="pubkey is not sr25519"):
        bv.add(ped.PubKey(bytes(32)), b"m", bytes(64))
    with pytest.raises(ValueError, match="invalid signature length"):
        bv.add(psr.PubKey(bytes(32)), b"m", bytes(63))
    with pytest.raises(TypeError, match="pubkey is not sr25519"):
        bv.add_block(EntryBlock.from_entries(entries[:1]), keys=[ped.PubKey(bytes(32))])
    oracle = [jsr.verify(*e) for e in entries]
    for n in (mixed.SR_DEVICE_THRESHOLD - 1, mixed.SR_DEVICE_THRESHOLD + 6):
        bv = batch.create_batch_verifier(psr.PubKey(entries[0][0]), device="cpu")
        for pk, msg, sig in entries[:3]:
            bv.add(psr.PubKey(pk), msg, sig)
        bv.add_block(EntryBlock.from_entries(entries[3:n]))
        assert bv.verify() == (all(oracle[:n]), oracle[:n])
    assert calls == [mixed.SR_DEVICE_THRESHOLD + 6]
    assert batch.supports_batch_verifier(psr.PubKey(entries[0][0]))


# -- verify_commit on sr25519 sets -------------------------------------------------


def _make(kinds: str, seed: int):
    """(JValidatorSet, JBlockID, signed JCommit): validator i has an
    sr25519 key where kinds[i] == "s", else ed25519; validator 0 has
    power 11 and the rest 10, so validator 0 is the proposer."""
    rng = np.random.default_rng(seed)
    sks = [(jsr if k == "s" else jed).gen_priv_key(rng.bytes(32)) for k in kinds]
    vset = JValidatorSet.new([JValidator.new(sk.pub_key(), 11 if i == 0 else 10)
                              for i, sk in enumerate(sks)])
    assert vset.get_proposer().pub_key == sks[0].pub_key()
    by_addr = {sk.pub_key().address(): sk for sk in sks}
    h = hashlib.sha256(b"sr block %d" % seed).digest()
    bid = JBlockID(hash=h, part_set_header=JPartSetHeader(total=2, hash=h[::-1]))
    sigs = [JCommitSig(BLOCK_ID_FLAG_COMMIT, v.address, JTimestamp(1_700_000_000 + i, i), b"")
            for i, v in enumerate(vset.validators)]
    commit = JCommit(height=HEIGHT, round=0, block_id=bid, signatures=sigs)
    commit.signatures = [
        dataclasses.replace(cs, signature=by_addr[vset.validators[i].address].sign(
            commit.vote_sign_bytes(CHAIN_ID, i)))
        for i, cs in enumerate(sigs)
    ]
    return vset, bid, commit


@pytest.fixture(scope="module")
def sets():
    return {"sr": _make("s" * 12, 31), "sr_with_ed": _make("s" * 11 + "e", 32),
            "ed_with_sr": _make("e" * 11 + "s", 33)}


def _case(case: str, sets):
    if case in ("sr_with_ed", "ed_with_sr"):
        return sets[case]
    vset, bid, commit = sets["sr"]
    sigs = list(commit.signatures)
    if case == "tampered":
        bad = bytearray(sigs[5].signature)
        bad[40] ^= 0x10
        sigs[5] = dataclasses.replace(sigs[5], signature=bytes(bad))
    elif case == "low_power":
        sigs = [JCommitSig.absent() if i % 3 else cs for i, cs in enumerate(sigs)]
    return vset, bid, JCommit(commit.height, commit.round, commit.block_id, sigs)


@pytest.mark.parametrize("mode, case", [
    ("verify_commit", "valid"), ("verify_commit", "tampered"),
    ("verify_commit", "low_power"), ("verify_commit", "sr_with_ed"),
    ("verify_commit", "ed_with_sr"), ("verify_commit_light", "valid"),
])
def test_commit_matches_jax(mode, case, sets, monkeypatch):
    """The JAX side verifies sr25519 on its host lane (TM_TPU_SR_DEVICE=0)
    and ed25519 on its host verifier; the port on device="cpu", where the
    sr25519 batches take K1r, K2, K3r. An sr25519 set is never noted in
    the epoch cache."""
    monkeypatch.setattr(jbatch, "_device_verifier_factory", None)
    monkeypatch.setenv("TM_TPU_SR_DEVICE", "0")
    monkeypatch.setattr(verify, "BLOCK", 16)
    epoch_cache.reset(depth=8)
    calls = []
    real = osr.verify_batch_sr25519
    monkeypatch.setattr(osr, "verify_batch_sr25519",
                        lambda b, device: calls.append(len(b)) or real(b, device=device))
    vset, bid, commit = _case(case, sets)
    want = _outcome(lambda: getattr(jvalidation, mode)(CHAIN_ID, vset, bid, HEIGHT, commit))
    pvals, pcommit = convert.state_from_wire(vset.encode(), commit.encode())
    assert pvals.hash() == vset.hash() and pvals.encode() == vset.encode()
    pbid = BlockID.decode(bid.encode())
    got = _outcome(lambda: getattr(validation, mode)(CHAIN_ID, pvals, pbid, HEIGHT, pcommit,
                                                     device="cpu"))
    assert got == want
    expect = {"valid": None, "tampered": "wrong signature (#5): ",
              "low_power": "invalid commit -- insufficient voting power",
              "sr_with_ed": "pubkey is not sr25519", "ed_with_sr": "pubkey is not ed25519"}[case]
    assert got is None if expect is None else got[1].startswith(expect)
    assert calls == ({"valid": [12 if mode == "verify_commit" else 8], "tampered": [12]}
                     .get(case, []))
    assert (epoch_cache.stats()["misses"], epoch_cache.stats()["hits"]) == (0, 0)
    epoch_cache.reset()
