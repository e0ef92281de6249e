"""Commit verification — the hot path of this slice.

Counterpart: tendermint_tpu/types/validation.py (types/validation.go).
verify_commit, verify_commit_light and verify_commit_light_trusting take
the batch path through crypto.batch, where the port's device verifier
for the proposer's key type (ed25519: RLC lanes or per-signature;
sr25519: ops/sr25519.py) verifies the commit's signatures on `device`;
commits below the batch threshold verify one signature at a time on the
host. The first two look each signature's validator up by its index in
the commit; the trusting check, which the light client runs against a
set that need not be the commit's, looks it up by address, skips
unknown addresses and rejects a validator that signed twice. An ed25519
batch carries its validator rows (the rows in the set verified against)
and, once the set has been seen before, the set's epoch key
(ops/epoch_cache.py), so a warm set's keys come from the device table
instead of being decompressed again. Error cases, the tally and the
blame of the first bad signature are byte-identical to the reference's.
A columnar commit (one decoded from its wire bytes, or built of
canonical CommitSig objects) of an all-ed25519 set looked up by index
takes the fused prep (ops/commit_prep.py: selection, tally, sign bytes
and the key gather in one call of the host library, and on the op-graph
path with the challenges hashed on the card, TM_TPU_PALLAS=0, each
row's R || A || M laid into SHA-512 blocks); any other commit,
set or lookup takes the object path, which selects over CommitSig
objects. The batch path's host stages are torch.profiler
record_function spans ("commit.prep" on the fused path, "commit.select"
and "commit.sign_bytes" on the object path; "rlc.*", "verify.*" and
"sr.*" in ops/), so one profiler trace of a call shows its host stages
beside its device time.

The batch path runs prepare (_prepare_block: selection, tally, the
batch), verify, conclude (the blame), so selection, tally and blame live
in one place for both callers of that split: _verify_commit_batch, and
the asynchronous seam (prepare_commit_batch, prepare_commit_light,
prepare_commit_range, prepare_commit_light_trusting; reference
validation.py:183-370; prepare_commit_scheme_split, :387-440, for a
committee of ed25519 and secp256k1 keys), which returns the batch and its conclude
instead of verifying, for a caller that ships the batch through the
dispatcher (ops/pipeline.py) itself: the light verifier's
SigCheck.prepare and the batched light service. The seam also batches
an all-secp256k1 set (_should_batch_prepare, reference :73-89), which
crypto.batch cannot: its block is of scheme secp256k1, with the set's
rows and epoch key, for ops/secp_verify.py's kernels; the synchronous
verify_commit* keep the reference's routing and verify such a set one
signature at a time on the host.

Aggregated BLS12-381 commits (types/block.AggregatedCommit, reference
:479-620): verify_aggregated_commit is the sequential walk on the host
(crypto/bls12381); prepare_aggregated_commit is its seam half, whose
one-row AggBlock goes through the dispatcher (ops/pipeline.py fuses the
AggBlocks of one committee into one launch) and whose conclude(codes)
turns the lane's int32 verdict code into the walk's blame strings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
from torch.profiler import record_function

from ..crypto import batch as _batch
from ..crypto import tmhash
from ..device import resolve_device
from ..ops import commit_prep, epoch_cache
from ..ops.entry_block import EntryBlock
from .block import BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig
from .validator_set import ErrNotEnoughVotingPowerSigned, ValidatorSet, safe_mul

BATCH_VERIFY_THRESHOLD = 2  # validation.go:12


@dataclass(frozen=True)
class Fraction:
    """libs/math.Fraction, the light client's trust level."""

    numerator: int
    denominator: int

    def validate(self) -> None:
        if self.denominator == 0:
            raise ValueError("fraction has zero denominator")


DEFAULT_TRUST_LEVEL = Fraction(1, 3)


class ErrInvalidCommitHeight(ValueError):
    def __init__(self, expected: int, actual: int):
        super().__init__(f"invalid commit height: expected {expected}, got {actual}")


class ErrInvalidCommitSignatures(ValueError):
    def __init__(self, expected: int, actual: int):
        super().__init__(
            f"invalid commit -- wrong set size: {expected} vs {actual}"
        )


def _should_batch_verify(vals: ValidatorSet, commit: Commit) -> bool:
    proposer = vals.get_proposer()
    return len(commit.signatures) >= BATCH_VERIFY_THRESHOLD and _batch.supports_batch_verifier(
        proposer.pub_key if proposer else None
    )


def _should_batch_prepare(vals: ValidatorSet, commit: Commit) -> bool:
    """The prepare seam's batch gate (reference :73-89): the reference's
    per-key gate, or an all-secp256k1 set, which the device's secp256k1
    lane batches though crypto.batch has no secp256k1 verifier
    (batch.go:26-33); its verdicts and blame are the single path's."""
    if _should_batch_verify(vals, commit):
        return True
    return (len(commit.signatures) >= BATCH_VERIFY_THRESHOLD
            and vals.secp256k1_columns() is not None)


def _ignore_absent(c: CommitSig) -> bool:
    return c.is_absent()


def _ignore_not_for_block(c: CommitSig) -> bool:
    return not c.for_block()


def _count_for_block(c: CommitSig) -> bool:
    return c.for_block()


def _count_all(c: CommitSig) -> bool:
    return True


def verify_commit(
    chain_id: str, vals: ValidatorSet, block_id: BlockID, height: int,
    commit: Commit, *, device=None,
) -> None:
    """validation.go:25-52: +2/3 signed, ALL signatures checked."""
    device = resolve_device(device)
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    _verify(chain_id, vals, commit, vals.total_voting_power() * 2 // 3,
            _ignore_absent, _count_for_block, True, True, device)


def verify_commit_light(
    chain_id: str, vals: ValidatorSet, block_id: BlockID, height: int,
    commit: Commit, *, device=None,
) -> None:
    """validation.go:59-86: +2/3 signed; stops at the first 2/3."""
    device = resolve_device(device)
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    _verify(chain_id, vals, commit, vals.total_voting_power() * 2 // 3,
            _ignore_not_for_block, _count_all, False, True, device)


def verify_commit_light_trusting(
    chain_id: str, vals: ValidatorSet, commit: Commit, trust_level: Fraction,
    *, device=None,
) -> None:
    """validation.go:94-135: more than trust_level of vals' power signed
    the commit; vals need not be the commit's set, so each signature's
    validator is looked up by address. Stops at the threshold."""
    device = resolve_device(device)
    if vals is None:
        raise ValueError("nil validator set")
    if trust_level.denominator == 0:
        raise ValueError("trustLevel has zero Denominator")
    if commit is None:
        raise ValueError("nil commit")
    total_mul, overflow = safe_mul(vals.total_voting_power(), trust_level.numerator)
    if overflow:
        raise OverflowError(
            "int64 overflow while calculating voting power needed; "
            "please provide smaller trustLevel numerator"
        )
    _verify(chain_id, vals, commit, total_mul // trust_level.denominator,
            _ignore_not_for_block, _count_all, False, False, device)


def validate_hash(h: bytes) -> None:
    """validation.go:138-147."""
    if h and len(h) != tmhash.SIZE:
        raise ValueError(f"expected size to be {tmhash.SIZE} bytes, got {len(h)} bytes")


def _verify(chain_id, vals, commit, voting_power_needed, ignore_sig,
            count_sig, count_all_signatures, look_up_by_index, device) -> None:
    if _should_batch_verify(vals, commit):
        _verify_commit_batch(chain_id, vals, commit, voting_power_needed,
                             ignore_sig, count_sig, count_all_signatures,
                             look_up_by_index, device)
    else:
        _verify_commit_single(chain_id, vals, commit, voting_power_needed,
                              ignore_sig, count_sig, count_all_signatures,
                              look_up_by_index)


def _select_commit_sigs(
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool],
    count_sig: Callable[[CommitSig], bool],
    count_all_signatures: bool,
    look_up_by_index: bool,
):
    """Selection + tally of the object path (validation.go:152-240): flag
    filtering, the lookup by index or by address (unknown addresses
    skipped, a double vote raised), signature-length checks and the
    voting-power tally with the reference's early stop. Returns
    (selected [(sig_idx, val_row, validator)], tallied): val_row is the
    validator's row in vals, sig_idx when looking up by index."""
    if count_all_signatures and look_up_by_index and ignore_sig is _ignore_absent:
        # verify_commit's predicates: flag listcomps in place of three
        # calls a signature (the reference's shortcut)
        sigs = list(commit.signatures)
        validators = vals.validators
        flags = [c.block_id_flag for c in sigs]
        selected = [(i, i, validators[i]) for i, f in enumerate(flags)
                    if f != BLOCK_ID_FLAG_ABSENT]
        if any(len(sigs[i].signature) != 64 for i, _, _ in selected):
            raise ValueError("invalid signature length")
        if count_sig is _count_for_block:
            tallied = sum(validators[i].voting_power for i, f in enumerate(flags)
                          if f == BLOCK_ID_FLAG_COMMIT)
        else:
            tallied = sum(v.voting_power for _, _, v in selected)
        return selected, tallied
    tallied = 0
    selected = []
    seen_vals: dict = {}
    for idx, commit_sig in enumerate(commit.signatures):
        if ignore_sig(commit_sig):
            continue
        if look_up_by_index:
            val_row, val = idx, vals.validators[idx]
        else:
            val_row, val = vals.get_by_address(commit_sig.validator_address)
            if val is None:
                continue
            if val_row in seen_vals:
                raise ValueError(
                    f"double vote from {val} ({seen_vals[val_row]} and {idx})"
                )
            seen_vals[val_row] = idx
        # per lane, before the tally concludes: BatchVerifier.Add order
        # (crypto/ed25519/ed25519.go:203-217)
        if len(commit_sig.signature) != 64:
            raise ValueError("invalid signature length")
        selected.append((idx, val_row, val))
        if count_sig(commit_sig):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            break
    return selected, tallied


def _fused_commit_prep(chain_id, vals, commit, voting_power_needed, ignore_sig,
                       count_sig, count_all_signatures):
    """(sel_idx, tallied, EntryBlock or None) of the fused prep
    (ops/commit_prep.py), or None when the commit or set is not
    columnar-representable: the object path then gives the exact errors."""
    if ignore_sig is _ignore_not_for_block:
        mode = commit_prep.MODE_SELECT_COMMIT_ONLY
    elif ignore_sig is _ignore_absent:
        mode = 0
    else:
        return None
    if count_sig is _count_for_block:
        mode |= commit_prep.MODE_COUNT_FOR_BLOCK
    elif count_sig is not _count_all:
        return None
    if not count_all_signatures:
        mode |= commit_prep.MODE_EARLY_STOP
    from ..ops import backend as _backend

    return commit_prep.prep_commit_from(commit, vals, chain_id, voting_power_needed, mode,
                                        ram=_backend.builds_ram_columns())


def _batch_gate(vals: ValidatorSet, commit: Commit, secp_lane: bool = False):
    """The batch path's precondition (validation.go:152-160): a proposer
    whose key type batches, and at least BATCH_VERIFY_THRESHOLD
    signatures; with secp_lane (the prepare seam, reference :318-334), an
    all-secp256k1 set passes too. Returns the proposer."""
    proposer = vals.get_proposer()
    if (
        proposer is None
        or len(commit.signatures) < BATCH_VERIFY_THRESHOLD
        or not (_batch.supports_batch_verifier(proposer.pub_key)
                or (secp_lane and vals.secp256k1_columns() is not None))
    ):
        raise RuntimeError(
            "unsupported signature algorithm or insufficient signatures for batch verification"
        )
    return proposer


def select_block(chain_id: str, vals: ValidatorSet, commit: Commit, voting_power_needed: int,
                 ignore_sig, count_sig, count_all_signatures: bool, look_up_by_index: bool):
    """The object path's host half: selection and tally over CommitSig
    objects, then the sign bytes and the batch. Returns (EntryBlock,
    keys, sig_idxs, tallied): an all-ed25519 set's block carries the
    selected validators' rows of vals (by address, not the signatures'
    indices) and the set's epoch key, and keys is None, as does an
    all-secp256k1 set's, of scheme secp256k1 (reference :357-383); any
    other set's block carries the keys' bytes and keys the PubKey
    objects, for the batch verifier's type check."""
    with record_function("commit.select"):
        selected, tallied = _select_commit_sigs(
            vals, commit, voting_power_needed,
            ignore_sig, count_sig, count_all_signatures, look_up_by_index,
        )
    if tallied <= voting_power_needed:
        raise ErrNotEnoughVotingPowerSigned(got=tallied, needed=voting_power_needed)
    sigs = list(commit.signatures)
    with record_function("commit.sign_bytes"):
        sig_idxs = [idx for idx, _, _ in selected]
        buf, offsets = commit.vote_sign_bytes_block(chain_id, sig_idxs)
        n = len(selected)
        sig = np.frombuffer(b"".join(sigs[i].signature for i in sig_idxs),
                            dtype=np.uint8).reshape(n, 64)
        # columns exist only for an all-ed25519 or all-secp256k1 set: an
        # sr25519 or mixed set takes the per-key path below and is never
        # noted in the epoch cache
        cols = vals.ed25519_columns()
        scols = None if cols is not None else vals.secp256k1_columns()
        rows = np.asarray([row for _, row, _ in selected], dtype=np.int32)
        if cols is not None:
            # every key is ed25519 (JAX validation.py:357-383): the key
            # type check is the column's
            keys = None
            block = EntryBlock(cols[0][rows], sig, buf, offsets, val_idx=rows,
                               epoch_key=epoch_cache.note_valset(vals))
        elif scols is not None:
            # every key is secp256k1: the 33-byte keys split into the
            # prefix column and X
            keys = None
            raw = scols[0][rows]
            block = EntryBlock(np.ascontiguousarray(raw[:, 1:]), sig, buf, offsets,
                               val_idx=rows, epoch_key=epoch_cache.note_valset(vals),
                               scheme="secp256k1", pub_aux=np.ascontiguousarray(raw[:, 0]))
        else:
            keys = [val.pub_key for _, _, val in selected]
            pub_b = b"".join(k.bytes() for k in keys)
            if len(pub_b) != 32 * n:
                # a wrong-size key must fail as per-entry add() does, not
                # as a reshape error
                raise TypeError(f"pubkey is not {vals.get_proposer().pub_key.type()}")
            block = EntryBlock(np.frombuffer(pub_b, dtype=np.uint8).reshape(n, 32),
                               sig, buf, offsets)
    return block, keys, sig_idxs, tallied


def _blame_conclude(sig_idxs, commit: Commit):
    """The verdict half of the batch path over a validity row
    (validation.go:242-248): all valid returns; otherwise the first
    invalid row maps back through the selection to the commit's index of
    its signature."""

    def conclude(valid) -> None:
        valid_arr = np.asarray(valid, dtype=bool)
        if valid_arr.size and valid_arr.all():
            return
        if valid_arr.size:
            idx = int(sig_idxs[int(np.argmin(valid_arr))])
            raise ValueError(
                f"wrong signature (#{idx}): {commit.signatures[idx].signature.hex().upper()}"
            )
        raise RuntimeError("BUG: batch verification failed with no invalid signatures")

    return conclude


def _prepare_block(chain_id, vals, commit, voting_power_needed, ignore_sig, count_sig,
                   count_all_signatures, look_up_by_index):
    """(EntryBlock, keys, conclude) of the batch path: the fused prep
    for an all-ed25519 set looked up by index and a columnar commit,
    else the object path (select_block)."""
    if look_up_by_index and vals.ed25519_columns() is not None:
        with record_function("commit.prep"):
            fused = _fused_commit_prep(chain_id, vals, commit, voting_power_needed,
                                       ignore_sig, count_sig, count_all_signatures)
        if fused is not None:
            sel_idx, tallied, block = fused
            if block is None:
                raise ErrNotEnoughVotingPowerSigned(got=tallied, needed=voting_power_needed)
            # the key type is the columns' (all ed25519, or no fused path);
            # signature lengths are the (n, 64) column's
            return block, None, _blame_conclude(sel_idx, commit)
    block, keys, sig_idxs, _ = select_block(
        chain_id, vals, commit, voting_power_needed, ignore_sig, count_sig,
        count_all_signatures, look_up_by_index)
    return block, keys, _blame_conclude(sig_idxs, commit)


def _verify_commit_batch(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool],
    count_sig: Callable[[CommitSig], bool],
    count_all_signatures: bool,
    look_up_by_index: bool,
    device,
) -> None:
    """validation.go:152-263: prepare (_prepare_block), verify on the
    proposer's key type's batch verifier, conclude (the blame)."""
    proposer = _batch_gate(vals, commit)
    bv = _batch.create_batch_verifier(proposer.pub_key, device=device)
    block, keys, conclude = _prepare_block(
        chain_id, vals, commit, voting_power_needed, ignore_sig, count_sig,
        count_all_signatures, look_up_by_index)
    bv.add_block(block, keys=keys)
    conclude(bv.verify()[1])


# -- the asynchronous seam -------------------------------------------------------


class PrepareUnsupported(Exception):
    """prepare_commit_batch cannot represent this commit's set as one
    EntryBlock of one scheme (an sr25519 or mixed set): the caller takes
    the synchronous path, which handles every case."""


def prepare_commit_batch(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool],
    count_sig: Callable[[CommitSig], bool],
    count_all_signatures: bool,
    look_up_by_index: bool,
):
    """The host half of _verify_commit_batch (reference :297): selection,
    double votes, lengths and the tally, by the fused prep or the object
    path, but the EntryBlock (validator rows and epoch key attached) is
    returned with conclude(valid), which raises the batch path's blame
    over a validity row. Raises what _verify_commit_batch raises before
    its verify, or PrepareUnsupported for a set that is neither all
    ed25519 nor all secp256k1 (reference :297-384: a secp256k1 set's
    block is of scheme secp256k1, for the device's secp256k1 lane)."""
    _batch_gate(vals, commit, secp_lane=True)
    if vals.ed25519_columns() is None and vals.secp256k1_columns() is None:
        raise PrepareUnsupported("validator set is not single-scheme columnar")
    block, _keys, conclude = _prepare_block(
        chain_id, vals, commit, voting_power_needed, ignore_sig, count_sig,
        count_all_signatures, look_up_by_index)
    return block, conclude


def prepare_commit_scheme_split(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool] = _ignore_not_for_block,
    count_sig: Callable[[CommitSig], bool] = _count_all,
    count_all_signatures: bool = False,
    look_up_by_index: bool = True,
):
    """The host half for a committee of ed25519 and secp256k1 keys
    (reference :387-440): selection and tally once (the object path's
    _select_commit_sigs), then the selected signatures split by key
    scheme into one EntryBlock each, with their validator rows. Submitted
    together to a mesh-mode dispatcher, both land in different lanes of
    one superbatch. Returns (blocks, conclude): blocks in (ed25519,
    secp256k1) order, those with rows only; conclude takes their verdict
    rows concatenated in that order and raises the sequential path's
    blame, the first invalid signature in signature order (not in
    concatenation order). Raises PrepareUnsupported for a key of another
    scheme."""
    view = vals.scheme_rows()
    if view is None:
        raise PrepareUnsupported("validator set has non-device key schemes")
    kinds, pub32, aux = view
    with record_function("commit.select"):
        selected, tallied = _select_commit_sigs(
            vals, commit, voting_power_needed,
            ignore_sig, count_sig, count_all_signatures, look_up_by_index,
        )
    if tallied <= voting_power_needed:
        raise ErrNotEnoughVotingPowerSigned(got=tallied, needed=voting_power_needed)
    per: dict = {0: [], 1: []}
    for sig_idx, val_row, _ in selected:
        per[int(kinds[val_row])].append((sig_idx, val_row))
    blocks = []
    parts_sig_idxs = []
    sigs = commit.signatures
    for kind, scheme in ((0, "ed25519"), (1, "secp256k1")):
        lanes = per[kind]
        if not lanes:
            continue
        sig_idxs = [i for i, _ in lanes]
        with record_function("commit.sign_bytes"):
            buf, offsets = commit.vote_sign_bytes_block(chain_id, sig_idxs)
        rows = np.asarray([r for _, r in lanes], dtype=np.int32)
        sig = np.frombuffer(b"".join(sigs[i].signature for i in sig_idxs),
                            dtype=np.uint8).reshape(len(lanes), 64)
        blocks.append(EntryBlock(
            pub32[rows], sig, buf, offsets, val_idx=rows, scheme=scheme,
            pub_aux=np.ascontiguousarray(aux[rows]) if scheme == "secp256k1" else None))
        parts_sig_idxs.append(sig_idxs)
    all_idx = (np.concatenate([np.asarray(p, dtype=np.int64) for p in parts_sig_idxs])
               if parts_sig_idxs else np.zeros(0, dtype=np.int64))

    def conclude(valid) -> None:
        valid_arr = np.asarray(valid, dtype=bool)
        if valid_arr.size and valid_arr.all():
            return
        if valid_arr.size:
            # the first invalid signature in signature order: the rows are
            # per scheme, so the least offending index, not the row's argmin
            idx = int(all_idx[~valid_arr].min())
            raise ValueError(
                f"wrong signature (#{idx}): {commit.signatures[idx].signature.hex().upper()}"
            )
        raise RuntimeError("BUG: batch verification failed with no invalid signatures")

    return blocks, conclude


def prepare_commit_light(chain_id: str, vals: ValidatorSet, block_id: BlockID,
                         height: int, commit: Commit):
    """verify_commit_light's host half (reference :190): the set and
    commit checks, then prepare_commit_batch with the light predicates.
    Returns (entries, conclude), or (None, None) when the commit took
    the single-signature path below the batch threshold and is verified
    already (on the host). An all-secp256k1 set batches (the reference's
    gate, _should_batch_prepare)."""
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    voting_power_needed = vals.total_voting_power() * 2 // 3
    if not _should_batch_prepare(vals, commit):
        _verify_commit_single(chain_id, vals, commit, voting_power_needed,
                              _ignore_not_for_block, _count_all, False, True)
        return None, None
    return prepare_commit_batch(chain_id, vals, commit, voting_power_needed,
                                _ignore_not_for_block, _count_all, False, True)


def prepare_commit_range(chain_id: str, vals: ValidatorSet, items):
    """The range form (reference :213): items are (height, block_id,
    commit) of one validator set, in order. Returns (prepared, synced):
    [(height, entries, conclude)] to verify on the device, and the
    heights that took the single-signature path and are verified. A host
    failure raises what verify_commit_light raises for its height."""
    prepared = []
    synced = []
    for height, block_id, commit in items:
        entries, conclude = prepare_commit_light(chain_id, vals, block_id, height, commit)
        if entries is None:
            synced.append(height)
        else:
            prepared.append((height, entries, conclude))
    return prepared, synced


def prepare_commit_light_trusting(chain_id: str, vals: ValidatorSet, commit: Commit,
                                  trust_level: Fraction):
    """verify_commit_light_trusting's host half (reference :242): the nil
    and overflow checks, the selection by address with double votes and
    the trust-level tally. Returns as prepare_commit_light does."""
    if vals is None:
        raise ValueError("nil validator set")
    if trust_level.denominator == 0:
        raise ValueError("trustLevel has zero Denominator")
    if commit is None:
        raise ValueError("nil commit")
    total_mul, overflow = safe_mul(vals.total_voting_power(), trust_level.numerator)
    if overflow:
        raise OverflowError(
            "int64 overflow while calculating voting power needed; "
            "please provide smaller trustLevel numerator"
        )
    voting_power_needed = total_mul // trust_level.denominator
    if not _should_batch_prepare(vals, commit):
        _verify_commit_single(chain_id, vals, commit, voting_power_needed,
                              _ignore_not_for_block, _count_all, False, False)
        return None, None
    return prepare_commit_batch(chain_id, vals, commit, voting_power_needed,
                                _ignore_not_for_block, _count_all, False, False)


def _verify_commit_single(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool],
    count_sig: Callable[[CommitSig], bool],
    count_all_signatures: bool,
    look_up_by_index: bool,
) -> None:
    """validation.go:265-334."""
    tallied = 0
    seen_vals: dict = {}
    for idx, commit_sig in enumerate(commit.signatures):
        if ignore_sig(commit_sig):
            continue
        if look_up_by_index:
            val = vals.validators[idx]
        else:
            val_row, val = vals.get_by_address(commit_sig.validator_address)
            if val is None:
                continue
            if val_row in seen_vals:
                raise ValueError(
                    f"double vote from {val} ({seen_vals[val_row]} and {idx})"
                )
            seen_vals[val_row] = idx
        vote_sign_bytes = commit.vote_sign_bytes(chain_id, idx)
        if not val.pub_key.verify_signature(vote_sign_bytes, commit_sig.signature):
            raise ValueError(
                f"wrong signature (#{idx}): {commit_sig.signature.hex().upper()}"
            )
        if count_sig(commit_sig):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            return
    if tallied <= voting_power_needed:
        raise ErrNotEnoughVotingPowerSigned(got=tallied, needed=voting_power_needed)


def _verify_basic_vals_and_commit(
    vals: Optional[ValidatorSet],
    commit: Optional[Commit],
    height: int,
    block_id: BlockID,
) -> None:
    """validation.go:336-358."""
    if vals is None:
        raise ValueError("nil validator set")
    if commit is None:
        raise ValueError("nil commit")
    if vals.size() != len(commit.signatures):
        raise ErrInvalidCommitSignatures(vals.size(), len(commit.signatures))
    if height != commit.height:
        raise ErrInvalidCommitHeight(height, commit.height)
    if block_id != commit.block_id:
        raise ValueError(
            f"invalid commit -- wrong block ID: want {block_id}, got {commit.block_id}"
        )


# -- aggregated BLS12-381 commits -------------------------------------------------
#
# The blame strings are built once here and shared by the sequential walk
# and the batched conclude, so the two cannot drift apart.

_AGG_APK_IDENTITY = "aggregate pubkey is the identity"


def _agg_sig_blame(word: str, sig: bytes) -> str:
    return f"{word} aggregate signature: {sig.hex().upper()}"


def _agg_pub_blame(word: str, idx: int) -> str:
    return f"{word} aggregate pubkey (validator #{idx})"


def _agg_basic_and_tally(vals, block_id, height, agg, voting_power_needed: int) -> list:
    """The host half both aggregated-commit paths share: the shape, the
    bitmap's size, then the power tally, all before any crypto (a commit
    that cannot reach quorum spends no pairing). Returns the signers'
    validator rows in ascending order."""
    if vals is None:
        raise ValueError("nil validator set")
    if agg is None:
        raise ValueError("nil commit")
    if agg.signers is None or agg.signers.size() != vals.size():
        raise ErrInvalidCommitSignatures(
            vals.size(), agg.signers.size() if agg.signers is not None else 0)
    if height != agg.height:
        raise ErrInvalidCommitHeight(height, agg.height)
    if block_id != agg.block_id:
        raise ValueError(f"invalid commit -- wrong block ID: want {block_id}, got {agg.block_id}")
    idxs = agg.signers.get_true_indices()
    tallied = sum(vals.validators[i].voting_power for i in idxs)
    if tallied <= voting_power_needed:
        raise ErrNotEnoughVotingPowerSigned(got=tallied, needed=voting_power_needed)
    return idxs


def verify_aggregated_commit(chain_id: str, vals: ValidatorSet, block_id: BlockID, height: int,
                             agg) -> None:
    """The sequential walk of an aggregated commit, on the host (the oracle
    the batched path is held to). The order of the checks is the
    contract: shape, bitmap size, power tally (before any crypto), the
    aggregate signature's status, the signers' key statuses in ascending
    validator order, the identity aggregate, then the one pairing
    check."""
    from ..crypto import bls12381 as _bls

    voting_power_needed = vals.total_voting_power() * 2 // 3
    with record_function("agg.verify"):
        idxs = _agg_basic_and_tally(vals, block_id, height, agg, voting_power_needed)
        sig = bytes(agg.signature)
        _, reason = _bls.signature_status(sig)
        if reason is not None:
            raise ValueError(_agg_sig_blame(reason, sig))
        pubs = []
        for i in idxs:
            pub = vals.validators[i].pub_key.bytes()
            _, preason = _bls.pubkey_status(pub)
            if preason is not None:
                raise ValueError(_agg_pub_blame(preason, i))
            pubs.append(pub)
        apk, _ = _bls.aggregate_pubkeys(pubs)
        if apk is None:
            raise ValueError(_AGG_APK_IDENTITY)
        if not _bls.fast_aggregate_verify(pubs, agg.sign_bytes(chain_id), sig):
            raise ValueError(_agg_sig_blame("wrong", sig))


def prepare_aggregated_commit(chain_id: str, vals: ValidatorSet, block_id: BlockID, height: int,
                              agg, k_hint: int = 1):
    """The seam half of an aggregated commit: the host checks run here
    (raising what the sequential walk raises), then the commit comes
    back as a one-row AggBlock with conclude(codes), which turns the
    lane's int32 verdict code into the walk's blame strings. The shared
    dispatcher fuses the AggBlocks of one committee, so K concurrent
    commits land in one launch A.

    `k_hint` is the caller's concurrency: below
    backend.BLS_DEVICE_THRESHOLD (2) one commit cannot amortise a final
    exponentiation, so it verifies synchronously through the walk and
    (None, None) comes back (the reference's semantics, keyed on the
    caller's concurrency, not on the device). Raises PrepareUnsupported
    for a set that is not all bls12381."""
    from ..crypto import bls12381 as _bls
    from ..ops import backend as _backend
    from ..ops import bls_verify as _bv
    from ..ops.entry_block import AggBlock

    if k_hint < _backend.BLS_DEVICE_THRESHOLD:
        verify_aggregated_commit(chain_id, vals, block_id, height, agg)
        return None, None
    voting_power_needed = vals.total_voting_power() * 2 // 3
    idxs = _agg_basic_and_tally(vals, block_id, height, agg, voting_power_needed)
    cols = vals.bls12381_columns()
    if cols is None:
        raise PrepareUnsupported("validator set is not bls12381-columnar")
    pub48 = cols[0]
    bits = np.zeros(vals.size(), dtype=bool)
    bits[idxs] = True
    epoch_cache.note_valset(vals)  # registers the committee's G1 table
    sig = bytes(agg.signature)
    blk = AggBlock.from_commits([(bits, agg.sign_bytes(chain_id), sig)], pub48, vals.hash())

    def conclude(codes) -> None:
        code = int(np.asarray(codes).reshape(-1)[0])
        if code == _bv.CODE_VALID:
            return
        if code == _bv.CODE_PAIRING:
            raise ValueError(_agg_sig_blame("wrong", sig))
        if code == _bv.CODE_APK_IDENTITY:
            raise ValueError(_AGG_APK_IDENTITY)
        word = _bv.SIG_CODE_WORDS.get(code)
        if word is not None:
            raise ValueError(_agg_sig_blame(word, sig))
        if code >= _bv.CODE_PUB_BASE:
            i = code - _bv.CODE_PUB_BASE
            # the word comes from the committee snapshot: pubkey_status is
            # memoized per key, so this is a dict hit
            word = _bls.pubkey_status(pub48[i].tobytes())[1]
            raise ValueError(_agg_pub_blame(word or "malformed", i))
        raise RuntimeError(f"unknown BLS verdict code {code}")

    return blk, conclude
