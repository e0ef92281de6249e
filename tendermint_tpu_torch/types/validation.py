"""Commit verification — the hot path of this slice.

Counterpart: tendermint_tpu/types/validation.py (types/validation.go).
verify_commit / verify_commit_light take the batch path through
crypto.batch, where the port's device verifier for the proposer's key
type (ed25519: RLC lanes or per-signature; sr25519: ops/sr25519.py)
verifies the commit's signatures on `device`; commits below the batch
threshold verify one signature at a time on the host. An ed25519 batch
carries its validator rows and, once the set has been seen before, the
set's epoch key (ops/epoch_cache.py), so a warm set's keys come from
the device table instead of being decompressed again. Error cases, the tally and
the blame of the first bad signature are byte-identical to the
reference's. A columnar commit (one decoded from its wire bytes, or
built of canonical CommitSig objects) of an all-ed25519 set takes the
fused prep (ops/commit_prep.py: selection, tally, sign bytes and the
key gather in one call of the host library); any other commit or set
takes the object path, which selects over CommitSig objects. The batch
path's host stages are torch.profiler record_function spans
("commit.prep" on the fused path, "commit.select" and
"commit.sign_bytes" on the object path; "rlc.*", "verify.*" and "sr.*"
in ops/), so one profiler trace of a call shows its host stages beside
its device time.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
from torch.profiler import record_function

from ..crypto import batch as _batch
from ..device import resolve_device
from ..ops import commit_prep, epoch_cache
from ..ops.entry_block import EntryBlock
from .block import BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig
from .validator_set import ErrNotEnoughVotingPowerSigned, ValidatorSet

BATCH_VERIFY_THRESHOLD = 2  # validation.go:12


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
            _ignore_absent, _count_for_block, True, device)


def verify_commit_light(
    chain_id: str, vals: ValidatorSet, block_id: BlockID, height: int,
    commit: Commit, *, device=None,
) -> None:
    """validation.go:59-86: +2/3 signed; stops at the first 2/3."""
    device = resolve_device(device)
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    _verify(chain_id, vals, commit, vals.total_voting_power() * 2 // 3,
            _ignore_not_for_block, _count_all, False, device)


def _verify(chain_id, vals, commit, voting_power_needed, ignore_sig,
            count_sig, count_all_signatures, device) -> None:
    if _should_batch_verify(vals, commit):
        _verify_commit_batch(chain_id, vals, commit, voting_power_needed,
                             ignore_sig, count_sig, count_all_signatures,
                             device)
    else:
        _verify_commit_single(chain_id, vals, commit, voting_power_needed,
                              ignore_sig, count_sig, count_all_signatures)


def _select_commit_sigs(
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool],
    count_sig: Callable[[CommitSig], bool],
    count_all_signatures: bool,
):
    """Selection + tally of the object path (validation.go:152-240), by
    validator index: flag filtering, signature-length checks and the
    voting-power tally with the reference's early stop. Returns
    (selected [(sig_idx, validator)], tallied)."""
    if count_all_signatures and ignore_sig is _ignore_absent:
        # verify_commit's predicates: flag listcomps in place of three
        # calls a signature (the reference's shortcut)
        sigs = list(commit.signatures)
        validators = vals.validators
        flags = [c.block_id_flag for c in sigs]
        selected = [(i, validators[i]) for i, f in enumerate(flags)
                    if f != BLOCK_ID_FLAG_ABSENT]
        if any(len(sigs[i].signature) != 64 for i, _ in selected):
            raise ValueError("invalid signature length")
        if count_sig is _count_for_block:
            tallied = sum(validators[i].voting_power for i, f in enumerate(flags)
                          if f == BLOCK_ID_FLAG_COMMIT)
        else:
            tallied = sum(v.voting_power for _, v in selected)
        return selected, tallied
    tallied = 0
    selected = []
    for idx, commit_sig in enumerate(commit.signatures):
        if ignore_sig(commit_sig):
            continue
        val = vals.validators[idx]
        # per lane, before the tally concludes: BatchVerifier.Add order
        # (crypto/ed25519/ed25519.go:203-217)
        if len(commit_sig.signature) != 64:
            raise ValueError("invalid signature length")
        selected.append((idx, val))
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
    return commit_prep.prep_commit_from(commit, vals, chain_id, voting_power_needed, mode)


def _verify_commit_batch(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool],
    count_sig: Callable[[CommitSig], bool],
    count_all_signatures: bool,
    device,
) -> None:
    """validation.go:152-263."""
    proposer = vals.get_proposer()
    bv = _batch.create_batch_verifier(
        proposer.pub_key if proposer else None, device=device
    )
    if bv is None or len(commit.signatures) < BATCH_VERIFY_THRESHOLD:
        raise RuntimeError(
            "unsupported signature algorithm or insufficient signatures for batch verification"
        )
    fused = None
    if vals.ed25519_columns() is not None:  # sr25519 and mixed sets: the object path
        with record_function("commit.prep"):
            fused = _fused_commit_prep(chain_id, vals, commit, voting_power_needed,
                                       ignore_sig, count_sig, count_all_signatures)
    if fused is not None:
        sel_idx, tallied, block = fused
        if block is None:
            raise ErrNotEnoughVotingPowerSigned(got=tallied, needed=voting_power_needed)
        # the key type is the columns' (all ed25519, or no fused path);
        # signature lengths are the (n, 64) column's
        bv.add_block(block)
        _verdict(bv, commit, sel_idx)
        return
    with record_function("commit.select"):
        selected, tallied = _select_commit_sigs(
            vals, commit, voting_power_needed,
            ignore_sig, count_sig, count_all_signatures,
        )
    if tallied <= voting_power_needed:
        raise ErrNotEnoughVotingPowerSigned(got=tallied, needed=voting_power_needed)
    sigs = list(commit.signatures)
    with record_function("commit.sign_bytes"):
        sig_idxs = [idx for idx, _ in selected]
        buf, offsets = commit.vote_sign_bytes_block(chain_id, sig_idxs)
        n = len(selected)
        sig = np.frombuffer(b"".join(sigs[i].signature for i in sig_idxs),
                            dtype=np.uint8).reshape(n, 64)
        # columns exist only for an all-ed25519 set: an sr25519 or mixed
        # set takes the per-key path below and is never noted in the
        # epoch cache
        cols = vals.ed25519_columns()
        if cols is not None:
            # every key is ed25519 (JAX validation.py:357-383): gather the
            # selected rows and note the set in the epoch cache; the key
            # type check is the column's
            rows = np.asarray(sig_idxs, dtype=np.int32)
            keys = None
            block = EntryBlock(cols[0][rows], sig, buf, offsets, val_idx=rows,
                               epoch_key=epoch_cache.note_valset(vals))
        else:
            keys = [val.pub_key for _, val in selected]
            pub_b = b"".join(k.bytes() for k in keys)
            if len(pub_b) != 32 * n:
                # a wrong-size key must fail as per-entry add() does, not
                # as a reshape error
                raise TypeError(f"pubkey is not {proposer.pub_key.type()}")
            block = EntryBlock(np.frombuffer(pub_b, dtype=np.uint8).reshape(n, 32),
                               sig, buf, offsets)
    bv.add_block(block, keys=keys)
    _verdict(bv, commit, sig_idxs)


def _verdict(bv, commit: Commit, sig_idxs) -> None:
    """Verify what bv holds; blame the first bad signature by its index
    in the commit (sig_idxs maps the batch's rows to it)."""
    ok, valid_sigs = bv.verify()
    if ok:
        return
    valid_arr = np.asarray(valid_sigs, dtype=bool)
    if not valid_arr.all() and valid_arr.size:
        idx = int(sig_idxs[int(np.argmin(valid_arr))])
        raise ValueError(
            f"wrong signature (#{idx}): {commit.signatures[idx].signature.hex().upper()}"
        )
    raise RuntimeError("BUG: batch verification failed with no invalid signatures")


def _verify_commit_single(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool],
    count_sig: Callable[[CommitSig], bool],
    count_all_signatures: bool,
) -> None:
    """validation.go:265-334, by validator index."""
    tallied = 0
    for idx, commit_sig in enumerate(commit.signatures):
        if ignore_sig(commit_sig):
            continue
        val = vals.validators[idx]
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
