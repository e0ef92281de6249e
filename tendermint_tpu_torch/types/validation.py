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
reference's. The batch path's host stages are torch.profiler
record_function spans ("commit.*" here; "rlc.*", "verify.*" and "sr.*"
in ops/), so one profiler trace of a call shows its host stages beside
its device time.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
from torch.profiler import record_function

from ..crypto import batch as _batch
from ..device import resolve_device
from ..ops import epoch_cache
from ..ops.entry_block import EntryBlock
from .block import BlockID, Commit, CommitSig
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
    """Selection + tally of the batch path (validation.go:152-240), by
    validator index: flag filtering, signature-length checks and the
    voting-power tally with the reference's early stop. Returns
    (selected [(sig_idx, validator)], tallied)."""
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
    with record_function("commit.select"):
        selected, tallied = _select_commit_sigs(
            vals, commit, voting_power_needed,
            ignore_sig, count_sig, count_all_signatures,
        )
    if tallied <= voting_power_needed:
        raise ErrNotEnoughVotingPowerSigned(got=tallied, needed=voting_power_needed)
    sigs = commit.signatures
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
    ok, valid_sigs = bv.verify()
    if ok:
        return
    valid_arr = np.asarray(valid_sigs, dtype=bool)
    if not valid_arr.all() and valid_arr.size:
        idx = sig_idxs[int(np.argmin(valid_arr))]
        raise ValueError(
            f"wrong signature (#{idx}): {sigs[idx].signature.hex().upper()}"
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
