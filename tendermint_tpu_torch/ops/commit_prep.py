"""Fused commit prep: CommitBlock columns to a kernel-ready EntryBlock.

Counterpart: tendermint_tpu/ops/commit_prep.py (select_and_tally,
_compose_selected, prep_commit_from, prep_commit, _prep_commit_numpy).
A commit decoded from its wire bytes is columnar from decode
(types/block.py fills a CommitBlock once; CommitSig objects are lazy
views), and this module turns those columns and the validator set's
cached pub and power columns into an EntryBlock in ONE call of the host
library (ops/host.commit_prep_fused, csrc/host_prep.cpp), the
interpreter lock released:

    selection   flag predicate over the (n,) uint8 flags column
    tally       voting-power sum against the 2/3 threshold (with the
                reference's early stop for the light path)
    sign bytes  canonical vote sign bytes of every selected vote in one
                contiguous buffer + offset table
    gather      pub (m, 32) / sig (m, 64) rows of the selection

The reference's device-hash RAM blocks (_fill_ram) are not built: only
a device SHA-512, which the port does not have, reads them.
_prep_commit_numpy is the plain version of the C call, for the tests
and chip_smoke.py's oracle only: the verify path never calls it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import epoch_cache, host
from .entry_block import CommitBlock, EntryBlock

# BlockIDFlag values (types/block.py), declared again so the types layer
# can import this module
FLAG_ABSENT = 1
FLAG_COMMIT = 2
FLAG_NIL = 3

# mode bits of host.commit_prep_fused
MODE_SELECT_COMMIT_ONLY = 1
MODE_COUNT_FOR_BLOCK = 2
MODE_EARLY_STOP = 4


def select_and_tally(cblock: CommitBlock, power_col: np.ndarray, threshold: int,
                     mode: int) -> Tuple[np.ndarray, int]:
    """Selection + voting-power tally over the flags column. Returns
    (sel_idx (m,) int64, tallied). Semantics mirror validation.go:152's
    loop exactly: early-stop keeps the lane that crosses the threshold,
    count-for-block tallies only COMMIT lanes while still selecting NIL
    lanes for verification."""
    flags = cblock.flags
    if mode & MODE_SELECT_COMMIT_ONLY:
        sel = np.flatnonzero(flags == FLAG_COMMIT).astype(np.int64)
    else:
        sel = np.flatnonzero(flags != FLAG_ABSENT).astype(np.int64)
    if sel.size == 0:
        return sel, 0
    if mode & MODE_EARLY_STOP:
        counted = power_col[sel]
        if mode & MODE_COUNT_FOR_BLOCK:
            counted = counted * (flags[sel] == FLAG_COMMIT)
        cum = np.cumsum(counted)
        k = int(np.searchsorted(cum, threshold, side="right"))
        if k < sel.size:
            return sel[: k + 1], int(cum[k])
        return sel, int(cum[-1])
    if mode & MODE_COUNT_FOR_BLOCK:
        tallied = int(power_col[flags == FLAG_COMMIT].sum())
    else:
        tallied = int(power_col[sel].sum())
    return sel, tallied


def _compose_selected(cblock: CommitBlock, sel: np.ndarray, prefix_commit: bytes,
                      prefix_nil: bytes, suffix: bytes) -> Tuple[bytes, np.ndarray]:
    """Sign bytes for the selected lanes, in selection order, as ONE
    (buffer, (m+1,) int64 offsets) pair. Lanes group by flag (at most
    two groups, COMMIT and NIL, per verify_commit selection); a mixed
    selection composes per group and merges by lane order."""
    from ..wire.canonical import compose_vote_sign_bytes_cols

    secs = cblock.ts_seconds[sel]
    nanos = cblock.ts_nanos[sel]
    flags = cblock.flags[sel]
    nil_rows = np.flatnonzero(flags == FLAG_NIL)
    if nil_rows.size == 0:
        return compose_vote_sign_bytes_cols((prefix_commit, suffix), secs, nanos)
    commit_rows = np.flatnonzero(flags != FLAG_NIL)
    m = sel.size
    lens = np.zeros(m, dtype=np.int64)
    parts = []
    for rows, prefix in ((commit_rows, prefix_commit), (nil_rows, prefix_nil)):
        buf, offs = compose_vote_sign_bytes_cols((prefix, suffix), secs[rows], nanos[rows])
        lens[rows] = np.diff(offs)
        parts.append((rows, np.frombuffer(buf, dtype=np.uint8), offs))
    offsets = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    out = np.empty(int(offsets[-1]), dtype=np.uint8)
    for rows, flat, offs in parts:
        for j, row in enumerate(rows):
            out[offsets[row] : offsets[row + 1]] = flat[offs[j] : offs[j + 1]]
    return out.tobytes(), offsets


def prep_commit_from(commit, vals, chain_id: str, threshold: int,
                     mode: int) -> Optional[Tuple[np.ndarray, int, Optional[EntryBlock]]]:
    """The fused path's entry for verify_commit: the columnar-eligibility
    checks (a CommitBlock, all-ed25519 validator columns of the commit's
    size), the per-flag templates and prep_commit. Returns None when the
    commit or set is not columnar-representable: the caller takes the
    object path and its exact errors. The block carries each lane's
    validator row (val_idx) and, for a set the epoch cache has noted,
    the set's key (ops/epoch_cache.py)."""
    cols = vals.ed25519_columns()
    if cols is None:
        return None
    cblock = commit.commit_block()
    if cblock is None or cols[0].shape[0] != cblock.n:
        return None
    tpl_c = commit.sign_bytes_template(chain_id, FLAG_COMMIT)
    tpl_n = commit.sign_bytes_template(chain_id, FLAG_NIL)
    sel, tallied, block = prep_commit(cblock, cols[0], cols[1], tpl_c[0], tpl_n[0], tpl_c[1],
                                      threshold, mode)
    if block is not None:
        block.val_idx = sel.astype(np.int32)
        block.epoch_key = epoch_cache.note_valset(vals)
    return sel, tallied, block


def prep_commit(cblock: CommitBlock, pub_col: np.ndarray, power_col: np.ndarray,
                prefix_commit: bytes, prefix_nil: bytes, suffix: bytes, threshold: int,
                mode: int) -> Tuple[np.ndarray, int, Optional[EntryBlock]]:
    """The fused commit prep: (sel_idx, tallied, EntryBlock or None), in
    one call of the host library. The block is None exactly when tallied
    <= threshold: the caller raises ErrNotEnoughVotingPowerSigned before
    any sign bytes were composed, as the object path does."""
    sel, tallied, cols = host.commit_prep_fused(
        np.ascontiguousarray(cblock.flags), np.ascontiguousarray(cblock.sig),
        np.ascontiguousarray(cblock.ts_seconds), np.ascontiguousarray(cblock.ts_nanos),
        np.ascontiguousarray(pub_col), np.ascontiguousarray(power_col),
        prefix_commit, prefix_nil, suffix, threshold, mode)
    if cols is None:
        return sel, tallied, None
    pub, sig, msgs, offsets = cols
    return sel, tallied, EntryBlock(pub, sig, msgs, offsets)


def _prep_commit_numpy(cblock: CommitBlock, pub_col: np.ndarray, power_col: np.ndarray,
                       prefix_commit: bytes, prefix_nil: bytes, suffix: bytes,
                       threshold: int, mode: int) -> Tuple[np.ndarray, int, Optional[EntryBlock]]:
    """Plain version of prep_commit: identical outputs, in numpy."""
    sel, tallied = select_and_tally(cblock, power_col, threshold, mode)
    if tallied <= threshold:
        return sel, tallied, None
    msgs, offsets = _compose_selected(cblock, sel, prefix_commit, prefix_nil, suffix)
    return sel, tallied, EntryBlock(pub_col[sel], cblock.sig[sel], msgs, offsets)
