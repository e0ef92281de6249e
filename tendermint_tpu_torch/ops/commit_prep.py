"""Fused commit prep: CommitBlock columns to a kernel-ready EntryBlock.

Counterpart: tendermint_tpu/ops/commit_prep.py (DEVICE_HASH_MAX_MSG,
RAM_MAX_LEN, ram_nblock, scatter_rows_by_length, select_and_tally,
_compose_selected, _fill_ram, prep_commit_from, prep_commit,
_prep_commit_numpy).
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
    RAM blocks  when asked (ram) and every R || A || M within
                RAM_MAX_LEN bytes: each row's R || A || M padded into
                SHA-512 blocks and packed into the device hash's
                big-endian (hi, lo) uint32 words (EntryBlock ram_hi,
                ram_lo, ram_counts), which
                ops/sha512.pad_ram_rows pads to a bucket and the
                sha512_challenge kernel hashes

Only the op-graph path's device hash (ops/backend.py, TM_TPU_PALLAS=0)
reads the RAM blocks, so they are not built unless asked for (ram),
where the reference's prep_commit_from builds them by default
(ram_max_len=RAM_MAX_LEN): the RLC and per-signature paths do not pay
to build rows they never read (types/validation.py asks for them where
backend.builds_ram_columns() says so). The layout is fixed at
RAM_MAX_LEN bytes (ops/host.py, as in the host library).
_prep_commit_numpy and _fill_ram are the plain versions of the C call,
for the tests and chip_smoke.py's oracle only: the verify path never
calls them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import epoch_cache, host
from .entry_block import CommitBlock, EntryBlock
from .host import RAM_MAX_LEN, ram_nblock

_RAM_HDR = 64  # R (32) || A (32) ahead of the message
# Messages up to this many bytes hash on the card (R || A || M padded into
# RAM_MAX_LEN bytes of SHA-512 blocks); a batch with a longer message
# takes the host challenges. The reference reads TM_TPU_DEVICE_HASH_MAX_MSG
# with this default (and RAM_MAX_LEN = 64 + it); the port fixes both.
DEVICE_HASH_MAX_MSG = RAM_MAX_LEN - _RAM_HDR

# BlockIDFlag values (types/block.py), declared again so the types layer
# can import this module
FLAG_ABSENT = 1
FLAG_COMMIT = 2
FLAG_NIL = 3

# mode bits of host.commit_prep_fused
MODE_SELECT_COMMIT_ONLY = 1
MODE_COUNT_FOR_BLOCK = 2
MODE_EARLY_STOP = 4


def scatter_rows_by_length(buf: np.ndarray, col0: int, flat: np.ndarray,
                           offsets: np.ndarray, lens: np.ndarray) -> None:
    """Copy the records flat[offsets[i] : offsets[i] + lens[i]] into
    buf[i, col0 : col0 + lens[i]], one 2-D gather for each distinct
    length (a commit's sign bytes have a handful)."""
    base = offsets[: len(lens)]
    for length in np.unique(lens):
        if length == 0:
            continue
        rows = np.flatnonzero(lens == length)
        src = base[rows][:, None] + np.arange(length)
        buf[rows[:, None], col0 + np.arange(length)[None, :]] = flat[src]


def _fill_ram(msgs_buf, offsets: np.ndarray, pub_rows: np.ndarray,
              sig_rows: np.ndarray) -> Optional[tuple]:
    """Each row's R || A || M padded into SHA-512 blocks and closed with
    the 0x80 terminator and the 128-bit big-endian bit length, packed
    into big-endian words: (ram_hi, ram_lo (m, nblock * 16) uint32, the
    high and low halves of each 64-bit word, counts (m,) int32 the
    blocks each row uses). None when a row's R || A || M exceeds
    RAM_MAX_LEN. The plain version of the C call's RAM half (the
    reference's _fill_ram at max_len = RAM_MAX_LEN)."""
    from .sha512 import _buf_to_words, _close

    nblock = ram_nblock(RAM_MAX_LEN)
    m = pub_rows.shape[0]
    lens = np.diff(offsets)
    tot = lens + _RAM_HDR
    if m and int(tot.max()) > RAM_MAX_LEN:
        return None
    buf = np.zeros((m, nblock * 128), dtype=np.uint8)
    buf[:, :32] = sig_rows[:, :32]
    buf[:, 32:64] = pub_rows
    scatter_rows_by_length(buf, _RAM_HDR, np.frombuffer(msgs_buf, dtype=np.uint8), offsets,
                           lens)
    blocks = _close(buf, tot)
    hi, lo = _buf_to_words(buf, m, nblock)
    return hi.reshape(m, nblock * 16), lo.reshape(m, nblock * 16), blocks.astype(np.int32)


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


def prep_commit_from(commit, vals, chain_id: str, threshold: int, mode: int,
                     ram: bool = False
                     ) -> Optional[Tuple[np.ndarray, int, Optional[EntryBlock]]]:
    """The fused path's entry for verify_commit: the columnar-eligibility
    checks (a CommitBlock, all-ed25519 validator columns of the commit's
    size), the per-flag templates and prep_commit. Returns None when the
    commit or set is not columnar-representable: the caller takes the
    object path and its exact errors. The block carries each lane's
    validator row (val_idx) and, for a set the epoch cache has noted,
    the set's key (ops/epoch_cache.py); with ram (the op-graph
    device-hash path) also its RAM blocks."""
    cols = vals.ed25519_columns()
    if cols is None:
        return None
    cblock = commit.commit_block()
    if cblock is None or cols[0].shape[0] != cblock.n:
        return None
    tpl_c = commit.sign_bytes_template(chain_id, FLAG_COMMIT)
    tpl_n = commit.sign_bytes_template(chain_id, FLAG_NIL)
    sel, tallied, block = prep_commit(cblock, cols[0], cols[1], tpl_c[0], tpl_n[0], tpl_c[1],
                                      threshold, mode, ram)
    if block is not None:
        block.val_idx = sel.astype(np.int32)
        block.epoch_key = epoch_cache.note_valset(vals)
    return sel, tallied, block


def prep_commit(cblock: CommitBlock, pub_col: np.ndarray, power_col: np.ndarray,
                prefix_commit: bytes, prefix_nil: bytes, suffix: bytes, threshold: int,
                mode: int, ram: bool = False
                ) -> Tuple[np.ndarray, int, Optional[EntryBlock]]:
    """The fused commit prep: (sel_idx, tallied, EntryBlock or None), in
    one call of the host library. The block is None exactly when tallied
    <= threshold: the caller raises ErrNotEnoughVotingPowerSigned before
    any sign bytes were composed, as the object path does. With
    ram the block carries its RAM blocks when every row's R || A || M
    fits in RAM_MAX_LEN bytes."""
    sel, tallied, cols = host.commit_prep_fused(
        np.ascontiguousarray(cblock.flags), np.ascontiguousarray(cblock.sig),
        np.ascontiguousarray(cblock.ts_seconds), np.ascontiguousarray(cblock.ts_nanos),
        np.ascontiguousarray(pub_col), np.ascontiguousarray(power_col),
        prefix_commit, prefix_nil, suffix, threshold, mode, ram)
    if cols is None:
        return sel, tallied, None
    pub, sig, msgs, offsets, ram = cols
    hi, lo, counts = ram if ram is not None else (None, None, None)
    return sel, tallied, EntryBlock(pub, sig, msgs, offsets, ram_hi=hi, ram_lo=lo,
                                    ram_counts=counts)


def _prep_commit_numpy(cblock: CommitBlock, pub_col: np.ndarray, power_col: np.ndarray,
                       prefix_commit: bytes, prefix_nil: bytes, suffix: bytes,
                       threshold: int, mode: int, ram: bool = False
                       ) -> Tuple[np.ndarray, int, Optional[EntryBlock]]:
    """Plain version of prep_commit: identical outputs, in numpy."""
    sel, tallied = select_and_tally(cblock, power_col, threshold, mode)
    if tallied <= threshold:
        return sel, tallied, None
    msgs, offsets = _compose_selected(cblock, sel, prefix_commit, prefix_nil, suffix)
    pub_rows, sig_rows = pub_col[sel], cblock.sig[sel]
    cols = _fill_ram(msgs, offsets, pub_rows, sig_rows) if ram else None
    hi, lo, counts = cols if cols is not None else (None, None, None)
    return sel, tallied, EntryBlock(pub_rows, sig_rows, msgs, offsets, ram_hi=hi, ram_lo=lo,
                                    ram_counts=counts)
