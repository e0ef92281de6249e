"""Canonical vote sign-bytes.

Counterpart: tendermint_tpu/wire/canonical.py (types/canonical.go and the
generated marshalers of canonical.pb.go). The bytes built here are what
validators sign; they match the reference bit for bit.

  CanonicalVote:    1 type(varint) 2 height(sfixed64) 3 round(sfixed64)
                    4 block_id(msg, nil-omitted) 5 timestamp(msg, ALWAYS)
                    6 chain_id(string)
  CanonicalBlockID: 1 hash(bytes) 2 part_set_header(msg, ALWAYS)
  CanonicalPartSetHeader: 1 total(varint) 2 hash(bytes)
  Timestamp:        1 seconds(varint int64) 2 nanos(varint int32)

The whole message is uvarint length-prefixed (types/vote.go:93-95).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .proto import ProtoWriter, marshal_delimited

SIGNED_MSG_TYPE_PRECOMMIT = 2

# Go's zero time.Time (0001-01-01T00:00:00Z) as a proto Timestamp.
GO_ZERO_TIME_SECONDS = -62135596800


class Timestamp(NamedTuple):
    """google.protobuf.Timestamp; Go's zero time is the zero() value."""

    seconds: int = GO_ZERO_TIME_SECONDS
    nanos: int = 0

    @classmethod
    def zero(cls) -> "Timestamp":
        return cls(GO_ZERO_TIME_SECONDS, 0)

    def is_zero(self) -> bool:
        return self.seconds == GO_ZERO_TIME_SECONDS and self.nanos == 0


def encode_timestamp(ts: Timestamp) -> bytes:
    w = ProtoWriter()
    w.write_varint(1, ts.seconds)
    w.write_varint(2, ts.nanos)
    return w.bytes()


class CanonicalPartSetHeader(NamedTuple):
    total: int
    hash: bytes


class CanonicalBlockID(NamedTuple):
    hash: bytes
    part_set_header: CanonicalPartSetHeader


def encode_canonical_block_id(bid: CanonicalBlockID) -> bytes:
    psh = ProtoWriter()
    psh.write_varint(1, bid.part_set_header.total)
    psh.write_bytes(2, bid.part_set_header.hash)
    w = ProtoWriter()
    w.write_bytes(1, bid.hash)
    w.write_message(2, psh.bytes(), always=True)
    return w.bytes()


def canonical_vote_template(
    chain_id: str,
    msg_type: int,
    height: int,
    round_: int,
    block_id: Optional[CanonicalBlockID],
) -> tuple:
    """(prefix = fields 1-4, suffix = field 6) of a CanonicalVote: the
    timestamp (field 5) is the only per-signature field of a commit."""
    w = ProtoWriter()
    w.write_varint(1, msg_type)
    w.write_sfixed64(2, height)
    w.write_sfixed64(3, round_)
    if block_id is not None:
        w.write_message(4, encode_canonical_block_id(block_id), always=True)
    w2 = ProtoWriter()
    w2.write_string(6, chain_id)
    return w.bytes(), w2.bytes()


def compose_vote_sign_bytes(tpl: tuple, timestamp: Timestamp) -> bytes:
    prefix, suffix = tpl
    w = ProtoWriter()
    w.write_message(5, encode_timestamp(timestamp), always=True)
    return marshal_delimited(prefix + w.bytes() + suffix)


def _uvarint_len(v: np.ndarray) -> np.ndarray:
    """(n,) uint64 -> per-value uvarint byte length."""
    length = np.ones(v.shape, dtype=np.int64)
    for k in range(1, 10):
        length += v >= np.uint64(1 << (7 * k))
    return length


def compose_vote_sign_bytes_block(tpl: tuple, timestamps) -> tuple:
    """compose_vote_sign_bytes for many timestamps into ONE buffer:
    (buf, offsets) with buf[offsets[i]:offsets[i+1]] the i-th vote's sign
    bytes — the EntryBlock msgs form (ops/entry_block.py)."""
    n = len(timestamps)
    secs = np.fromiter((ts.seconds for ts in timestamps), dtype=np.int64,
                       count=n)
    nanos = np.fromiter((ts.nanos for ts in timestamps), dtype=np.int64,
                        count=n)
    return compose_vote_sign_bytes_cols(tpl, secs, nanos)


def compose_vote_sign_bytes_cols(tpl: tuple, secs_col, nanos_col) -> tuple:
    """(seconds (n,), nanos (n,)) columns -> (buf, offsets), byte-identical
    to the per-call composer. Records differ only in the two timestamp
    varints, so rows group by their (seconds-length, nanos-length) layout
    and each group is filled as one (rows, record) matrix."""
    prefix, suffix = tpl
    n = len(secs_col)
    offsets = np.zeros(n + 1, dtype=np.int64)
    if n == 0:
        return b"", offsets
    secs = np.ascontiguousarray(secs_col, dtype=np.int64).view(np.uint64)
    nanos = np.ascontiguousarray(nanos_col, dtype=np.int64).view(np.uint64)
    # per-row field layout: length 0 = field omitted (proto3 zero-skip)
    s_len = np.where(secs != 0, _uvarint_len(secs), 0)
    n_len = np.where(nanos != 0, _uvarint_len(nanos), 0)
    tn = (s_len != 0) * (1 + s_len) + (n_len != 0) * (1 + n_len)
    p_len = len(prefix)
    body_len = p_len + 2 + tn + len(suffix)  # 0x2a + 1-byte uvarint(tn)
    hdr_len = _uvarint_len(body_len.view(np.uint64))
    rec_len = hdr_len + body_len
    np.cumsum(rec_len, out=offsets[1:])
    pre_arr = np.frombuffer(prefix, dtype=np.uint8)
    suf_arr = np.frombuffer(suffix, dtype=np.uint8)

    def fill_varint(dst, col, v, width):
        for j in range(width):
            b = (v >> np.uint64(7 * j)) & np.uint64(0x7F)
            if j < width - 1:
                b = b | np.uint64(0x80)
            dst[:, col + j] = b
        return col + width

    def fill_group(rows):
        i0 = rows[0]
        sl, nl, hl = int(s_len[i0]), int(n_len[i0]), int(hdr_len[i0])
        arr = np.empty((len(rows), int(rec_len[i0])), dtype=np.uint8)
        col = fill_varint(arr, 0, np.uint64(body_len[i0]), hl)
        arr[:, col : col + p_len] = pre_arr
        col += p_len
        arr[:, col] = 0x2A
        arr[:, col + 1] = tn[i0]
        col += 2
        if sl:
            arr[:, col] = 0x08
            col = fill_varint(arr, col + 1, secs[rows], sl)
        if nl:
            arr[:, col] = 0x10
            col = fill_varint(arr, col + 1, nanos[rows], nl)
        arr[:, col:] = suf_arr
        return arr

    key = (s_len * 1024 + n_len * 16 + hdr_len).astype(np.int64)
    uniq = np.unique(key)
    if uniq.size == 1:
        return fill_group(np.arange(n)).tobytes(), offsets
    out = np.zeros(int(offsets[-1]), dtype=np.uint8)
    for k in uniq:
        rows = np.nonzero(key == k)[0]
        arr = fill_group(rows)
        out[offsets[rows][:, None] + np.arange(arr.shape[1])] = arr
    return out.tobytes(), offsets
