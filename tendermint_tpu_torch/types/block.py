"""Version, PartSetHeader, BlockID, Header, CommitSig, Commit,
AggregatedCommit and SignedHeader.

Counterpart: tendermint_tpu/types/block.py (types/block.go). What commit
and light-client header verification need: the proto encode/decode of
these types, their validate_basic checks, the header's 14-leaf Merkle
hash (memoized on the frozen Header), and the canonical vote sign-bytes
of a commit's signatures. A commit decoded from its wire bytes holds its
signatures as columns (ops/entry_block.CommitBlock) behind a lazy list
view (CommitSigs); a commit built from CommitSig objects holds a plain
list, and commit_block() builds its columns afresh at every call.
"""

from __future__ import annotations

from collections.abc import MutableSequence
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..crypto import merkle, tmhash
from ..ops import host
from ..ops.entry_block import CommitBlock
from ..wire import canonical as _canon
from ..wire.canonical import GO_ZERO_TIME_SECONDS, Timestamp
from ..wire.proto import (
    WT_BYTES,
    WT_VARINT,
    ProtoWriter,
    decode_message,
    field_bytes,
    field_int,
    field_repeated_bytes,
    iter_fields,
    to_signed32,
    to_signed64,
)

BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3

MAX_SIGNATURE_SIZE = 64  # ed25519 and sr25519 (types/vote.go:24)


def cdc_encode_string(s: str) -> bytes:
    """gogotypes.StringValue of s, b"" for the empty string
    (types/encoding_helper.go): a leaf of the header's hash."""
    if not s:
        return b""
    w = ProtoWriter()
    w.write_string(1, s)
    return w.bytes()


def cdc_encode_int64(v: int) -> bytes:
    if not v:
        return b""
    w = ProtoWriter()
    w.write_varint(1, v)
    return w.bytes()


def cdc_encode_bytes(b: bytes) -> bytes:
    if not b:
        return b""
    w = ProtoWriter()
    w.write_bytes(1, b)
    return w.bytes()


def _decode_timestamp(data: bytes) -> Timestamp:
    f = decode_message(data)
    return Timestamp(
        seconds=to_signed64(field_int(f, 1)),
        nanos=to_signed32(field_int(f, 2)),
    )


@dataclass(frozen=True)
class Version:
    """Consensus version (proto/tendermint/version)."""

    block: int = 11  # version.BlockProtocol (version/version.go:25)
    app: int = 0

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.write_varint(1, self.block)
        w.write_varint(2, self.app)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Version":
        f = decode_message(data)
        return cls(block=field_int(f, 1), app=field_int(f, 2))


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.write_varint(1, self.total)
        w.write_bytes(2, self.hash)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "PartSetHeader":
        f = decode_message(data)
        return cls(total=field_int(f, 1), hash=field_bytes(f, 2))

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError("wrong PartSetHeader hash size")


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        return not self.hash and self.part_set_header.is_zero()

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.write_bytes(1, self.hash)
        w.write_message(2, self.part_set_header.encode(), always=True)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "BlockID":
        f = decode_message(data)
        return cls(
            hash=field_bytes(f, 1),
            part_set_header=PartSetHeader.decode(field_bytes(f, 2)),
        )

    def canonical(self) -> Optional[_canon.CanonicalBlockID]:
        """types/canonical.go CanonicalizeBlockID: None for the zero ID."""
        if self.is_zero():
            return None
        return _canon.CanonicalBlockID(
            hash=self.hash,
            part_set_header=_canon.CanonicalPartSetHeader(
                total=self.part_set_header.total,
                hash=self.part_set_header.hash,
            ),
        )

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError("wrong BlockID hash size")
        self.part_set_header.validate_basic()


@dataclass(frozen=True)
class Header:
    """types/block.go:370-412."""

    version: Version = field(default_factory=Version)
    chain_id: str = ""
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""
    # the memoized hash: the class is frozen, and init=False makes
    # dataclasses.replace() start a copy without it
    _hash_memo: Optional[bytes] = field(default=None, init=False, repr=False,
                                        compare=False)

    def hash(self) -> bytes:
        """Merkle root of the 14 proto-encoded fields (types/block.go:
        448-483); b"" (Go's nil) for a header without validators_hash."""
        if not self.validators_hash:
            return b""
        h = self._hash_memo
        if h is None:
            h = merkle.hash_from_byte_slices([
                self.version.encode(),
                cdc_encode_string(self.chain_id),
                cdc_encode_int64(self.height),
                _canon.encode_timestamp(self.time),
                self.last_block_id.encode(),
                cdc_encode_bytes(self.last_commit_hash),
                cdc_encode_bytes(self.data_hash),
                cdc_encode_bytes(self.validators_hash),
                cdc_encode_bytes(self.next_validators_hash),
                cdc_encode_bytes(self.consensus_hash),
                cdc_encode_bytes(self.app_hash),
                cdc_encode_bytes(self.last_results_hash),
                cdc_encode_bytes(self.evidence_hash),
                cdc_encode_bytes(self.proposer_address),
            ])
            object.__setattr__(self, "_hash_memo", h)
        return h

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.write_message(1, self.version.encode(), always=True)
        w.write_string(2, self.chain_id)
        w.write_varint(3, self.height)
        w.write_message(4, _canon.encode_timestamp(self.time), always=True)
        w.write_message(5, self.last_block_id.encode(), always=True)
        w.write_bytes(6, self.last_commit_hash)
        w.write_bytes(7, self.data_hash)
        w.write_bytes(8, self.validators_hash)
        w.write_bytes(9, self.next_validators_hash)
        w.write_bytes(10, self.consensus_hash)
        w.write_bytes(11, self.app_hash)
        w.write_bytes(12, self.last_results_hash)
        w.write_bytes(13, self.evidence_hash)
        w.write_bytes(14, self.proposer_address)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Header":
        f = decode_message(data)
        return cls(
            version=Version.decode(field_bytes(f, 1)),
            chain_id=field_bytes(f, 2).decode("utf-8"),
            height=to_signed64(field_int(f, 3)),
            time=_decode_timestamp(field_bytes(f, 4)),
            last_block_id=BlockID.decode(field_bytes(f, 5)),
            last_commit_hash=field_bytes(f, 6),
            data_hash=field_bytes(f, 7),
            validators_hash=field_bytes(f, 8),
            next_validators_hash=field_bytes(f, 9),
            consensus_hash=field_bytes(f, 10),
            app_hash=field_bytes(f, 11),
            last_results_hash=field_bytes(f, 12),
            evidence_hash=field_bytes(f, 13),
            proposer_address=field_bytes(f, 14),
        )

    def validate_basic(self) -> None:
        """types/block.go:413-446."""
        if len(self.chain_id) > 50:
            raise ValueError("chain_id is too long")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.height == 0:
            raise ValueError("zero Height")
        self.last_block_id.validate_basic()
        for name, h in (
            ("last_commit_hash", self.last_commit_hash),
            ("data_hash", self.data_hash),
            ("evidence_hash", self.evidence_hash),
            ("last_results_hash", self.last_results_hash),
            ("validators_hash", self.validators_hash),
            ("next_validators_hash", self.next_validators_hash),
            ("consensus_hash", self.consensus_hash),
        ):
            if h and len(h) != tmhash.SIZE:
                raise ValueError(f"wrong {name} size")
        if self.proposer_address and len(self.proposer_address) != tmhash.TRUNCATED_SIZE:
            raise ValueError("invalid proposer_address size")


@dataclass(frozen=True)
class CommitSig:
    """types/block.go:590-700."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Timestamp = field(default_factory=Timestamp.zero)
    signature: bytes = b""

    def for_block(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def is_absent(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.write_varint(1, self.block_id_flag)
        w.write_bytes(2, self.validator_address)
        w.write_message(3, _canon.encode_timestamp(self.timestamp), always=True)
        w.write_bytes(4, self.signature)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "CommitSig":
        f = decode_message(data)
        return cls(
            block_id_flag=field_int(f, 1),
            validator_address=field_bytes(f, 2),
            timestamp=_decode_timestamp(field_bytes(f, 3)),
            signature=field_bytes(f, 4),
        )

    def validate_basic(self) -> None:
        """types/block.go:702-741."""
        if self.block_id_flag not in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT,
                                      BLOCK_ID_FLAG_NIL):
            raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address:
                raise ValueError("validator address is present for absent CommitSig")
            if not self.timestamp.is_zero():
                raise ValueError("time is present for absent CommitSig")
            if self.signature:
                raise ValueError("signature is present for absent CommitSig")
        else:
            if len(self.validator_address) != tmhash.TRUNCATED_SIZE:
                raise ValueError("expected ValidatorAddress size")
            if not self.signature:
                raise ValueError("signature is missing")
            if len(self.signature) > MAX_SIGNATURE_SIZE:
                raise ValueError("signature is too big")


class CommitSigs(MutableSequence):
    """`commit.signatures` backed by a columnar CommitBlock
    (ops/entry_block.py): the columns are the source of truth from wire
    decode onward, and CommitSig OBJECTS are materialized lazily, one per
    accessed index, as views over them. The verify hot path
    (types/validation.py fused branch) reads the columns directly and
    never triggers materialization.

    Mutation (setitem/delitem/insert) first materializes every lane into
    a plain object list and DETACHES the columns — the mutated list is
    then the truth and the owning Commit rebuilds its block on demand —
    so list semantics (including the tests' in-place signature tampering)
    are preserved exactly."""

    __slots__ = ("_block", "_items", "_full")

    def __init__(self, block: CommitBlock):
        self._block = block
        self._items: list = [None] * len(block)
        self._full = False  # every lane materialized

    def _materialize(self, i: int) -> CommitSig:
        cs = self._items[i]
        if cs is None:
            b = self._block
            flag = int(b.flags[i])
            if flag == BLOCK_ID_FLAG_ABSENT:
                cs = CommitSig(block_id_flag=flag)
            else:
                cs = CommitSig(
                    block_id_flag=flag,
                    validator_address=b.addr[i].tobytes(),
                    timestamp=Timestamp(int(b.ts_seconds[i]), int(b.ts_nanos[i])),
                    signature=b.sig[i].tobytes(),
                )
            self._items[i] = cs
        return cs

    def _materialize_all(self) -> None:
        if not self._full:
            for i in range(len(self._items)):
                self._materialize(i)
            self._full = True

    def _detach(self) -> None:
        """Materialize everything and drop the columns (mutation path)."""
        self._materialize_all()
        self._block = None

    def block(self) -> Optional[CommitBlock]:
        """The backing CommitBlock, or None once mutated."""
        return self._block

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._materialize(j) for j in range(*i.indices(len(self._items)))]
        if self._items[i] is None:  # also validates the index
            return self._materialize(i + len(self._items) if i < 0 else i)
        return self._items[i]

    def __iter__(self):
        # one pass materializes every lane; the object path then walks a
        # plain list instead of calling __getitem__ per index
        self._materialize_all()
        return iter(self._items)

    def __setitem__(self, i, value) -> None:
        self._detach()
        self._items[i] = value

    def __delitem__(self, i) -> None:
        self._detach()
        del self._items[i]

    def insert(self, i, value) -> None:
        self._detach()
        self._items.insert(i, value)

    def __eq__(self, other) -> bool:
        if isinstance(other, (CommitSigs, list)):
            return list(self) == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return repr(list(self))


_ZERO64 = bytes(64)
_ZERO20 = bytes(20)


def _commit_sig_columns(sigs) -> Optional[CommitBlock]:
    """Build a CommitBlock from CommitSig objects — the path for commits
    assembled in-process. Returns None when any lane deviates from the
    canonical shape (wrong-size address or signature, unknown flag,
    absent lane with data): those commits keep the object path and its
    exact error behavior."""
    n = len(sigs)
    if n == 0:
        return None
    flags = []
    sig_chunks = []
    addr_chunks = []
    secs = []
    nanos = []
    for cs in sigs:
        f = cs.block_id_flag
        if f == BLOCK_ID_FLAG_ABSENT:
            if cs.validator_address or cs.signature or not cs.timestamp.is_zero():
                return None
            sig_chunks.append(_ZERO64)
            addr_chunks.append(_ZERO20)
        elif f in (BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL):
            if len(cs.validator_address) != 20 or len(cs.signature) != 64:
                return None
            sig_chunks.append(cs.signature)
            addr_chunks.append(cs.validator_address)
        else:
            return None
        flags.append(f)
        secs.append(cs.timestamp.seconds)
        nanos.append(cs.timestamp.nanos)
    return CommitBlock(
        flags=np.array(flags, dtype=np.uint8),
        val_idx=np.arange(n, dtype=np.int32),
        sig=np.frombuffer(b"".join(sig_chunks), dtype=np.uint8).reshape(n, 64),
        ts_seconds=np.array(secs, dtype=np.int64),
        ts_nanos=np.array(nanos, dtype=np.int32),
        addr=np.frombuffer(b"".join(addr_chunks), dtype=np.uint8).reshape(n, 20),
    )


class _NonCanonical(Exception):
    """Wire record deviates from the canonical CommitSig shape."""


def _decode_sig_record(raw: bytes) -> tuple:
    """One CommitSig wire record -> (flag, addr, secs, nanos, sig),
    canonical-shape-checked. Raises _NonCanonical on ANY deviation
    (unknown/duplicate fields, wrong wire types, non-canonical lane
    shape) — the caller falls back to CommitSig.decode per record, which
    reproduces the object path's exact tolerance and errors."""
    flag = 0
    addr = b""
    sig = b""
    ts_raw = None
    seen = 0
    for f, wt, val in iter_fields(raw):
        bit = 1 << f
        if seen & bit:
            raise _NonCanonical
        seen |= bit
        if f == 1 and wt == WT_VARINT:
            flag = val
        elif f == 2 and wt == WT_BYTES:
            addr = val
        elif f == 3 and wt == WT_BYTES:
            ts_raw = val
        elif f == 4 and wt == WT_BYTES:
            sig = val
        else:
            raise _NonCanonical
    secs = 0
    nanos = 0
    if ts_raw is not None:
        seen_ts = 0
        for f, wt, val in iter_fields(ts_raw):
            if wt != WT_VARINT or f not in (1, 2) or seen_ts & (1 << f):
                raise _NonCanonical
            seen_ts |= 1 << f
            if f == 1:
                secs = to_signed64(val)
            else:
                nanos = to_signed32(val)
    if flag == BLOCK_ID_FLAG_ABSENT:
        if addr or sig or secs != GO_ZERO_TIME_SECONDS or nanos != 0:
            raise _NonCanonical
    elif flag in (BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL):
        if len(addr) != 20 or len(sig) != 64:
            raise _NonCanonical
    else:
        raise _NonCanonical
    return flag, addr, secs, nanos, sig


def _decode_commit_sigs(raws: List[bytes]):
    """Decode a commit's signature records COLUMNAR-FIRST: one pass fills
    CommitBlock columns and the result is a lazy CommitSigs view. Any
    non-canonical record falls the whole commit back to plain CommitSig
    objects (identical to the pre-columnar decode)."""
    n = len(raws)
    if n == 0:
        return []
    try:
        rows = [_decode_sig_record(raw) for raw in raws]
    except (_NonCanonical, ValueError):
        return [CommitSig.decode(raw) for raw in raws]
    return CommitSigs(CommitBlock(
        flags=np.fromiter((r[0] for r in rows), dtype=np.uint8, count=n),
        val_idx=np.arange(n, dtype=np.int32),
        sig=np.frombuffer(b"".join(r[4] or _ZERO64 for r in rows),
                          dtype=np.uint8).reshape(n, 64),
        ts_seconds=np.fromiter((r[2] for r in rows), dtype=np.int64, count=n),
        ts_nanos=np.fromiter((r[3] for r in rows), dtype=np.int32, count=n),
        addr=np.frombuffer(b"".join(r[1] or _ZERO20 for r in rows),
                           dtype=np.uint8).reshape(n, 20),
    ))


@dataclass
class Commit:
    """types/block.go:744-830."""

    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    signatures: List[CommitSig] = field(default_factory=list)

    def sign_bytes_template(self, chain_id: str, flag: int) -> tuple:
        """(prefix, suffix) canonical-vote template of a BlockIDFlag: the
        vote's BlockID is the commit's for COMMIT, the zero BlockID for
        ABSENT and NIL."""
        if flag == BLOCK_ID_FLAG_COMMIT:
            bid = self.block_id
        elif flag in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_NIL):
            bid = BlockID()
        else:
            raise ValueError(f"unknown BlockIDFlag: {flag}")
        return _canon.canonical_vote_template(
            chain_id=chain_id,
            msg_type=_canon.SIGNED_MSG_TYPE_PRECOMMIT,
            height=self.height,
            round_=self.round,
            block_id=bid.canonical(),
        )

    def hash(self) -> bytes:
        """Merkle root of the CommitSigs' encodings (types/block.go
        Commit.Hash). Not kept: a plain list of signatures can change
        under the commit."""
        return merkle.hash_from_byte_slices([cs.encode() for cs in self.signatures])

    def vote_sign_bytes(self, chain_id: str, idx: int) -> bytes:
        """Canonical sign bytes of the vote at idx (types/block.go:816-819)."""
        cs = self.signatures[idx]
        tpl = self.sign_bytes_template(chain_id, cs.block_id_flag)
        return _canon.compose_vote_sign_bytes(tpl, cs.timestamp)

    def commit_block(self) -> Optional[CommitBlock]:
        """The commit's columnar CommitBlock (ops/entry_block.py), or
        None when the signatures deviate from the canonical shape.

        Wire-decoded commits carry their block from decode (the
        signatures list is a lazy CommitSigs view over it — zero cost
        here, and mutating the view detaches it, so the columns can
        never go stale). Commits assembled from objects in-process
        build columns FRESH on every call — deliberately uncached:
        `commit.signatures[i] = ...` on a plain list has no hook, so a
        cache here would let a mutated (tampered) signature verify
        against the pre-mutation bytes."""
        sigs = self.signatures
        if isinstance(sigs, CommitSigs):
            blk = sigs.block()
            if blk is not None:
                return blk
        return _commit_sig_columns(sigs)

    def vote_sign_bytes_block(self, chain_id: str, idxs) -> tuple:
        """The sign bytes of the votes at idxs in ONE buffer + an
        (len(idxs)+1,) int64 offset table (the EntryBlock msgs form), by
        the host library's composer when every vote has one flag."""
        idxs = list(idxs)
        n = len(idxs)
        if n == 0:
            return b"", np.zeros(1, dtype=np.int64)
        sigs = list(self.signatures)
        flag = sigs[idxs[0]].block_id_flag
        if all(sigs[i].block_id_flag == flag for i in idxs):
            prefix, suffix = self.sign_bytes_template(chain_id, flag)
            times = np.array([(sigs[i].timestamp.seconds, sigs[i].timestamp.nanos)
                              for i in idxs], dtype=np.int64)
            return host.vote_sign_bytes_batch_buf(prefix, suffix, times)
        # mixed BlockIDFlags (never one commit's for-block set, but the
        # API allows it): per-index compose, one join
        chunks = [self.vote_sign_bytes(chain_id, i) for i in idxs]
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(c) for c in chunks], out=offsets[1:])
        return b"".join(chunks), offsets

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.write_varint(1, self.height)
        w.write_varint(2, self.round)
        w.write_message(3, self.block_id.encode(), always=True)
        for cs in self.signatures:
            w.write_message(4, cs.encode(), always=True)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Commit":
        """Columnar-from-decode: canonical-shaped signature records parse
        straight into CommitBlock columns (one pass, no CommitSig or
        Timestamp objects); `signatures` is a lazy view over them. A
        non-canonical commit decodes to plain objects."""
        f = decode_message(data)
        return cls(
            height=to_signed64(field_int(f, 1)),
            round=to_signed32(field_int(f, 2)),
            block_id=BlockID.decode(field_bytes(f, 3)),
            signatures=_decode_commit_sigs(field_repeated_bytes(f, 4)),
        )

    def validate_basic(self) -> None:
        """types/block.go:779-800. The columns of a commit decoded from
        its wire bytes passed _decode_sig_record, which is stricter than
        CommitSig.validate_basic, so they stand in for the loop over
        10,000 CommitSig objects; any other commit runs the loop."""
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.height >= 1:
            if self.block_id.is_zero():
                raise ValueError("commit cannot be for nil block")
            sigs = self.signatures
            if not sigs:
                raise ValueError("no signatures in commit")
            if isinstance(sigs, CommitSigs) and sigs.block() is not None:
                return
            for i, cs in enumerate(sigs):
                try:
                    cs.validate_basic()
                except ValueError as e:
                    raise ValueError(f"wrong CommitSig #{i}: {e}") from e


BLS_AGG_SIGNATURE_SIZE = 96  # a compressed G2 point (minimal-pubkey BLS12-381)


@dataclass
class AggregatedCommit:
    """A BLS12-381 aggregated commit (reference types/block.py:815-900):
    the committee's precommit signatures collapse into one compressed G2
    aggregate and a signer bitmap, 96 bytes and ceil(V/8) on the wire.
    Every signer signs the same canonical precommit, with the zero
    timestamp, which is what lets the signatures aggregate.

    Wire framing (the JAX package's extension; upstream has no such
    message): 1 height (varint), 2 round (varint), 3 block_id (message),
    4 signature (bytes), 5 signers (BitArray message)."""

    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    signature: bytes = b""
    signers: Optional["BitArray"] = None  # libs/bits.BitArray

    def sign_bytes(self, chain_id: str) -> bytes:
        """The one message every signer signed: the canonical precommit
        with the zero timestamp."""
        tpl = _canon.canonical_vote_template(
            chain_id=chain_id,
            msg_type=_canon.SIGNED_MSG_TYPE_PRECOMMIT,
            height=self.height,
            round_=self.round,
            block_id=self.block_id.canonical(),
        )
        return _canon.compose_vote_sign_bytes(tpl, Timestamp.zero())

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.write_varint(1, self.height)
        w.write_varint(2, self.round)
        w.write_message(3, self.block_id.encode(), always=True)
        w.write_bytes(4, self.signature)
        if self.signers is not None:
            w.write_message(5, self.signers.encode(), always=True)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "AggregatedCommit":
        from ..libs.bits import BitArray

        f = decode_message(data)
        signers = BitArray.decode(field_bytes(f, 5)) if 5 in f else None
        return cls(
            height=to_signed64(field_int(f, 1)),
            round=to_signed32(field_int(f, 2)),
            block_id=BlockID.decode(field_bytes(f, 3)),
            signature=field_bytes(f, 4),
            signers=signers,
        )

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.height >= 1:
            if self.block_id.is_zero():
                raise ValueError("commit cannot be for nil block")
            if len(self.signature) != BLS_AGG_SIGNATURE_SIZE:
                raise ValueError(
                    f"aggregate signature is {len(self.signature)} bytes, want "
                    f"{BLS_AGG_SIGNATURE_SIZE}"
                )
            if self.signers is None or self.signers.size() == 0:
                raise ValueError("no signer bitmap in aggregated commit")


@dataclass(frozen=True)
class SignedHeader:
    """Header + the commit that signed it (types/block.go:833-890)."""

    header: Optional[Header] = None
    commit: Optional[Commit] = None

    def validate_basic(self, chain_id: str) -> None:
        if self.header is None:
            raise ValueError("missing header")
        if self.commit is None:
            raise ValueError("missing commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise ValueError(
                f"header belongs to another chain {self.header.chain_id!r}, not {chain_id!r}"
            )
        if self.header.height != self.commit.height:
            raise ValueError("header and commit height mismatch")
        if self.header.hash() != self.commit.block_id.hash:
            raise ValueError("commit signs a header other than this one")
