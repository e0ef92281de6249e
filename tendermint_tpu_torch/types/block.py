"""PartSetHeader, BlockID, CommitSig and Commit.

Counterpart: tendermint_tpu/types/block.py (types/block.go). Only what
commit verification needs: the proto encode/decode of these types and
the canonical vote sign-bytes of a commit's signatures. `signatures` is
a plain list of CommitSig.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..wire import canonical as _canon
from ..wire.canonical import Timestamp
from ..wire.proto import (
    ProtoWriter,
    decode_message,
    field_bytes,
    field_int,
    field_repeated_bytes,
    to_signed32,
    to_signed64,
)

BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


def _decode_timestamp(data: bytes) -> Timestamp:
    f = decode_message(data)
    return Timestamp(
        seconds=to_signed64(field_int(f, 1)),
        nanos=to_signed32(field_int(f, 2)),
    )


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

    def vote_sign_bytes(self, chain_id: str, idx: int) -> bytes:
        """Canonical sign bytes of the vote at idx (types/block.go:816-819)."""
        cs = self.signatures[idx]
        tpl = self.sign_bytes_template(chain_id, cs.block_id_flag)
        return _canon.compose_vote_sign_bytes(tpl, cs.timestamp)

    def vote_sign_bytes_block(self, chain_id: str, idxs) -> tuple:
        """The sign bytes of the votes at idxs in ONE buffer + an
        (len(idxs)+1,) int64 offset table (the EntryBlock msgs form)."""
        idxs = list(idxs)
        n = len(idxs)
        if n == 0:
            return b"", np.zeros(1, dtype=np.int64)
        sigs = self.signatures
        flag = sigs[idxs[0]].block_id_flag
        if all(sigs[i].block_id_flag == flag for i in idxs):
            return _canon.compose_vote_sign_bytes_block(
                self.sign_bytes_template(chain_id, flag),
                [sigs[i].timestamp for i in idxs],
            )
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
        f = decode_message(data)
        return cls(
            height=to_signed64(field_int(f, 1)),
            round=to_signed32(field_int(f, 2)),
            block_id=BlockID.decode(field_bytes(f, 3)),
            signatures=[
                CommitSig.decode(raw) for raw in field_repeated_bytes(f, 4)
            ],
        )
