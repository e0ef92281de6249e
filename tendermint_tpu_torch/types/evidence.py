"""Light-client attack evidence.

Counterpart: tendermint_tpu/types/evidence.py (types/evidence.go):
LightBlockData and LightClientAttackEvidence, the evidence the light
client's divergence detector builds (light/client.make_attack_evidence),
with their wire forms (proto/tendermint/types/evidence.pb.go) and hash.
DuplicateVoteEvidence, the ABCI conversion and the evidence list wait
for the port's evidence pool.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..crypto import tmhash
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
from .block import Commit, Header
from .validator_set import Validator, ValidatorSet


@dataclass
class LightBlockData:
    """A SignedHeader and its ValidatorSet in wire form (the types.LightBlock
    wire subset)."""

    signed_header_raw: bytes  # SignedHeader {1 header, 2 commit}
    validator_set_raw: bytes  # ValidatorSet

    def header(self) -> Header:
        return Header.decode(field_bytes(decode_message(self.signed_header_raw), 1))

    def commit(self) -> Commit:
        return Commit.decode(field_bytes(decode_message(self.signed_header_raw), 2))

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet.decode(self.validator_set_raw)

    @classmethod
    def from_parts(cls, signed_header, validator_set) -> "LightBlockData":
        """The wire form of a (SignedHeader, ValidatorSet) pair, as the
        detector captures a conflicting block (detector.go:406)."""
        w = ProtoWriter()
        w.write_message(1, signed_header.header.encode(), always=True)
        w.write_message(2, signed_header.commit.encode(), always=True)
        return cls(signed_header_raw=w.bytes(), validator_set_raw=validator_set.encode())


@dataclass
class LightClientAttackEvidence:
    """types/evidence.go:200-248."""

    conflicting_block: LightBlockData
    common_height: int
    byzantine_validators: List[Validator] = field(default_factory=list)
    total_voting_power: int = 0
    timestamp: Timestamp = field(default_factory=Timestamp.zero)

    def height(self) -> int:
        return self.common_height

    def time(self) -> Timestamp:
        return self.timestamp

    def bytes(self) -> bytes:
        return self.encode()

    def hash(self) -> bytes:
        """evidence.go:309-318: the hash of (the conflicting header's hash,
        the common height)."""
        w = ProtoWriter()
        w.write_bytes(1, self.conflicting_block.header().hash())
        w.write_varint(2, self.common_height)
        return tmhash.sum_sha256(w.bytes())

    def get_byzantine_validators(self, common_vals: ValidatorSet, trusted) -> List[Validator]:
        """evidence.go GetByzantineValidators: a lunatic attack blames the
        common set's validators that signed the conflicting header; an
        equivocation (same round) those that signed both blocks; amnesia
        (different rounds) nobody. `trusted` is the SignedHeader at the
        conflicting height. make_attack_evidence fills the evidence's
        byzantine_validators with it."""
        out: List[Validator] = []
        commit = self.conflicting_block.commit()
        if self.conflicting_header_is_invalid(trusted.header):
            for cs in commit.signatures:
                if not cs.for_block():
                    continue
                _, val = common_vals.get_by_address(cs.validator_address)
                if val is not None:
                    out.append(val)
            return out
        if trusted.commit.round == commit.round:
            vals = self.conflicting_block.validator_set()
            for i, sig_a in enumerate(commit.signatures):
                if not sig_a.for_block() or i >= len(trusted.commit.signatures):
                    continue
                if not trusted.commit.signatures[i].for_block():
                    continue
                _, val = vals.get_by_address(sig_a.validator_address)
                if val is not None:
                    out.append(val)
        return out

    def conflicting_header_is_invalid(self, trusted_header: Header) -> bool:
        """evidence.go ConflictingHeaderIsInvalid: a lunatic header forges
        one of the hashes the state machine determines."""
        ch = self.conflicting_block.header()
        return not (
            trusted_header.validators_hash == ch.validators_hash
            and trusted_header.next_validators_hash == ch.next_validators_hash
            and trusted_header.consensus_hash == ch.consensus_hash
            and trusted_header.app_hash == ch.app_hash
            and trusted_header.last_results_hash == ch.last_results_hash
        )

    def validate_basic(self) -> None:
        if self.conflicting_block is None:
            raise ValueError("conflicting block is nil")
        if self.common_height <= 0:
            raise ValueError("negative or zero common height")
        self.conflicting_block.header()  # must parse

    def encode(self) -> bytes:
        lb = ProtoWriter()
        lb.write_message(1, self.conflicting_block.signed_header_raw, always=True)
        lb.write_message(2, self.conflicting_block.validator_set_raw, always=True)
        w = ProtoWriter()
        w.write_message(1, lb.bytes(), always=True)
        w.write_varint(2, self.common_height)
        for v in self.byzantine_validators:
            w.write_message(3, v.encode(), always=True)
        w.write_varint(4, self.total_voting_power)
        w.write_message(5, _canon.encode_timestamp(self.timestamp), always=True)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "LightClientAttackEvidence":
        f = decode_message(data)
        lb = decode_message(field_bytes(f, 1))
        ts = decode_message(field_bytes(f, 5))
        return cls(
            conflicting_block=LightBlockData(
                signed_header_raw=field_bytes(lb, 1),
                validator_set_raw=field_bytes(lb, 2),
            ),
            common_height=to_signed64(field_int(f, 2)),
            byzantine_validators=[Validator.decode(raw) for raw in field_repeated_bytes(f, 3)],
            total_voting_power=to_signed64(field_int(f, 4)),
            timestamp=Timestamp(seconds=to_signed64(field_int(ts, 1)),
                                nanos=to_signed32(field_int(ts, 2))),
        )
