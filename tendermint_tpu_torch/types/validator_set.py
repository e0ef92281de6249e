"""Validator and ValidatorSet.

Counterpart: tendermint_tpu/types/validator_set.py (types/validator.go,
types/validator_set.go). What commit verification needs: construction
of a new set (with the reference's proposer-priority rotation, so the
proposer and the validator order match), proto encode/decode, size,
total voting power, the proposer, the set's hash (the epoch cache's key),
its ed25519 key column, and the lookups the light client's trusting
check makes (get_by_address, get_by_index). Integer operations follow
Go's int64 semantics (clipping adds, truncated division, safe_mul). The
port changes no set after it is built (there is no update path), so the
hash, the column and the address index are computed once per set and
kept; an update path must reset all three.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..crypto import PubKey
from ..crypto import bls12381 as _bls12381
from ..crypto import ed25519 as _ed25519
from ..crypto import secp256k1 as _secp256k1
from ..crypto import merkle
from ..crypto.encoding import pubkey_from_proto, pubkey_to_proto
from ..wire.proto import (
    ProtoWriter,
    decode_message,
    field_bytes,
    field_int,
    field_repeated_bytes,
    to_signed64,
)

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)

MAX_TOTAL_VOTING_POWER = INT64_MAX // 8  # validator_set.go:25
PRIORITY_WINDOW_SIZE_FACTOR = 2  # validator_set.go:30


def _clip64(v: int) -> int:
    return max(INT64_MIN, min(INT64_MAX, v))


def safe_mul(a: int, b: int) -> Tuple[int, bool]:
    """(a * b, False), or (0, True) when the product leaves int64."""
    v = a * b
    if v > INT64_MAX or v < INT64_MIN:
        return 0, True
    return v, False


def _go_div(a: int, b: int) -> int:
    """Go's truncated integer division (Python's // floors)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


@dataclass
class Validator:
    """types/validator.go:20-33."""

    address: bytes
    pub_key: PubKey
    voting_power: int
    proposer_priority: int = 0

    @classmethod
    def new(cls, pub_key: PubKey, voting_power: int) -> "Validator":
        return cls(pub_key.address(), pub_key, voting_power, 0)

    def copy(self) -> "Validator":
        return Validator(self.address, self.pub_key, self.voting_power,
                         self.proposer_priority)

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValueError("validator does not have a public key")
        if self.voting_power < 0:
            raise ValueError("validator has negative voting power")
        if len(self.address) != 20:
            raise ValueError("validator address is the wrong size")

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """validator.go:63-83: higher priority wins, ties to lower address."""
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise ValueError("cannot compare identical validators")

    def bytes(self) -> bytes:
        """SimpleValidator proto (validator.go:116-132), the leaf of the
        set's hash: 1 pub_key (message), 2 voting_power (varint)."""
        w = ProtoWriter()
        w.write_message(1, pubkey_to_proto(self.pub_key), always=True)
        w.write_varint(2, self.voting_power)
        return w.bytes()

    def encode(self) -> bytes:
        """Validator proto (validator.pb.go:88-91)."""
        w = ProtoWriter()
        w.write_bytes(1, self.address)
        w.write_message(2, pubkey_to_proto(self.pub_key), always=True)
        w.write_varint(3, self.voting_power)
        w.write_varint(4, self.proposer_priority)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Validator":
        f = decode_message(data)
        return cls(
            address=field_bytes(f, 1),
            pub_key=pubkey_from_proto(field_bytes(f, 2)),
            voting_power=to_signed64(field_int(f, 3)),
            proposer_priority=to_signed64(field_int(f, 4)),
        )


class ValidatorSet:
    """types/validator_set.go:51-60."""

    def __init__(self, validators: Optional[List[Validator]] = None,
                 proposer: Optional[Validator] = None):
        self.validators: List[Validator] = validators if validators is not None else []
        self.proposer: Optional[Validator] = proposer
        self._total_voting_power = 0
        self._hash: Optional[bytes] = None
        self._ed_cols = None
        self._secp_cols = None
        self._bls_cols = None
        self._by_addr: Optional[Dict[bytes, int]] = None

    @classmethod
    def new(cls, valz: Sequence[Validator]) -> "ValidatorSet":
        """NewValidatorSet (validator_set.go:70-81): validates the new
        validators, assigns their starting priorities, sorts the set by
        power and rotates the proposer once."""
        vals = cls()
        if not valz:
            return vals
        updates = sorted((v.copy() for v in valz), key=lambda v: v.address)
        for prev, u in zip([None] + updates, updates):
            if prev is not None and u.address == prev.address:
                raise ValueError(f"duplicate entry {u} in {updates}")
            if u.voting_power <= 0:
                raise ValueError(
                    f"voting power must be positive: {u.voting_power}"
                )
            if u.voting_power > MAX_TOTAL_VOTING_POWER:
                raise ValueError(
                    "to prevent clipping/overflow, voting power can't be "
                    f"higher than {MAX_TOTAL_VOTING_POWER}: {u.voting_power}"
                )
        tvp = sum(u.voting_power for u in updates)
        if tvp > MAX_TOTAL_VOTING_POWER:
            raise OverflowError(
                "total voting power of resulting valset exceeds max "
                f"{MAX_TOTAL_VOTING_POWER}"
            )
        # a new validator starts at -1.125 * the updated total power
        # (validator_set.go:473-489)
        for u in updates:
            u.proposer_priority = -(tvp + (tvp >> 3))
        vals.validators = updates
        vals._update_total_voting_power()
        vals._rescale_priorities(PRIORITY_WINDOW_SIZE_FACTOR * tvp)
        vals._shift_by_avg_proposer_priority()
        vals.validators.sort(key=lambda v: (-v.voting_power, v.address))
        vals.increment_proposer_priority(1)
        return vals

    def size(self) -> int:
        return len(self.validators)

    def get_by_address(self, address: bytes) -> Tuple[int, Optional[Validator]]:
        """(row, copy of the validator) of the first validator with this
        address, or (-1, None). The reference scans the set; the port
        keeps an address -> row dict, built on the first lookup."""
        if self._by_addr is None:
            index: Dict[bytes, int] = {}
            for i, v in enumerate(self.validators):
                index.setdefault(v.address, i)
            self._by_addr = index
        i = self._by_addr.get(address, -1)
        if i < 0:
            return -1, None
        return i, self.validators[i].copy()

    def get_by_index(self, index: int) -> Tuple[Optional[bytes], Optional[Validator]]:
        """(address, copy of the validator) at `index`, or (None, None)."""
        if index < 0 or index >= len(self.validators):
            return None, None
        v = self.validators[index]
        return v.address, v.copy()

    def total_voting_power(self) -> int:
        if self._total_voting_power == 0:
            self._update_total_voting_power()
        return self._total_voting_power

    def _update_total_voting_power(self) -> None:
        s = 0
        for v in self.validators:
            s = _clip64(s + v.voting_power)
            if s > MAX_TOTAL_VOTING_POWER:
                raise OverflowError(
                    f"total voting power exceeds max {MAX_TOTAL_VOTING_POWER}: {s}"
                )
        self._total_voting_power = s

    def get_proposer(self) -> Optional[Validator]:
        if not self.validators:
            return None
        if self.proposer is None:
            proposer = None
            for v in self.validators:
                if proposer is None:
                    proposer = v
                elif v.address != proposer.address:
                    proposer = proposer.compare_proposer_priority(v)
            self.proposer = proposer
        return self.proposer.copy()

    def hash(self) -> bytes:
        """Merkle root of the validators' SimpleValidator encodings
        (ValidatorSet.Hash in validator_set.go); it covers keys and powers only."""
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices(
                [v.bytes() for v in self.validators]
            )
        return self._hash

    def _columns(self, key_cls, size: int) -> tuple:
        """(pub (n, size) uint8, power (n,) int64) when every key is a
        key_cls, else ()."""
        vals = self.validators
        n = len(vals)
        if n and all(isinstance(v.pub_key, key_cls) for v in vals):
            pub_b = b"".join(v.pub_key.bytes() for v in vals)
            if len(pub_b) == size * n:
                return (
                    np.frombuffer(pub_b, dtype=np.uint8).reshape(n, size),
                    np.fromiter((v.voting_power for v in vals), dtype=np.int64, count=n),
                )
        return ()

    def ed25519_columns(self) -> Optional[tuple]:
        """(pub (n, 32) uint8, power (n,) int64) over the set, or None
        unless every key is ed25519: the commit path gathers its
        signatures' keys from here, and the epoch cache builds its table
        from the pub column."""
        if self._ed_cols is None:
            self._ed_cols = self._columns(_ed25519.PubKey, 32)
        return self._ed_cols or None

    def secp256k1_columns(self) -> Optional[tuple]:
        """(pub (n, 33) uint8, power (n,) int64) over the set, or None
        unless every key is secp256k1 (reference validator_set.py:305-337):
        the secp256k1 lane's counterpart of ed25519_columns, cached beside
        it (an update of the set must clear both, with the hash)."""
        if self._secp_cols is None:
            self._secp_cols = self._columns(_secp256k1.PubKey, 33)
        return self._secp_cols or None

    def bls12381_columns(self) -> Optional[tuple]:
        """(pub (n, 48) uint8, power (n,) int64) over the set, or None
        unless every key is bls12381 (reference validator_set.py:340-370):
        the aggregated commit's committee. prepare_aggregated_commit
        carries the compressed G1 rows on its AggBlock, and the epoch
        cache keys the decompressed table on the same hash(). Cached
        beside the other columns; () is the cached "not all bls12381"
        (the reference's _NO_BLS_COLS), and an update of the set must
        clear it with the hash."""
        if self._bls_cols is None:
            self._bls_cols = self._columns(_bls12381.PubKey, 48)
        return self._bls_cols or None

    def validate_basic(self) -> None:
        if not self.validators:
            raise ValueError("validator set is nil or empty")
        for i, v in enumerate(self.validators):
            try:
                v.validate_basic()
            except ValueError as e:
                raise ValueError(f"invalid validator #{i}: {e}") from e
        if self.proposer is None:
            raise ValueError("proposer failed validate basic: nil")
        self.proposer.validate_basic()

    # ---- proposer rotation (validator_set.go:115-195) -----------------

    def increment_proposer_priority(self, times: int) -> None:
        if not self.validators:
            raise ValueError("empty validator set")
        if times <= 0:
            raise ValueError("cannot call with non-positive times")
        self._rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        )
        self._shift_by_avg_proposer_priority()
        for _ in range(times):
            for v in self.validators:
                v.proposer_priority = _clip64(v.proposer_priority + v.voting_power)
            proposer = None
            for v in self.validators:
                proposer = v if proposer is None else proposer.compare_proposer_priority(v)
            proposer.proposer_priority = _clip64(
                proposer.proposer_priority - self.total_voting_power()
            )
        self.proposer = proposer

    def _rescale_priorities(self, diff_max: int) -> None:
        if diff_max <= 0:
            return
        prios = [v.proposer_priority for v in self.validators]
        diff = abs(max(prios) - min(prios))
        ratio = (diff + diff_max - 1) // diff_max
        if diff > diff_max:
            for v in self.validators:
                v.proposer_priority = _go_div(v.proposer_priority, ratio)

    def _shift_by_avg_proposer_priority(self) -> None:
        # big.Int.Div is Euclidean: it floors for a positive divisor
        avg = sum(v.proposer_priority for v in self.validators) // len(self.validators)
        for v in self.validators:
            v.proposer_priority = _clip64(v.proposer_priority - avg)

    # ---- proto --------------------------------------------------------

    def encode(self) -> bytes:
        w = ProtoWriter()
        for v in self.validators:
            w.write_message(1, v.encode(), always=True)
        if self.proposer is not None:
            w.write_message(2, self.proposer.encode())
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "ValidatorSet":
        f = decode_message(data)
        vals = [Validator.decode(raw) for raw in field_repeated_bytes(f, 1)]
        proposer = Validator.decode(field_bytes(f, 2)) if 2 in f else None
        vs = cls(validators=vals, proposer=proposer)
        vs.total_voting_power()  # recomputed, never trusted from the wire
        vs.validate_basic()
        return vs


class ErrNotEnoughVotingPowerSigned(ValueError):
    """validator_set.go:703-713."""

    def __init__(self, got: int, needed: int):
        super().__init__(
            f"invalid commit -- insufficient voting power: got {got}, "
            f"needed more than {needed}"
        )
        self.got = got
        self.needed = needed
