"""BitArray: a thread-safe bit vector, the aggregated commit's signer bitmap.

Counterpart: tendermint_tpu/libs/bits.py (libs/bits/bit_array.go in the
reference). Stored as a Python int bitmask
(arbitrary precision beats a []uint64 here); the wire form is the proto
tendermint.libs.bits.BitArray {1 bits(int64) 2 elems(repeated uint64)}.
"""

from __future__ import annotations

import random as _random
import threading
from typing import List, Optional

from ..wire.proto import ProtoWriter, decode_message, field_int


class BitArray:
    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative bit count")
        self._bits = bits
        self._mask = 0
        self._mtx = threading.Lock()

    # -- core ----------------------------------------------------------

    def size(self) -> int:
        return self._bits

    def get_index(self, i: int) -> bool:
        with self._mtx:
            if i >= self._bits or i < 0:
                return False
            return bool((self._mask >> i) & 1)

    def set_index(self, i: int, v: bool) -> bool:
        with self._mtx:
            if i >= self._bits or i < 0:
                return False
            if v:
                self._mask |= 1 << i
            else:
                self._mask &= ~(1 << i)
            return True

    def copy(self) -> "BitArray":
        out = BitArray(self._bits)
        out._mask = self._mask
        return out

    # -- set algebra (bit_array.go Or/And/Not/Sub) ----------------------

    def or_(self, other: Optional["BitArray"]) -> "BitArray":
        if other is None:
            return self.copy()
        out = BitArray(max(self._bits, other._bits))
        out._mask = self._mask | other._mask
        return out

    def and_(self, other: Optional["BitArray"]) -> "BitArray":
        if other is None:
            return BitArray(self._bits)
        out = BitArray(min(self._bits, other._bits))
        out._mask = self._mask & other._mask & ((1 << out._bits) - 1)
        return out

    def not_(self) -> "BitArray":
        out = BitArray(self._bits)
        out._mask = ~self._mask & ((1 << self._bits) - 1)
        return out

    def sub(self, other: Optional["BitArray"]) -> "BitArray":
        """Bits in self but not in other (within self's length)."""
        if other is None:
            return self.copy()
        out = BitArray(self._bits)
        out._mask = self._mask & ~(other._mask & ((1 << self._bits) - 1))
        return out

    def is_empty(self) -> bool:
        return self._mask == 0

    def is_full(self) -> bool:
        return self._mask == (1 << self._bits) - 1 and self._bits > 0

    def pick_random(self) -> tuple:
        """(index, ok): a uniformly random true bit (bit_array.go:253-265)."""
        with self._mtx:
            idxs = [i for i in range(self._bits) if (self._mask >> i) & 1]
        if not idxs:
            return 0, False
        return _random.choice(idxs), True

    def get_true_indices(self) -> List[int]:
        with self._mtx:
            return [i for i in range(self._bits) if (self._mask >> i) & 1]

    def num_true_bits(self) -> int:
        return bin(self._mask).count("1")

    # -- wire ----------------------------------------------------------

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.write_varint(1, self._bits)
        elems = (self._bits + 63) // 64
        for i in range(elems):
            w.write_varint(2, (self._mask >> (64 * i)) & ((1 << 64) - 1), always=True)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "BitArray":
        f = decode_message(data)
        bits = field_int(f, 1)
        out = cls(bits)
        mask = 0
        for i, (_, v) in enumerate(f.get(2, [])):
            mask |= int(v) << (64 * i)
        out._mask = mask & ((1 << bits) - 1) if bits else 0
        return out

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitArray)
            and self._bits == other._bits
            and self._mask == other._mask
        )

    def __repr__(self) -> str:
        s = "".join("x" if (self._mask >> i) & 1 else "_" for i in range(self._bits))
        return f"BA{{{self._bits}:{s}}}"
