"""Merlin transcripts on STROBE-128 on Keccak-f[1600].

Counterpart: tendermint_tpu/crypto/_merlin.py, copied whole. Supports the
sr25519 (schnorrkel) signature scheme the reference gets from
curve25519-voi (crypto/sr25519/). Pure Python: keccak_f is the standard
24-round permutation; Strobe128 follows merlin's strobe.rs subset
(meta_ad/ad/prf/key); Transcript implements merlin's framing (dom-sep +
label + LE32 length). The batch path computes its challenges with the C
copy in csrc/merlin.cpp (ops/host.py); this module signs, verifies on
the host and is the C copy's reference.
"""

from __future__ import annotations

import os
from typing import List

# -- Keccak-f[1600] ---------------------------------------------------------

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTC = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK64 = (1 << 64) - 1


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK64


def keccak_f1600(state: bytearray) -> None:
    """In-place permutation of a 200-byte state."""
    lanes = [
        [int.from_bytes(state[8 * (x + 5 * y) : 8 * (x + 5 * y) + 8], "little") for y in range(5)]
        for x in range(5)
    ]
    for rc in _ROUND_CONSTANTS:
        # θ
        c = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                lanes[x][y] ^= d[x]
        # ρ and π
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(lanes[x][y], _ROTC[x][y])
        # χ
        for x in range(5):
            for y in range(5):
                lanes[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _MASK64)
        # ι
        lanes[0][0] ^= rc
    for x in range(5):
        for y in range(5):
            state[8 * (x + 5 * y) : 8 * (x + 5 * y) + 8] = lanes[x][y].to_bytes(8, "little")


# -- STROBE-128 (merlin's subset) -------------------------------------------

_R = 166  # strobe128 rate
FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _R + 2, 1, 0, 1, 12 * 8])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def clone(self) -> "Strobe128":
        c = Strobe128.__new__(Strobe128)
        c.state = bytearray(self.state)
        c.pos = self.pos
        c.pos_begin = self.pos_begin
        c.cur_flags = self.cur_flags
        return c

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for b in data:
            self.state[self.pos] ^= b
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for b in data:
            self.state[self.pos] = b
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if self.cur_flags != flags:
                raise ValueError("flag mismatch on more=True")
            return
        if flags & FLAG_T:
            raise ValueError("transport not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (FLAG_C | FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool = False) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)


# -- Merlin transcript -------------------------------------------------------


def _le32(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    def __init__(self, label: bytes):
        self._strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def clone(self) -> "Transcript":
        t = Transcript.__new__(Transcript)
        t._strobe = self._strobe.clone()
        return t

    def append_message(self, label: bytes, message: bytes) -> None:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(_le32(len(message)), True)
        self._strobe.ad(message, False)

    def append_u64(self, label: bytes, n: int) -> None:
        self.append_message(label, n.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(_le32(n), True)
        return self._strobe.prf(n)

    def witness_bytes(self, label: bytes, nonce_seeds: List[bytes], n: int) -> bytes:
        """TranscriptRngBuilder: rekey with witness then external rng."""
        s = self._strobe.clone()
        for seed in nonce_seeds:
            s.meta_ad(label, False)
            s.meta_ad(_le32(len(seed)), True)
            s.key(seed, False)
        s.meta_ad(b"rng", False)
        s.key(os.urandom(32), False)
        s.meta_ad(_le32(n), False)
        return s.prf(n)
