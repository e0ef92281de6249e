"""The trusted light-block store.

Counterpart: tendermint_tpu/light/store.py (light/store/db): light
blocks kept by height in a db.DB, as a {1 SignedHeader {1 header,
2 commit}, 2 validator set} record, with first and last queries and
pruning. Every read decodes the record (the commit columnar, the set
with its validate_basic): at 10,000 validators that is the store's cost,
spanned "light.store" with the encode.
"""

from __future__ import annotations

import struct
from typing import Optional

from torch.profiler import record_function

from ..db import DB
from ..types.block import Commit, Header, SignedHeader
from ..types.validator_set import ValidatorSet
from ..wire.proto import ProtoWriter, decode_message, field_bytes
from .provider import LightBlock

_PREFIX = b"lb/"


def _key(height: int) -> bytes:
    return _PREFIX + struct.pack(">q", height)


def _height(key: bytes) -> int:
    return struct.unpack(">q", key[len(_PREFIX):])[0]


class LightStore:
    def __init__(self, db: DB):
        self._db = db

    def save_light_block(self, lb: LightBlock) -> None:
        with record_function("light.store"):
            sh = ProtoWriter()
            sh.write_message(1, lb.signed_header.header.encode(), always=True)
            sh.write_message(2, lb.signed_header.commit.encode(), always=True)
            w = ProtoWriter()
            w.write_message(1, sh.bytes(), always=True)
            w.write_message(2, lb.validators.encode(), always=True)
            self._db.set(_key(lb.height), w.bytes())

    def light_block(self, height: int) -> Optional[LightBlock]:
        raw = self._db.get(_key(height))
        if raw is None:
            return None
        with record_function("light.store"):
            f = decode_message(raw)
            sh = decode_message(field_bytes(f, 1))
            return LightBlock(
                signed_header=SignedHeader(
                    header=Header.decode(field_bytes(sh, 1)),
                    commit=Commit.decode(field_bytes(sh, 2)),
                ),
                validators=ValidatorSet.decode(field_bytes(f, 2)),
            )

    def first_light_block_height(self) -> int:
        for k, _ in self._db.iterator(_key(0), _key(1 << 62)):
            return _height(k)
        return -1

    def last_light_block_height(self) -> int:
        for k, _ in self._db.reverse_iterator(_key(0), _key(1 << 62)):
            return _height(k)
        return -1

    def latest_light_block(self) -> Optional[LightBlock]:
        h = self.last_light_block_height()
        return self.light_block(h) if h >= 0 else None

    def light_block_before(self, height: int) -> Optional[LightBlock]:
        for k, _ in self._db.reverse_iterator(_key(0), _key(height)):
            return self.light_block(_height(k))
        return None

    def prune(self, size: int) -> int:
        """Keep only the newest `size` blocks; returns how many went."""
        heights = [_height(k) for k, _ in self._db.iterator(_key(0), _key(1 << 62))]
        pruned = 0
        for h in heights[: max(0, len(heights) - size)]:
            self._db.delete(_key(h))
            pruned += 1
        return pruned
