"""Minimal deterministic proto3 encoder/decoder.

Counterpart: tendermint_tpu/wire/proto.py (gogoproto's generated
marshalers): fields in ascending order, proto3 zero scalars omitted,
non-nullable embedded messages always emitted, negative varints as
10-byte two's complement, delimited framing as a uvarint length prefix.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple, Union

_U64_MASK = (1 << 64) - 1

WT_VARINT = 0
WT_FIXED64 = 1
WT_BYTES = 2
WT_FIXED32 = 5


def encode_uvarint(v: int) -> bytes:
    if v < 0:
        raise ValueError("uvarint cannot be negative")
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def decode_uvarint(data: bytes, offset: int = 0) -> Tuple[int, int]:
    """Returns (value, next_offset)."""
    result = 0
    shift = 0
    while True:
        if offset >= len(data):
            raise ValueError("truncated uvarint")
        b = data[offset]
        offset += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, offset
        shift += 7
        if shift > 63:
            raise ValueError("uvarint overflow")


def _tag(field: int, wire_type: int) -> bytes:
    return encode_uvarint((field << 3) | wire_type)


class ProtoWriter:
    """Append-only message writer. Call write_* in ascending field order."""

    def __init__(self):
        self._buf = bytearray()

    def write_varint(self, field: int, value: int, always: bool = False) -> None:
        if value == 0 and not always:
            return
        self._buf += _tag(field, WT_VARINT)
        self._buf += encode_uvarint(value & _U64_MASK)

    def write_sfixed64(self, field: int, value: int, always: bool = False) -> None:
        if value == 0 and not always:
            return
        self._buf += _tag(field, WT_FIXED64)
        self._buf += (value & _U64_MASK).to_bytes(8, "little")

    def write_bytes(self, field: int, value: bytes, always: bool = False) -> None:
        if not value and not always:
            return
        self._buf += _tag(field, WT_BYTES)
        self._buf += encode_uvarint(len(value))
        self._buf += value

    def write_string(self, field: int, value: str, always: bool = False) -> None:
        self.write_bytes(field, value.encode("utf-8"), always)

    def write_message(self, field: int, encoded: Optional[bytes],
                      always: bool = False) -> None:
        """Embedded message: None is omitted (nullable); b"" is emitted as
        a zero-length message (gogoproto non-nullable)."""
        if encoded is None:
            return
        self._buf += _tag(field, WT_BYTES)
        self._buf += encode_uvarint(len(encoded))
        self._buf += encoded

    def bytes(self) -> bytes:
        return bytes(self._buf)


FieldValue = Union[int, bytes]


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, FieldValue]]:
    """(field, wire_type, raw_value) in wire order; varint/fixed values
    as unsigned ints, length-delimited values as bytes. The columnar
    commit decode (types/block.py) walks each CommitSig record once with
    it, without building decode_message's dict."""
    off = 0
    while off < len(data):
        key, off = decode_uvarint(data, off)
        field, wt = key >> 3, key & 7
        if field == 0:
            raise ValueError("field number 0 is invalid")
        if wt == WT_VARINT:
            val, off = decode_uvarint(data, off)
        elif wt == WT_FIXED64:
            if off + 8 > len(data):
                raise ValueError("truncated fixed64")
            val = int.from_bytes(data[off : off + 8], "little")
            off += 8
        elif wt == WT_BYTES:
            ln, off = decode_uvarint(data, off)
            if off + ln > len(data):
                raise ValueError("truncated bytes field")
            val = data[off : off + ln]
            off += ln
        elif wt == WT_FIXED32:
            if off + 4 > len(data):
                raise ValueError("truncated fixed32")
            val = int.from_bytes(data[off : off + 4], "little")
            off += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def decode_message(data: bytes) -> Dict[int, List[Tuple[int, FieldValue]]]:
    """{field: [(wire_type, raw_value), ...]} (iter_fields' values)."""
    out: Dict[int, List[Tuple[int, FieldValue]]] = {}
    for field, wt, val in iter_fields(data):
        out.setdefault(field, []).append((wt, val))
    return out


def to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def to_signed32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def field_bytes(fields, num: int, default: bytes = b"") -> bytes:
    vals = fields.get(num)
    if not vals:
        return default
    wt, val = vals[-1]
    if wt != WT_BYTES:
        raise ValueError(f"field {num}: expected bytes, got wire type {wt}")
    return val


def field_int(fields, num: int, default: int = 0) -> int:
    vals = fields.get(num)
    if not vals:
        return default
    wt, val = vals[-1]
    if wt == WT_BYTES:
        raise ValueError(f"field {num}: expected scalar, got length-delimited")
    return val


def field_repeated_bytes(fields, num: int) -> List[bytes]:
    out: List[bytes] = []
    for wt, val in fields.get(num, []):
        if wt != WT_BYTES:
            raise ValueError(
                f"repeated field {num}: expected bytes, got wire type {wt}"
            )
        out.append(val)
    return out


def marshal_delimited(encoded: bytes) -> bytes:
    """uvarint length prefix + message (protoio/writer.go:93-100)."""
    return encode_uvarint(len(encoded)) + encoded
