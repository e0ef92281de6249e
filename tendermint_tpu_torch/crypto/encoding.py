"""PubKey <-> proto conversion, ed25519 only.

Counterpart: tendermint_tpu/crypto/encoding.py (crypto/encoding/codec.go).
tendermint.crypto.PublicKey is a oneof whose field 1 is the ed25519 key;
this slice of the port carries no other key type.
"""

from __future__ import annotations

from ..wire.proto import ProtoWriter, decode_message, field_bytes
from . import PubKey
from . import ed25519 as _ed25519

_FIELD_ED25519 = 1


def pubkey_to_proto(pk: PubKey) -> bytes:
    if pk.type() != _ed25519.KEY_TYPE:
        raise ValueError(f"unsupported key type {pk.type()}")
    w = ProtoWriter()
    w.write_bytes(_FIELD_ED25519, pk.bytes(), always=True)
    return w.bytes()


def pubkey_from_proto(data: bytes) -> PubKey:
    fields = decode_message(data)
    if _FIELD_ED25519 in fields:
        return _ed25519.PubKey(field_bytes(fields, _FIELD_ED25519))
    raise ValueError("unsupported or empty PublicKey oneof")
