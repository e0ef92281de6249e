"""PubKey <-> proto conversion, ed25519, secp256k1 and sr25519.

Counterpart: tendermint_tpu/crypto/encoding.py (crypto/encoding/codec.go).
tendermint.crypto.PublicKey is a oneof: field 1 is the ed25519 key,
field 2 the secp256k1 key, field 3 the sr25519 key; the port carries no
BLS key (the JAX package's field 4) yet.
"""

from __future__ import annotations

from ..wire.proto import ProtoWriter, decode_message, field_bytes
from . import PubKey
from . import ed25519 as _ed25519
from . import secp256k1 as _secp256k1
from . import sr25519 as _sr25519

_FIELDS = {
    _ed25519.KEY_TYPE: (1, _ed25519.PubKey),
    _secp256k1.KEY_TYPE: (2, _secp256k1.PubKey),
    _sr25519.KEY_TYPE: (3, _sr25519.PubKey),
}


def pubkey_to_proto(pk: PubKey) -> bytes:
    if pk.type() not in _FIELDS:
        raise ValueError(f"unsupported key type {pk.type()}")
    w = ProtoWriter()
    w.write_bytes(_FIELDS[pk.type()][0], pk.bytes(), always=True)
    return w.bytes()


def pubkey_from_proto(data: bytes) -> PubKey:
    fields = decode_message(data)
    for field, cls in _FIELDS.values():
        if field in fields:
            return cls(field_bytes(fields, field))
    raise ValueError("unsupported or empty PublicKey oneof")
