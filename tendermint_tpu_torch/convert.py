"""Carry verification state into the port from wire bytes and arrays.

The JAX package and the port share no objects: a validator set and a
commit cross over as their protobuf encodings (tendermint_tpu's
ValidatorSet.encode() and Commit.encode(), the reference's wire format),
a light block as its header's, commit's and set's encodings (the JAX
package's SignedHeader has no encode of its own; its LightStore writes
the header and the commit apart), and a signature batch as numpy
columns. A set of any key type the port has (ed25519, secp256k1,
sr25519) crosses this way, so the two packages' ValidatorSet.hash()
agree.
"""

from __future__ import annotations

import numpy as np

from .light.provider import LightBlock
from .ops.entry_block import EntryBlock
from .types.block import Commit, Header, SignedHeader
from .types.validator_set import ValidatorSet


def state_from_wire(valset_bytes: bytes, commit_bytes: bytes):
    """(ValidatorSet, Commit) of the port, decoded from the protobuf
    encodings of tendermint.types.ValidatorSet and tendermint.types.Commit;
    a canonical commit decodes columnar (types/block.Commit.decode)."""
    return ValidatorSet.decode(bytes(valset_bytes)), Commit.decode(bytes(commit_bytes))


def light_block_from_wire(header_bytes: bytes, commit_bytes: bytes,
                          valset_bytes: bytes) -> LightBlock:
    """LightBlock of the port from the protobuf encodings of
    tendermint.types.Header, Commit and ValidatorSet."""
    return LightBlock(
        signed_header=SignedHeader(header=Header.decode(bytes(header_bytes)),
                                   commit=Commit.decode(bytes(commit_bytes))),
        validators=ValidatorSet.decode(bytes(valset_bytes)),
    )


def entries_from_arrays(pub: np.ndarray, sig: np.ndarray, msgs,
                        offsets: np.ndarray) -> EntryBlock:
    """EntryBlock from pub (n, 32) uint8, sig (n, 64) uint8, the messages
    concatenated in one buffer, and (n+1,) offsets into it."""
    offsets = np.asarray(offsets)
    if offsets.dtype.kind not in "iu":
        raise ValueError("offsets must be integers")
    return EntryBlock(
        np.ascontiguousarray(pub),
        np.ascontiguousarray(sig),
        bytes(msgs),
        offsets.astype(np.int64),
    )
