"""Batch-verifier dispatch keyed on the public key type.

Counterpart: tendermint_tpu/crypto/batch.py (crypto/batch/batch.go:11-33).
ed25519 keys get the port's device verifier
(ops/backend.Ed25519DeviceBatchVerifier), sr25519 keys the sr25519 one
(ops/mixed.Sr25519DeviceBatchVerifier), bound here directly: there is no
injectable factory, and no other key type batches. secp256k1 keys get
None, as in the reference (batch.go:26-33): their device lane is reached
through the commit path's prepare seam and ops/mixed.py, and
ops/mixed.Secp256k1DeviceBatchVerifier is made by callers that ask for
it.
"""

from __future__ import annotations

from typing import Optional

from . import BatchVerifier, PubKey
from . import ed25519 as _ed25519
from . import sr25519 as _sr25519


def create_batch_verifier(pub_key: Optional[PubKey], *,
                          device=None) -> Optional[BatchVerifier]:
    """batch.go:11-24: a verifier for pub_key's type, or None when the
    type has none. `device` defaults to the CUDA card (device.py)."""
    from ..device import resolve_device
    from ..ops.backend import Ed25519DeviceBatchVerifier
    from ..ops.mixed import Sr25519DeviceBatchVerifier

    dev = resolve_device(device)
    kind = None if pub_key is None else pub_key.type()
    if kind == _ed25519.KEY_TYPE:
        return Ed25519DeviceBatchVerifier(device=dev)
    if kind == _sr25519.KEY_TYPE:
        return Sr25519DeviceBatchVerifier(device=dev)
    return None


def supports_batch_verifier(pub_key: Optional[PubKey]) -> bool:
    """batch.go:26-33."""
    return pub_key is not None and pub_key.type() in (_ed25519.KEY_TYPE, _sr25519.KEY_TYPE)
