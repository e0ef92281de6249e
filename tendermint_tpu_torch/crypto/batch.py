"""Batch-verifier dispatch keyed on the public key type.

Counterpart: tendermint_tpu/crypto/batch.py (crypto/batch/batch.go:11-33).
The ed25519 verifier is the port's device verifier
(ops/backend.Ed25519DeviceBatchVerifier), bound here directly: there is
no injectable factory, and no other key type batches in this slice.
"""

from __future__ import annotations

from typing import Optional

from . import BatchVerifier, PubKey
from . import ed25519 as _ed25519


def create_batch_verifier(pub_key: Optional[PubKey], *,
                          device=None) -> Optional[BatchVerifier]:
    """batch.go:11-24: a verifier for pub_key's type, or None when the
    type has none. `device` defaults to the CUDA card (device.py)."""
    from ..device import resolve_device
    from ..ops.backend import Ed25519DeviceBatchVerifier

    dev = resolve_device(device)
    if pub_key is not None and pub_key.type() == _ed25519.KEY_TYPE:
        return Ed25519DeviceBatchVerifier(device=dev)
    return None


def supports_batch_verifier(pub_key: Optional[PubKey]) -> bool:
    """batch.go:26-33."""
    return pub_key is not None and pub_key.type() == _ed25519.KEY_TYPE
