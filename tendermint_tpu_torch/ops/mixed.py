"""The sr25519 batch verifier (the sr25519 lane of mixed-curve sets).

Counterpart: tendermint_tpu/ops/mixed.py (SR_DEVICE_THRESHOLD,
_verify_sr25519_batch, Sr25519DeviceBatchVerifier; mixed.py:34,
:157-214, :289-309), crypto/sr25519/batch.go in the reference. Batches
of SR_DEVICE_THRESHOLD signatures or more verify on `device` through
ops/sr25519.py; smaller ones on the host, one signature at a time.

Not ported, on purpose: the first-use compile watchdog, TM_TPU_SR_DEVICE
and the native host lane each move work off the device when it is slow
or failing, and the port has no such fallback; verify_mixed waits for
the secp256k1 lane.
"""

from __future__ import annotations

import numpy as np

from ..crypto import sr25519 as _sr25519
from . import sr25519
from .backend import DeviceBatchVerifier
from .entry_block import EntryBlock

# Below this many signatures a batch verifies on the host (mixed.py:34's
# default): the device wins early because host schnorr math is slow.
SR_DEVICE_THRESHOLD = 8


def _verify_sr25519_batch(block: EntryBlock, device) -> np.ndarray:
    if len(block) < SR_DEVICE_THRESHOLD:
        return np.array(_sr25519.verify_batch(list(block.iter_entries())), dtype=bool)
    return sr25519.verify_batch_sr25519(block, device=device)


class Sr25519DeviceBatchVerifier(DeviceBatchVerifier):
    """sr25519 on `device` (crypto/sr25519/batch.go semantics: exact
    per-signature verdicts)."""

    KEY_CLASS = _sr25519.PubKey
    KEY_NAME = "sr25519"
    SIGNATURE_SIZE = _sr25519.SIGNATURE_SIZE

    def _verify_block(self, block: EntryBlock) -> np.ndarray:
        return _verify_sr25519_batch(block, self.device)
