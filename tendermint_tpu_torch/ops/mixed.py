"""Mixed-curve batch verification (BASELINE config #4) and its sr25519
and secp256k1 lanes.

Counterpart: tendermint_tpu/ops/mixed.py (SR_DEVICE_THRESHOLD :34,
SECP_DEVICE_THRESHOLD :38, _host_secp_batch :58, _verify_secp_batch :82,
_verify_sr25519_batch :157-214, verify_mixed :207-286,
Sr25519DeviceBatchVerifier :289-309, Secp256k1DeviceBatchVerifier
:311-335), crypto/sr25519/batch.go in the reference. A lane of
SR_DEVICE_THRESHOLD sr25519 or SECP_DEVICE_THRESHOLD secp256k1
signatures or more verifies on `device` (ops/sr25519.py;
backend.verify_batch_secp over ops/secp_verify.py); a smaller one on the
host, one signature at a time. verify_mixed splits one batch by key
type and runs the lanes at once: ed25519 through the device's shared
dispatcher (ops/pipeline.py), sr25519 and secp256k1 on helper threads,
any other key on the caller's thread; it joins each within 600 s and
re-raises a lane's exception.

Not ported, on purpose: the first-use compile watchdog, TM_TPU_SR_DEVICE,
TM_TPU_SECP_DEVICE, the TM_TPU_SECP_HOST_* and TM_TPU_SR_HOST_* pools and
the native host lane each move work off the device when it is slow or
failing, and the port has no such fallback. The host loops take no
thread pool: the port's crypto is pure Python (the reference skips its
pools then too).
"""

from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import numpy as np

from ..crypto import PubKey
from ..crypto import secp256k1 as _secp256k1
from ..crypto import sr25519 as _sr25519
from ..device import resolve_device
from . import backend, sr25519
from .backend import DeviceBatchVerifier
from .entry_block import EntryBlock

# Below this many signatures a batch verifies on the host (mixed.py:34's
# default): the device wins early because host schnorr math is slow.
SR_DEVICE_THRESHOLD = 8
# the same for secp256k1 (mixed.py:38's default); host ECDSA in pure
# Python takes tens of ms a signature
SECP_DEVICE_THRESHOLD = 8
LANE_TIMEOUT = 600.0  # seconds verify_mixed waits for each lane


def _verify_sr25519_batch(block: EntryBlock, device) -> np.ndarray:
    if len(block) < SR_DEVICE_THRESHOLD:
        return np.array(_sr25519.verify_batch(list(block.iter_entries())), dtype=bool)
    return sr25519.verify_batch_sr25519(block, device=device)


def _host_secp_batch(block: EntryBlock) -> np.ndarray:
    """Per-signature host verification, one at a time."""
    return np.array([_secp256k1.PubKey(p).verify_signature(m, s)
                     for p, m, s in block.iter_entries()], dtype=bool)


def _verify_secp_batch(block: EntryBlock, device) -> np.ndarray:
    """The secp256k1 lane: the device kernel from SECP_DEVICE_THRESHOLD
    signatures, the host below; the verdicts are the same."""
    if len(block) < SECP_DEVICE_THRESHOLD:
        return _host_secp_batch(block)
    return backend.verify_batch_secp(block, device=device)


def _lane_thread(fn, *args) -> Tuple[threading.Thread, dict]:
    holder: dict = {}

    def run() -> None:
        try:
            holder["res"] = fn(*args)
        except BaseException as e:  # re-raised by the caller
            holder["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, holder


def _join(name: str, t: threading.Thread, holder: dict) -> np.ndarray:
    t.join(timeout=LANE_TIMEOUT)
    if t.is_alive():
        raise TimeoutError(f"the {name} lane did not finish in {LANE_TIMEOUT:.0f} s")
    if "err" in holder:
        raise holder["err"]
    return holder["res"]


def verify_mixed(entries: Sequence[Tuple[PubKey, bytes, bytes]], *, device=None) -> List[bool]:
    """(PubKey, msg, sig) triples of any key types -> per-entry validity in
    input order. ed25519, sr25519 and secp256k1 verify on `device`
    (default the CUDA card) at once; any other key type on the host."""
    dev = resolve_device(device)
    kinds = ("ed25519", "sr25519", "secp256k1")
    lanes: dict = {k: [] for k in kinds + ("other",)}
    order = []
    for pk, msg, sig in entries:
        kind = pk.type() if pk.type() in kinds else "other"
        order.append((kind, len(lanes[kind])))
        lanes[kind].append((pk, msg, sig))

    def block(kind):
        return EntryBlock.from_entries([(pk.bytes(), m, s) for pk, m, s in lanes[kind]],
                                       scheme=kind)

    results = {}
    ed_future = sr = secp = None
    if lanes["ed25519"]:
        from .pipeline import shared_verifier

        ed_future = shared_verifier(dev).submit(block("ed25519"))
    if lanes["sr25519"]:
        sr = _lane_thread(_verify_sr25519_batch, block("sr25519"), dev)
    if lanes["secp256k1"]:
        secp = _lane_thread(_verify_secp_batch, block("secp256k1"), dev)
    if lanes["other"]:
        results["other"] = np.array([pk.verify_signature(m, s) for pk, m, s in lanes["other"]],
                                    dtype=bool)
    if ed_future is not None:
        results["ed25519"] = np.asarray(ed_future.result(timeout=LANE_TIMEOUT))
    if sr is not None:
        results["sr25519"] = _join("sr25519", *sr)
    if secp is not None:
        results["secp256k1"] = _join("secp256k1", *secp)
    return [bool(results[kind][j]) for kind, j in order]


class Sr25519DeviceBatchVerifier(DeviceBatchVerifier):
    """sr25519 on `device` (crypto/sr25519/batch.go semantics: exact
    per-signature verdicts)."""

    KEY_CLASS = _sr25519.PubKey
    KEY_NAME = "sr25519"
    SIGNATURE_SIZE = _sr25519.SIGNATURE_SIZE

    def _verify_block(self, block: EntryBlock) -> np.ndarray:
        return _verify_sr25519_batch(block, self.device)


class Secp256k1DeviceBatchVerifier(DeviceBatchVerifier):
    """The BatchVerifier shape over the secp256k1 lane, exact
    per-signature verdicts. crypto.batch.create_batch_verifier never
    returns it (the reference has no secp256k1 batch verifier,
    batch.go:26-33): callers that want it make it."""

    KEY_CLASS = _secp256k1.PubKey
    KEY_NAME = "secp256k1"
    SCHEME = "secp256k1"
    SIGNATURE_SIZE = _secp256k1.SIGNATURE_LENGTH

    def _verify_block(self, block: EntryBlock) -> np.ndarray:
        return _verify_secp_batch(block, self.device)
