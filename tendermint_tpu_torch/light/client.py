"""The light client: stateful header verification with bisection.

Counterpart: tendermint_tpu/light/client.py (light/client.go and
light/detector.go): the trust-options bootstrap (:370) with the
witnesses' cross-check of the root, verify_header and
verify_light_block_at_height (:406), sequential verification (:546),
skipping verification with the 9/16 bisection pivot (:639, :44-45),
the backwards walk (:878), the promotion of a witness when the primary
lacks a block (:935-1035), and the divergence detector, which builds
LightClientAttackEvidence against both sides and halts. Every commit
check runs on the client's `device` (light/verifier.py); errors are the
reference's, byte for byte.
"""

from __future__ import annotations

import http.client as _http
from dataclasses import dataclass
from typing import Callable, List, Optional

from torch.profiler import record_function

from ..device import resolve_device
from ..libs.timeutil import now_ts as _now_ts
from ..types.evidence import LightBlockData, LightClientAttackEvidence
from ..types.validation import Fraction, verify_commit_light
from ..wire.canonical import Timestamp
from . import verifier
from .provider import ErrLightBlockNotFound, LightBlock, Provider
from .store import LightStore

DEFAULT_PRUNING_SIZE = 1000
DEFAULT_MAX_CLOCK_DRIFT = 10.0  # seconds (light/client.go:56)

# the bisection pivot: 9/16 of the way (light/client.go:44-45)
_BISECT_NUM = 9
_BISECT_DEN = 16


@dataclass
class TrustOptions:
    """light/client.go TrustOptions: the trusting period and the root of
    trust (height, hash)."""

    period: float  # seconds
    height: int
    hash: bytes

    def validate(self) -> None:
        if self.period <= 0:
            raise ValueError("trusting period must be greater than zero")
        if self.height <= 0:
            raise ValueError("trust option height must be greater than zero")
        if len(self.hash) != 32:
            raise ValueError(f"expected hash size to be 32 bytes, got {len(self.hash)}")


class ErrLightClientAttack(RuntimeError):
    """detector.go: the primary and a witness diverge."""


class ErrNoWitnesses(RuntimeError):
    """light/errors.go ErrNoWitnesses."""


class ErrFailedHeaderCrossReferencing(RuntimeError):
    """light/errors.go: no witness could confirm the primary's header."""


def make_attack_evidence(conflicted: LightBlock, trusted: LightBlock,
                         common: LightBlock) -> LightClientAttackEvidence:
    """detector.go:406-423 newLightClientAttackEvidence. The common height
    tells the attack's form: a lunatic header (forged state hashes) points
    at the last common header, an equivocation or amnesia at the
    conflicting height."""
    ev = LightClientAttackEvidence(
        conflicting_block=LightBlockData.from_parts(conflicted.signed_header,
                                                    conflicted.validators),
        common_height=0,
    )
    if ev.conflicting_header_is_invalid(trusted.signed_header.header):
        ev.common_height = common.height
        ev.timestamp = common.signed_header.header.time
        ev.total_voting_power = common.validators.total_voting_power()
    else:
        ev.common_height = trusted.height
        ev.timestamp = trusted.signed_header.header.time
        ev.total_voting_power = trusted.validators.total_voting_power()
    ev.byzantine_validators = ev.get_byzantine_validators(common.validators,
                                                          trusted.signed_header)
    return ev


class Client:
    """light/client.go:130-1100. `device` (default: the CUDA card) is
    where every commit check of the client runs."""

    def __init__(
        self,
        chain_id: str,
        trust_options: TrustOptions,
        primary: Provider,
        witnesses: List[Provider],
        store: LightStore,
        trust_level: Fraction = verifier.DEFAULT_TRUST_LEVEL,
        max_clock_drift: float = DEFAULT_MAX_CLOCK_DRIFT,
        sequential: bool = False,
        pruning_size: int = DEFAULT_PRUNING_SIZE,
        now_fn: Optional[Callable[[], Timestamp]] = None,
        *,
        device=None,
    ):
        self._device = resolve_device(device)
        trust_options.validate()
        verifier.validate_trust_level(trust_level)
        self._now_ts = now_fn or _now_ts
        self._chain_id = chain_id
        self._trusting_period = trust_options.period
        self._trust_level = trust_level
        self._max_clock_drift = max_clock_drift
        self._primary = primary
        self._witnesses = list(witnesses)
        self._store = store
        self._sequential = sequential
        self._pruning_size = pruning_size
        self._initialize(trust_options)

    # -- bootstrap (client.go:370-404) -----------------------------------

    def _initialize(self, opts: TrustOptions) -> None:
        if self._store.latest_light_block() is not None:
            return  # bootstrapped already
        lb = self._primary.light_block(opts.height)
        with record_function("light.checks"):
            if lb.hash() != opts.hash:
                raise ValueError(
                    f"expected header's hash {opts.hash.hex()}, but got {lb.hash().hex()}"
                )
            lb.signed_header.validate_basic(self._chain_id)
            if lb.signed_header.header.validators_hash != lb.validators.hash():
                raise ValueError("expected header's validators to match those supplied")
        # the root's commit against its own set
        verify_commit_light(
            self._chain_id,
            lb.validators,
            lb.signed_header.commit.block_id,
            lb.height,
            lb.signed_header.commit,
            device=self._device,
        )
        # cross-check before saving: a failed construction must not
        # leave the store bootstrapped
        self._compare_first_header_with_witnesses(lb)
        self._store.save_light_block(lb)

    def _compare_first_header_with_witnesses(self, root: LightBlock) -> None:
        """client.go:1086 compareFirstHeaderWithWitnesses: every witness
        that can serve the root's height must agree with the primary; a
        client with no witness does not start."""
        if not self._witnesses:
            raise ErrNoWitnesses(
                "no witnesses configured; cannot cross-check the root header"
            )
        compared = 0
        for i, w in enumerate(self._witnesses):
            try:
                wlb = w.light_block(root.height)
            except (OSError, ValueError, KeyError, TimeoutError,
                    ConnectionError, RuntimeError, _http.HTTPException):
                continue  # unreachable, or no block: the witness is ignored
            compared += 1
            if wlb.hash() != root.hash():
                raise ErrLightClientAttack(
                    f"witness {i} has a different header at the root height "
                    f"{root.height}: {wlb.hash().hex()} vs {root.hash().hex()}"
                )
        if compared == 0:
            raise ErrFailedHeaderCrossReferencing(
                f"none of the {len(self._witnesses)} configured witnesses "
                f"could serve the root header at height {root.height}"
            )

    # -- public API -------------------------------------------------------

    def verify_header(self, new_header, now: Optional[Timestamp] = None) -> None:
        """client.go:456 VerifyHeader: a header trusted already must match
        it; else the primary's header at its height must, before that
        height is verified."""
        if new_header is None:
            raise ValueError("nil header")
        if new_header.height <= 0:
            raise ValueError("negative or zero height")
        existing = self._store.light_block(new_header.height)
        if existing is not None:
            if existing.hash() != new_header.hash():
                raise ValueError(
                    f"existing trusted header {existing.hash().hex()} does not "
                    f"match newHeader {new_header.hash().hex()}"
                )
            return
        probe = self._light_block_from_primary(new_header.height)
        if probe.hash() != new_header.hash():
            raise ValueError(
                f"header from primary {probe.hash().hex()} does not match "
                f"newHeader {new_header.hash().hex()}"
            )
        lb = self.verify_light_block_at_height(new_header.height, now)
        if lb.hash() != new_header.hash():
            raise ValueError(
                f"verified header {lb.hash().hex()} does not match "
                f"newHeader {new_header.hash().hex()}"
            )

    def last_trusted_height(self) -> int:
        """client.go:801 (-1 when empty)."""
        lb = self._store.latest_light_block()
        return lb.height if lb is not None else -1

    def first_trusted_height(self) -> int:
        """client.go:809 (-1 when empty)."""
        return self._store.first_light_block_height()

    def chain_id(self) -> str:
        return self._chain_id

    def primary(self) -> Provider:
        return self._primary

    def witnesses(self) -> List[Provider]:
        return list(self._witnesses)

    def add_provider(self, p: Provider) -> None:
        """client.go:841."""
        self._witnesses.append(p)

    def remove_witnesses(self, indexes: List[int]) -> None:
        """client.go:975: drop witnesses, highest index first."""
        uniq = sorted(set(indexes), reverse=True)
        if any(i < 0 or i >= len(self._witnesses) for i in uniq):
            raise IndexError(f"witness index out of range: {indexes}")
        if len(self._witnesses) <= len(uniq):
            raise RuntimeError("cannot remove all witnesses")
        for i in uniq:
            self._witnesses.pop(i)

    def cleanup(self) -> None:
        """client.go:849: remove every stored light block."""
        self._store.prune(0)

    def trusted_light_block(self, height: int) -> Optional[LightBlock]:
        if height == 0:
            return self._store.latest_light_block()
        return self._store.light_block(height)

    def update(self, now: Optional[Timestamp] = None) -> Optional[LightBlock]:
        """client.go Update: verify the primary's latest header."""
        latest = self._primary.light_block(0)
        trusted = self._store.latest_light_block()
        if trusted is not None and latest.height <= trusted.height:
            return None
        return self.verify_light_block_at_height(latest.height, now)

    def verify_light_block_at_height(
        self, height: int, now: Optional[Timestamp] = None
    ) -> LightBlock:
        """client.go:406-487."""
        if height <= 0:
            raise ValueError("height must be positive")
        now = now or self._now_ts()
        existing = self._store.light_block(height)
        if existing is not None:
            return existing
        latest_trusted = self._store.latest_light_block()
        if latest_trusted is None:
            raise RuntimeError("no trusted state — client not initialized")
        if height < latest_trusted.height:
            return self._backwards(latest_trusted, height, now)
        new_block = self._light_block_from_primary(height)
        self._verify_light_block(new_block, now)
        return new_block

    # -- verification strategies -----------------------------------------

    def _verify_light_block(self, new_block: LightBlock, now: Timestamp) -> None:
        closest = self._store.light_block_before(new_block.height) or \
            self._store.latest_light_block()
        if self._sequential:
            self._verify_sequential(closest, new_block, now)
        else:
            self._verify_skipping_against_witnesses(closest, new_block, now)
        self._store.save_light_block(new_block)
        self._store.prune(self._pruning_size)

    def _verify_sequential(self, trusted: LightBlock, new_block: LightBlock,
                           now: Timestamp) -> None:
        """client.go:546-637: every header in between, each adjacent to
        the last."""
        current = trusted
        for h in range(trusted.height + 1, new_block.height + 1):
            interim = new_block if h == new_block.height else self._light_block_from_primary(h)
            verifier.verify_adjacent(
                current.signed_header,
                interim.signed_header,
                interim.validators,
                self._trusting_period,
                now,
                self._max_clock_drift,
                device=self._device,
            )
            self._store.save_light_block(interim)
            current = interim

    def _verify_skipping(self, source: Provider, trusted: LightBlock,
                         new_block: LightBlock, now: Timestamp) -> List[LightBlock]:
        """client.go:639-720 verifySkipping: on too little trust, bisect at
        the 9/16 pivot. Returns the verified trace, trusted block first."""
        blocks_to_verify = [new_block]
        depth = 0
        verified = [trusted]
        current = trusted
        while True:
            target = blocks_to_verify[depth]
            try:
                verifier.verify(
                    current.signed_header,
                    current.validators,
                    target.signed_header,
                    target.validators,
                    self._trusting_period,
                    now,
                    self._max_clock_drift,
                    self._trust_level,
                    device=self._device,
                )
                verified.append(target)
                if depth == 0:
                    return verified
                current = target
                depth -= 1
            except verifier.ErrNotEnoughTrust:
                pivot = (
                    current.height
                    + (target.height - current.height) * _BISECT_NUM // _BISECT_DEN
                )
                if pivot <= current.height:
                    pivot = current.height + 1
                if pivot >= target.height:
                    raise
                blocks_to_verify.append(self._light_block_from(source, pivot))
                depth += 1

    def _verify_skipping_against_witnesses(self, trusted: LightBlock,
                                           new_block: LightBlock, now: Timestamp) -> None:
        """client.go:722-780 and detector.go: verify against the primary,
        then hold the verified trace against every witness."""
        trace = self._verify_skipping(self._primary, trusted, new_block, now)
        self._detect_divergence(trace, now)

    # -- divergence detector (detector.go) --------------------------------

    def _detect_divergence(self, primary_trace: List[LightBlock], now: Timestamp) -> None:
        """detector.go:28-118 detectDivergence: compare the trace's last
        block with each witness's. A conflicting header is examined against
        the trace: when the witness sustains it, evidence goes to both
        sides and the client halts; a witness that cannot sustain it is
        dropped. No matching witness is ErrFailedHeaderCrossReferencing."""
        if not primary_trace or len(primary_trace) < 2:
            return  # nothing past the root of trust
        if not self._witnesses:
            raise ErrNoWitnesses("no witnesses connected. falling back to primary")
        last = primary_trace[-1]
        header_matched = False
        to_remove: List[int] = []
        for i, witness in enumerate(self._witnesses):
            try:
                w_block = witness.light_block(last.height)
            except (ErrLightBlockNotFound, ConnectionError):
                continue  # the witness has no such block (yet)
            if w_block.hash() != last.hash():
                # raises ErrLightClientAttack when the witness sustains it
                self._handle_conflicting_headers(primary_trace, w_block, i, now)
                to_remove.append(i)
            else:
                header_matched = True
        for i in reversed(to_remove):
            del self._witnesses[i]
        if not header_matched:
            raise ErrFailedHeaderCrossReferencing(
                "all witnesses have either not responded, don't have the "
                "block or sent invalid blocks"
            )

    def _handle_conflicting_headers(self, primary_trace: List[LightBlock],
                                    challenging_block: LightBlock, witness_index: int,
                                    now: Timestamp) -> None:
        """detector.go:228-290 handleConflictingHeaders: evidence against
        the primary with the witness as the source of truth, then against
        the witness with the primary as it; halts with
        ErrLightClientAttack either way."""
        witness = self._witnesses[witness_index]
        try:
            witness_trace, primary_block = self._examine_conflicting_header_against_trace(
                primary_trace, challenging_block, witness, now
            )
        except (ValueError, RuntimeError, ErrLightBlockNotFound, ConnectionError):
            return  # the witness cannot sustain its header: no proof of attack
        common, trusted_block = witness_trace[0], witness_trace[-1]
        self._send_evidence(make_attack_evidence(primary_block, trusted_block, common),
                            witness)
        try:
            primary_trace2, witness_block = self._examine_conflicting_header_against_trace(
                witness_trace, primary_block, self._primary, now
            )
            common2, trusted2 = primary_trace2[0], primary_trace2[-1]
            self._send_evidence(make_attack_evidence(witness_block, trusted2, common2),
                                self._primary)
        except (ValueError, RuntimeError, ErrLightBlockNotFound, ConnectionError):
            pass
        raise ErrLightClientAttack(
            f"conflicting header at height {challenging_block.height}: "
            f"witness #{witness_index} {challenging_block.hash().hex()} vs "
            f"primary {primary_trace[-1].hash().hex()}"
        )

    def _examine_conflicting_header_against_trace(self, trace: List[LightBlock],
                                                  target_block: LightBlock,
                                                  source: Provider, now: Timestamp) -> tuple:
        """detector.go:289-374 examineConflictingHeaderAgainstTrace: verify
        the source's chain at each height of the trace up to where the two
        part. Returns (the source's trace, the trace's block there)."""
        if target_block.height < trace[0].height:
            raise ValueError(
                f"target block height {target_block.height} below trusted "
                f"height {trace[0].height}"
            )
        previously_verified: Optional[LightBlock] = None
        source_trace: List[LightBlock] = []
        for idx, trace_block in enumerate(trace):
            if trace_block.height > target_block.height:
                # forward lunatic: the trace runs past the target
                tb_t = trace_block.signed_header.header.time
                tg_t = target_block.signed_header.header.time
                if (tb_t.seconds, tb_t.nanos) > (tg_t.seconds, tg_t.nanos):
                    raise RuntimeError(
                        "sanity: trace block after target must not be newer"
                    )
                if previously_verified.height != target_block.height:
                    source_trace = self._verify_skipping(
                        source, previously_verified, target_block, now
                    )
                return source_trace, trace_block
            if trace_block.height == target_block.height:
                source_block = target_block
            else:
                source_block = source.light_block(trace_block.height)
            if idx == 0:
                if source_block.hash() != trace_block.hash():
                    raise ValueError(
                        "trusted block differs from the source's first block"
                    )
                previously_verified = source_block
                continue
            source_trace = self._verify_skipping(source, previously_verified, source_block,
                                                 now)
            if source_block.hash() != trace_block.hash():
                return source_trace, trace_block  # where the two part
            previously_verified = source_block
        raise RuntimeError("no divergence found along the trace")

    def _send_evidence(self, ev, receiver: Provider) -> None:
        """detector.go:220-226 sendEvidence, best effort."""
        try:
            receiver.report_evidence(ev)
        except Exception:  # noqa: BLE001 — a provider's failure must not mask the halt
            pass

    def _backwards(self, trusted: LightBlock, height: int, now: Timestamp) -> LightBlock:
        """client.go:878-933: the hash-linked walk down to an older header."""
        current = trusted
        for h in range(trusted.height - 1, height - 1, -1):
            interim = self._light_block_from_primary(h)
            verifier.verify_backwards(interim.signed_header, current.signed_header)
            self._store.save_light_block(interim)
            current = interim
        return current

    # -- providers (client.go:935-1035) ------------------------------------

    def _light_block_from_primary(self, height: int) -> LightBlock:
        try:
            return self._primary.light_block(height)
        except (ErrLightBlockNotFound, ConnectionError):
            # the primary failed: promote a witness (client.go findNewPrimary)
            for i, w in enumerate(self._witnesses):
                try:
                    lb = w.light_block(height)
                except (ErrLightBlockNotFound, ConnectionError):
                    continue
                self._witnesses.pop(i)
                self._witnesses.append(self._primary)
                self._primary = w
                return lb
            raise

    def _light_block_from(self, source: Provider, height: int) -> LightBlock:
        if source is self._primary:
            return self._light_block_from_primary(height)
        return source.light_block(height)
