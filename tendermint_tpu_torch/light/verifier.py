"""Light-client header verification.

Counterpart: tendermint_tpu/light/verifier.py (light/verifier.go):
VerifyAdjacent (:103), VerifyNonAdjacent (:33), Verify (:152),
VerifyBackwards (:201). The host checks (heights, trust level, expiry,
clock drift, the header's and the sets' hashes; span "light.checks")
run in the prepare_* functions, which return the signature work as
SigChecks; verify_* run them at once. The commit checks go through
types/validation (verify_commit_light, and verify_commit_light_trusting
against the trusted set), so through the port's kernels on `device`.
Errors are the reference's, byte for byte. The reference's
SigCheck.prepare, which ships a check through the asynchronous device
pipeline, waits for the port's dispatcher.
"""

from __future__ import annotations

from typing import Callable, List

from torch.profiler import record_function

from ..device import resolve_device
from ..types.block import SignedHeader
from ..types.validation import (  # noqa: F401 — DEFAULT_TRUST_LEVEL: light.DefaultTrustLevel
    DEFAULT_TRUST_LEVEL,
    Fraction,
    verify_commit_light,
    verify_commit_light_trusting,
)
from ..types.validator_set import ErrNotEnoughVotingPowerSigned, ValidatorSet
from ..wire.canonical import Timestamp


class ErrNotEnoughTrust(ValueError):
    """verifier.go ErrNewValSetCantBeTrusted."""


class ErrInvalidHeader(ValueError):
    pass


class ErrOldHeaderExpired(ValueError):
    pass


def _ts_add(ts: Timestamp, seconds: float) -> Timestamp:
    total_ns = ts.seconds * 10**9 + ts.nanos + int(seconds * 1e9)
    return Timestamp(seconds=total_ns // 10**9, nanos=total_ns % 10**9)


def _ts_before(a: Timestamp, b: Timestamp) -> bool:
    return (a.seconds, a.nanos) < (b.seconds, b.nanos)


def header_expired(h: SignedHeader, trusting_period: float, now: Timestamp) -> bool:
    """verifier.go HeaderExpired: expired from header.Time + trustingPeriod on."""
    return not _ts_before(now, _ts_add(h.header.time, trusting_period))


def validate_trust_level(lvl: Fraction) -> None:
    """verifier.go ValidateTrustLevel: within [1/3, 1]."""
    if (
        lvl.numerator * 3 < lvl.denominator
        or lvl.numerator > lvl.denominator
        or lvl.denominator == 0
    ):
        raise ValueError(f"trustLevel must be within [1/3, 1], given {lvl}")


def verify_new_header_and_vals(
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusted_header: SignedHeader,
    now: Timestamp,
    max_clock_drift: float,
) -> None:
    """verifier.go:236-283 verifyNewHeaderAndVals."""
    chain_id = trusted_header.header.chain_id
    try:
        untrusted_header.validate_basic(chain_id)
    except ValueError as e:
        raise ErrInvalidHeader(f"untrustedHeader.ValidateBasic failed: {e}") from e
    if untrusted_header.header.height <= trusted_header.header.height:
        raise ErrInvalidHeader(
            f"expected new header height {untrusted_header.header.height} to be greater "
            f"than one of old header {trusted_header.header.height}"
        )
    if not _ts_before(trusted_header.header.time, untrusted_header.header.time):
        raise ErrInvalidHeader("expected new header time to be after old header time")
    if not _ts_before(untrusted_header.header.time, _ts_add(now, max_clock_drift)):
        raise ErrInvalidHeader(
            "new header has a time from the future (max clock drift exceeded)"
        )
    if untrusted_header.header.validators_hash != untrusted_vals.hash():
        raise ErrInvalidHeader(
            f"expected new header validators ({untrusted_header.header.validators_hash.hex()}) "
            f"to match those supplied ({untrusted_vals.hash().hex()})"
        )


class SigCheck:
    """One commit-signature check of a header verification: run_sync()
    calls the types/validation entry point and raises what it raises,
    wrapped as the reference wraps it."""

    __slots__ = ("kind", "_run", "_wrap")

    def __init__(self, kind: str, run: Callable[[], None],
                 wrap: Callable[[BaseException], BaseException]):
        self.kind = kind
        self._run = run
        self._wrap = wrap

    def run_sync(self) -> None:
        try:
            self._run()
        except Exception as e:  # noqa: BLE001 — the wrapper decides
            w = self._wrap(e)
            if w is e:
                raise
            raise w from e


def _wrap_trusting(e: BaseException) -> BaseException:
    """The trusting check's wrapping (verifier.go:67-80): too little
    power is a trust failure (the client bisects), any other commit
    defect an invalid header."""
    if isinstance(e, ErrNotEnoughVotingPowerSigned):
        return ErrNotEnoughTrust(str(e))
    if isinstance(e, ValueError):
        return ErrInvalidHeader(str(e))
    return e


def _wrap_light(e: BaseException) -> BaseException:
    """The +2/3 check's wrapping (verifier.go:143-148): any commit defect
    is an invalid header."""
    if isinstance(e, ErrInvalidHeader):
        return e
    if isinstance(e, ValueError):
        return ErrInvalidHeader(str(e))
    return e


def _light_check(chain_id: str, vals: ValidatorSet, block_id, height: int,
                 commit, device) -> SigCheck:
    return SigCheck(
        "light",
        run=lambda: verify_commit_light(chain_id, vals, block_id, height, commit,
                                        device=device),
        wrap=_wrap_light,
    )


def _trusting_check(chain_id: str, vals: ValidatorSet, commit,
                    trust_level: Fraction, device) -> SigCheck:
    return SigCheck(
        "trusting",
        run=lambda: verify_commit_light_trusting(chain_id, vals, commit, trust_level,
                                                 device=device),
        wrap=_wrap_trusting,
    )


def prepare_adjacent(
    trusted_header: SignedHeader,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period: float,
    now: Timestamp,
    max_clock_drift: float,
    *,
    device=None,
) -> List[SigCheck]:
    """verifier.go:103-150's host checks; returns the signature work (one
    +2/3 commit check)."""
    device = resolve_device(device)
    with record_function("light.checks"):
        if untrusted_header.header.height != trusted_header.header.height + 1:
            raise ValueError("headers must be adjacent in height")
        if header_expired(trusted_header, trusting_period, now):
            raise ErrOldHeaderExpired(f"old header has expired at {now}")
        verify_new_header_and_vals(
            untrusted_header, untrusted_vals, trusted_header, now, max_clock_drift
        )
        # the validator hashes chain (verifier.go:134-142)
        if (untrusted_header.header.validators_hash
                != trusted_header.header.next_validators_hash):
            raise ErrInvalidHeader(
                "expected old header next validators "
                f"({trusted_header.header.next_validators_hash.hex()}) "
                f"to match those from new header ({untrusted_header.header.validators_hash.hex()})"
            )
    return [
        _light_check(
            trusted_header.header.chain_id,
            untrusted_vals,
            untrusted_header.commit.block_id,
            untrusted_header.header.height,
            untrusted_header.commit,
            device,
        )
    ]


def prepare_non_adjacent(
    trusted_header: SignedHeader,
    trusted_vals: ValidatorSet,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period: float,
    now: Timestamp,
    max_clock_drift: float,
    trust_level: Fraction,
    *,
    device=None,
) -> List[SigCheck]:
    """verifier.go:33-101's host checks; returns the signature work in
    order: the trust-level check against the trusted set, then the +2/3
    check of the new set."""
    device = resolve_device(device)
    with record_function("light.checks"):
        if untrusted_header.header.height == trusted_header.header.height + 1:
            raise ValueError("headers must be non adjacent in height")
        validate_trust_level(trust_level)
        if header_expired(trusted_header, trusting_period, now):
            raise ErrOldHeaderExpired(f"old header has expired at {now}")
        verify_new_header_and_vals(
            untrusted_header, untrusted_vals, trusted_header, now, max_clock_drift
        )
    chain_id = trusted_header.header.chain_id
    return [
        _trusting_check(chain_id, trusted_vals, untrusted_header.commit, trust_level,
                        device),
        _light_check(
            chain_id,
            untrusted_vals,
            untrusted_header.commit.block_id,
            untrusted_header.header.height,
            untrusted_header.commit,
            device,
        ),
    ]


def prepare_verify(
    trusted_header: SignedHeader,
    trusted_vals: ValidatorSet,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period: float,
    now: Timestamp,
    max_clock_drift: float,
    trust_level: Fraction,
    *,
    device=None,
) -> List[SigCheck]:
    """verifier.go:152-176 Verify's dispatch, over the prepare functions."""
    if untrusted_header.header.height != trusted_header.header.height + 1:
        return prepare_non_adjacent(
            trusted_header, trusted_vals, untrusted_header, untrusted_vals,
            trusting_period, now, max_clock_drift, trust_level, device=device,
        )
    return prepare_adjacent(
        trusted_header, untrusted_header, untrusted_vals,
        trusting_period, now, max_clock_drift, device=device,
    )


def verify_adjacent(
    trusted_header: SignedHeader,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period: float,
    now: Timestamp,
    max_clock_drift: float,
    *,
    device=None,
) -> None:
    """verifier.go:103-150: the header checks, then the new commit's +2/3
    on `device`; any commit defect is an ErrInvalidHeader."""
    for chk in prepare_adjacent(
        trusted_header, untrusted_header, untrusted_vals,
        trusting_period, now, max_clock_drift, device=device,
    ):
        chk.run_sync()


def verify_non_adjacent(
    trusted_header: SignedHeader,
    trusted_vals: ValidatorSet,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period: float,
    now: Timestamp,
    max_clock_drift: float,
    trust_level: Fraction,
    *,
    device=None,
) -> None:
    """verifier.go:33-101: the header checks, the trusting check against
    the trusted set, then the new commit's +2/3, on `device`."""
    for chk in prepare_non_adjacent(
        trusted_header, trusted_vals, untrusted_header, untrusted_vals,
        trusting_period, now, max_clock_drift, trust_level, device=device,
    ):
        chk.run_sync()


def verify(
    trusted_header: SignedHeader,
    trusted_vals: ValidatorSet,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period: float,
    now: Timestamp,
    max_clock_drift: float,
    trust_level: Fraction,
    *,
    device=None,
) -> None:
    """verifier.go:152-176 Verify: adjacent or non-adjacent."""
    for chk in prepare_verify(
        trusted_header, trusted_vals, untrusted_header, untrusted_vals,
        trusting_period, now, max_clock_drift, trust_level, device=device,
    ):
        chk.run_sync()


def verify_backwards(untrusted_header: SignedHeader, trusted_header: SignedHeader) -> None:
    """verifier.go:201-234: an older header, linked by hash."""
    with record_function("light.checks"):
        if untrusted_header.header.chain_id != trusted_header.header.chain_id:
            raise ErrInvalidHeader("header belongs to another chain")
        if not _ts_before(untrusted_header.header.time, trusted_header.header.time):
            raise ErrInvalidHeader(
                "expected older header time to be before newer header time"
            )
        if trusted_header.header.last_block_id.hash != untrusted_header.header.hash():
            raise ErrInvalidHeader(
                f"older header hash {untrusted_header.header.hash().hex()} does not match "
                f"trusted header's last block {trusted_header.header.last_block_id.hash.hex()}"
            )
