"""Batched light-client verification plans.

Counterpart: tendermint_tpu/light/batch.py. One request is a (trusted,
untrusted) header pair with its trust parameters. prepare_request runs
every host check through the light verifier's prepare functions (the
code the sequential verifier runs) and takes each signature check's
work as an EntryBlock with its epoch metadata (SigCheck.prepare); the
service ships those blocks through the device's dispatcher, where one
epoch's work from many requests fuses into one batch; conclude_request
applies the verdict rows back in the sequential stage order, so every
error, and which error wins, is the sequential verifier's:

  * a host failure while preparing stage k is recorded on stage k, and
    later stages are not prepared (the sequential verifier never
    reached them);
  * verdicts are applied in stage order: stage k's signature failure
    masks anything recorded for stage k + 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..types.validation import DEFAULT_TRUST_LEVEL, Fraction
from ..wire.canonical import Timestamp
from . import verifier

# light/client.go:56 (client.DEFAULT_MAX_CLOCK_DRIFT)
DEFAULT_MAX_CLOCK_DRIFT = 10.0


@dataclass
class HeaderRequest:
    """Skip-verify `untrusted_header` from `trusted_header`
    (light/verifier.go Verify). Without `now` the service reads its clock
    once a submit_many call."""

    trusted_header: object  # SignedHeader
    trusted_vals: object  # ValidatorSet
    untrusted_header: object  # SignedHeader
    untrusted_vals: object  # ValidatorSet
    trusting_period: float
    max_clock_drift: float = DEFAULT_MAX_CLOCK_DRIFT
    trust_level: Fraction = DEFAULT_TRUST_LEVEL
    now: Optional[Timestamp] = None


def fingerprint(req: HeaderRequest, now: Timestamp) -> Optional[tuple]:
    """The memo and single-flight key: both header hashes, the untrusted
    commit's hash (a forged commit under a genuine header must not alias
    a clean request), both sets' hashes, every trust parameter and the
    resolved `now`. None when a header hashes to b"" (an incomplete
    header): such requests would alias each other, so they verify
    alone."""
    th = req.trusted_header.header.hash()
    uh = req.untrusted_header.header.hash()
    if not th or not uh:
        return None
    return (
        th,
        uh,
        req.untrusted_header.commit.hash(),
        req.trusted_vals.hash(),
        req.untrusted_vals.hash(),
        float(req.trusting_period),
        float(req.max_clock_drift),
        req.trust_level.numerator,
        req.trust_level.denominator,
        now.seconds,
        now.nanos,
    )


@dataclass
class StagePlan:
    """One prepared signature check: entries and conclude, or error, or
    neither (the check finished at prepare time and passed)."""

    kind: str
    entries: object = None
    conclude: Optional[Callable] = None
    error: Optional[BaseException] = None


@dataclass
class RequestPlan:
    stages: List[StagePlan] = field(default_factory=list)
    error: Optional[BaseException] = None  # a host check's failure, before any signature

    def entry_stages(self) -> List[StagePlan]:
        return [s for s in self.stages if s.entries is not None]


def prepare_request(req: HeaderRequest, now: Timestamp, *, device=None) -> RequestPlan:
    """The host half of one request: the header checks and the
    signature work. Never raises: failures land in the plan. `device`
    is where a check the seam cannot represent runs synchronously."""
    try:
        checks = verifier.prepare_verify(
            req.trusted_header, req.trusted_vals,
            req.untrusted_header, req.untrusted_vals,
            req.trusting_period, now, req.max_clock_drift, req.trust_level,
            device=device,
        )
    except Exception as e:  # any host-check error is the request's verdict
        return RequestPlan(error=e)
    plan = RequestPlan()
    for chk in checks:
        try:
            entries, conclude = chk.prepare()
        except Exception as e:  # the stage's verdict; later stages never run
            plan.stages.append(StagePlan(chk.kind, error=e))
            break
        plan.stages.append(StagePlan(chk.kind, entries=entries, conclude=conclude))
    return plan


def conclude_request(plan: RequestPlan, verdicts) -> Optional[BaseException]:
    """Apply the verdicts in stage order. `verdicts` has one item per
    entry_stages() entry, in order: a bool validity row, or the
    exception its future resolved with. Returns the request's error (the
    sequential verifier's) or None."""
    if plan.error is not None:
        return plan.error
    vi = 0
    for st in plan.stages:
        if st.error is not None:
            return st.error
        if st.entries is None:
            continue  # verified at prepare time
        v = verdicts[vi]
        vi += 1
        if isinstance(v, BaseException):
            return v  # the dispatcher failed the batch (DispatchError)
        try:
            st.conclude(v)
        except Exception as e:  # the stage's wrapped error
            return e
    return None


def group_stats(plans) -> Dict[Optional[bytes], int]:
    """Stage blocks per epoch key across plans: what the dispatcher can
    fuse."""
    groups: Dict[Optional[bytes], int] = {}
    for p in plans:
        for st in p.entry_stages():
            k = st.entries.epoch_key
            groups[k] = groups.get(k, 0) + 1
    return groups
