"""Light-client verification as a service: many clients' requests over
one device dispatcher.

Counterpart: tendermint_tpu/light/service.py (VerdictBatch,
LightVerifyService :124, request_from_json, request_to_json). Each
request's header checks run on the host through the light verifier's
prepare functions (light/batch.py), and its signature checks go as
EntryBlocks (epoch key and validator rows attached) into the device's
shared AsyncBatchVerifier (ops/pipeline.py), where the work of one
validator set from many requests fuses into one batch. Verdicts stream
back per request as batches resolve, in completion order, each equal to
what the sequential light.verifier.verify gives for the request: the
same outcome, error type and string.

On top of the batching: identical requests in flight share one
verification (single flight), and resolved verdicts are kept in a
bounded LRU keyed on the request's full fingerprint with the resolved
`now` (light/batch.fingerprint), so a forged commit or another clock
never reads a clean verdict. A failure of the dispatcher (a
DispatchError) is reported and never kept.

Not ported: the reference's ingress-fabric lane (ops/ingress.py; the
port submits at the consensus class, as that lane does), its flow
tracing, and the environment knobs of the in-flight bound and the memo
size, which are constructor arguments with the reference's defaults.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import OrderedDict
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..libs.timeutil import now_ts as _now_ts
from ..ops import pipeline as _pl
from ..wire.canonical import Timestamp
from . import batch as _lb

DEFAULT_MAX_INFLIGHT = 256
DEFAULT_MEMO_SIZE = 4096


class VerdictBatch:
    """The stream of one submit_many(): verdicts in completion order,
    each {"index", "height", "ok", "error", "error_type"}, `index` the
    request's position in the submitted list. Iterate for the stream;
    results() collects them in index order."""

    def __init__(self, n: int):
        self._n = n
        self._q: "_queue.Queue[dict]" = _queue.Queue()

    def __len__(self) -> int:
        return self._n

    def _push(self, verdict: dict) -> None:
        self._q.put(verdict)

    def stream(self, timeout: Optional[float] = None) -> Iterator[dict]:
        """Yield verdicts as they complete. `timeout` is a deadline for
        the whole batch; past it, TimeoutError names the verdicts still
        pending."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for i in range(self._n):
            wait = None if deadline is None else max(deadline - time.monotonic(), 0.0)
            try:
                yield self._q.get(timeout=wait)
            except _queue.Empty:
                raise TimeoutError(f"timed out with {self._n - i} of {self._n} light "
                                   "verdicts still pending") from None

    def __iter__(self) -> Iterator[dict]:
        return self.stream()

    def results(self, timeout: Optional[float] = None) -> List[dict]:
        return sorted(self.stream(timeout=timeout), key=lambda v: v["index"])


class _Pending:
    """One unique verification in flight and the requests waiting on it.
    `infra` marks a failure of the dispatcher, never memoized."""

    __slots__ = ("fp", "height", "waiters", "acquired", "infra")

    def __init__(self, fp: Optional[tuple], height: int):
        self.fp = fp
        self.height = height
        self.waiters: List[tuple] = []  # (index, VerdictBatch)
        self.acquired = False
        self.infra = False


class LightVerifyService:
    """Batched light-client verification over a dispatcher (`verifier`,
    default the shared one of `device`). Thread-safe: submit_many() may
    be called from any thread and blocks only on the in-flight bound
    (`max_inflight` unique verifications)."""

    def __init__(self, verifier: Optional[_pl.AsyncBatchVerifier] = None, now_fn=None,
                 max_inflight: int = DEFAULT_MAX_INFLIGHT, memo_size: int = DEFAULT_MEMO_SIZE,
                 *, device=None):
        self._v = verifier if verifier is not None else _pl.shared_verifier(device)
        self._now_fn = now_fn or _now_ts
        self._sem = threading.Semaphore(max(int(max_inflight), 1))
        self._memo_cap = max(int(memo_size), 0)
        self._memo: "OrderedDict[tuple, dict]" = OrderedDict()
        self._mtx = threading.Lock()
        self._inflight: dict = {}  # fingerprint -> _Pending
        self._closed = False
        self._stats = {"requests": 0, "memo_hits": 0, "inflight_joins": 0,
                       "unique": 0, "rejected": 0}

    # -- submission --------------------------------------------------------

    def submit(self, req: _lb.HeaderRequest, now: Optional[Timestamp] = None,
               timeout: Optional[float] = None) -> dict:
        """One request, blocking (at most `timeout` seconds): its verdict."""
        return self.submit_many([req], now=now).results(timeout=timeout)[0]

    def submit_many(self, requests: Sequence[_lb.HeaderRequest],
                    now: Optional[Timestamp] = None) -> VerdictBatch:
        """Submit a batch; returns its VerdictBatch at once. `now` (or one
        reading of the service's clock, whole seconds) applies to every
        request that does not carry its own."""
        reqs = list(requests)
        out = VerdictBatch(len(reqs))
        if not reqs:
            return out
        if self._closed:
            raise RuntimeError("light verify service is closed")
        batch_now = now or self._resolved_now()
        for i, req in enumerate(reqs):
            self._submit_one(req, i, out, batch_now)
        return out

    def _resolved_now(self) -> Timestamp:
        """One clock reading, cut to whole seconds: `now` is part of the
        fingerprint, so a nanosecond clock would keep identical requests
        of two calls from ever sharing a memo slot. The cut `now` is also
        the one verified against, so key and verdict agree."""
        ts = self._now_fn()
        return ts if ts.nanos == 0 else Timestamp(seconds=ts.seconds, nanos=0)

    def _submit_one(self, req, index: int, out: VerdictBatch, batch_now: Timestamp) -> None:
        rnow = req.now or batch_now
        try:
            fp = _lb.fingerprint(req, rnow)
        except Exception as e:  # an unhashable request is its own verdict
            out._push({"index": index, "height": "0", "ok": False,
                       "error": f"malformed request: {e}", "error_type": type(e).__name__})
            return
        with self._mtx:
            self._stats["requests"] += 1
            hit = self._memo.get(fp) if fp is not None else None
            if hit is not None:
                self._memo.move_to_end(fp)
                self._stats["memo_hits"] += 1
                out._push(dict(hit, index=index))
                return
            pend = self._inflight.get(fp) if fp is not None else None
            if pend is not None:
                self._stats["inflight_joins"] += 1
                pend.waiters.append((index, out))
                return
            pend = _Pending(fp, req.untrusted_header.header.height)
            pend.waiters.append((index, out))
            if fp is not None:
                self._inflight[fp] = pend
        self._verify_unique(req, rnow, pend)

    # -- one unique verification ---------------------------------------------

    def _verify_unique(self, req, rnow: Timestamp, pend: _Pending) -> None:
        plan = _lb.prepare_request(req, rnow, device=self._v.device)
        entry_stages = plan.entry_stages()
        if not entry_stages:
            self._finish(pend, plan, [])
            return
        self._sem.acquire()
        pend.acquired = True
        try:
            futs = [self._v.submit(st.entries)
                    for st in entry_stages]
        except Exception as e:  # a closed or failed dispatcher: not memoized
            pend.infra = True
            for st in entry_stages:
                st.entries, st.error = None, e
            self._finish(pend, plan, [])
            return
        remaining = [len(futs)]
        done_mtx = threading.Lock()

        def on_done(_f) -> None:
            with done_mtx:
                remaining[0] -= 1
                if remaining[0]:
                    return
            verdicts: List[object] = []
            for f in futs:
                try:
                    verdicts.append(np.array(f.result(), dtype=bool))
                except Exception as e:  # the dispatcher's failure is the verdict
                    verdicts.append(e)
            self._finish(pend, plan, verdicts)

        for f in futs:
            f.add_done_callback(on_done)

    def _finish(self, pend: _Pending, plan, verdicts) -> None:
        err = _lb.conclude_request(plan, verdicts)
        # an error that is one of the futures' own exceptions is the
        # dispatcher's: a retry may succeed, so it is never memoized
        infra = pend.infra or any(isinstance(v, BaseException) and v is err for v in verdicts)
        verdict = {
            "height": str(pend.height),
            "ok": err is None,
            "error": None if err is None else str(err),
            "error_type": None if err is None else type(err).__name__,
        }
        with self._mtx:
            if pend.fp is not None:
                self._inflight.pop(pend.fp, None)
            self._stats["unique"] += 1
            if err is not None:
                self._stats["rejected"] += 1
            if self._memo_cap and pend.fp is not None and not infra:
                self._memo[pend.fp] = verdict
                while len(self._memo) > self._memo_cap:
                    self._memo.popitem(last=False)
            waiters, pend.waiters = pend.waiters, []
        if pend.acquired:
            self._sem.release()
        for index, out in waiters:
            out._push(dict(verdict, index=index))

    # -- state ---------------------------------------------------------------

    def stats(self) -> dict:
        with self._mtx:
            s = dict(self._stats)
            s["memo_entries"] = len(self._memo)
            s["inflight"] = len(self._inflight)
        return s

    def close(self) -> None:
        """Take no more requests. The dispatcher is shared and stays."""
        self._closed = True


# -- the JSON forms of a request ----------------------------------------------------


def request_from_json(d: dict) -> _lb.HeaderRequest:
    """One request object: headers and sets in the /commit and
    /validators JSON shapes (wire/json_types.py), trust parameters as
    numbers."""
    from ..types.validation import Fraction
    from ..wire.json_types import parse_signed_header, parse_time, parse_validator_set

    tl = d.get("trust_level") or {}
    now = d.get("now")
    return _lb.HeaderRequest(
        trusted_header=parse_signed_header(d["trusted_header"]),
        trusted_vals=parse_validator_set(d["trusted_validators"]),
        untrusted_header=parse_signed_header(d["untrusted_header"]),
        untrusted_vals=parse_validator_set(d["untrusted_validators"]),
        trusting_period=float(d["trusting_period"]),
        max_clock_drift=float(d.get("max_clock_drift", _lb.DEFAULT_MAX_CLOCK_DRIFT)),
        trust_level=Fraction(int(tl.get("numerator", 1)), int(tl.get("denominator", 3))),
        now=parse_time(now) if now else None,
    )


def request_to_json(req: _lb.HeaderRequest) -> dict:
    """The inverse of request_from_json."""
    from ..wire.json_types import signed_header_to_json, time_to_json, validator_set_to_json

    out = {
        "trusted_header": signed_header_to_json(req.trusted_header),
        "trusted_validators": validator_set_to_json(req.trusted_vals),
        "untrusted_header": signed_header_to_json(req.untrusted_header),
        "untrusted_validators": validator_set_to_json(req.untrusted_vals),
        "trusting_period": req.trusting_period,
        "max_clock_drift": req.max_clock_drift,
        "trust_level": {"numerator": req.trust_level.numerator,
                        "denominator": req.trust_level.denominator},
    }
    if req.now is not None:
        out["now"] = time_to_json(req.now)
    return out
