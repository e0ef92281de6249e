"""The wall clock as a Timestamp.

Counterpart: tendermint_tpu/libs/timeutil.py. The light client reads the
time through an injected clock (light/client.Client's `now_fn`); this is
its default.
"""

from __future__ import annotations

import time

from ..wire.canonical import Timestamp


def now_ts() -> Timestamp:
    """The current wall clock as a wire.canonical.Timestamp."""
    t = time.time()
    return Timestamp(seconds=int(t), nanos=int((t % 1) * 1e9))
