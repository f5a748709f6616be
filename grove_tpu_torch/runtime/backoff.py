"""One deterministic-jitter backoff policy for every retry loop.

Counterpart of ``grove_tpu/runtime/backoff.py``: the work queue's rate
limiter and the node-health monitor's gang requeue backoff share one curve,

    delay(key, failures) = min(base · 2^failures · (1 + J·u), cap)

where u ∈ [0, 1) is a crc32 of ``f"{key}:{failures}"``: deterministic per
(key, failures) across processes and replays (crc32, never ``hash()``), so
the port releases keys in the JAX package's order. J < 1 keeps growth
strictly monotone in ``failures``.
"""

from __future__ import annotations

import zlib

# client-go-style 5ms reconcile base; coarser consumers (gang requeue
# after node failure) pick a second-scale base with a tighter cap
BASE_BACKOFF = 0.005
# HARD cap on the delay, applied AFTER jitter: no key ever waits longer
# than this between retries, however many times it failed
# (tests/test_runtime.py pins the cap and the monotone growth toward it)
MAX_BACKOFF = 1000.0
# multiplicative jitter span on the exponential backoff: many keys
# failing in the same instant (a node loss requeueing every affected
# gang, a store outage failing a whole drain round) must not retry in
# one synchronized burst
JITTER_FRAC = 0.1


class BackoffPolicy:
    """Deterministic-jitter exponential backoff curve.

    Stateless with respect to failure counts — callers own their own
    failure bookkeeping (the workqueue's per-key dict, a retransmit
    loop's attempt counter) and ask the policy only for the delay. That
    keeps one instance shareable across keys and threads with no locks.
    """

    def __init__(
        self,
        base: float = BASE_BACKOFF,
        cap: float = MAX_BACKOFF,
        jitter_frac: float = JITTER_FRAC,
    ) -> None:
        self.base = base
        self.cap = cap
        self.jitter_frac = jitter_frac

    def jitter_u(self, key, failures: int) -> float:
        """The deterministic jitter draw u ∈ [0, 1) for (key, failures).

        ``key`` is formatted with ``f"{key}:..."`` — tuples keep their
        repr, so WorkQueue keys hash to the exact same token bytes the
        inline formula produced (the byte-identical A/B pin).
        """
        return (
            zlib.crc32(f"{key}:{failures}".encode()) & 0xFFFF
        ) / float(1 << 16)

    def delay(self, key, failures: int) -> float:
        """Backoff delay for the ``failures``-th consecutive failure of
        ``key`` (0-based: the first failure gets roughly ``base``)."""
        return min(
            self.base * (2**failures) * (1.0 + self.jitter_frac * self.jitter_u(key, failures)),
            self.cap,
        )
