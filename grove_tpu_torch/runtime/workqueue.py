"""Keyed work queue with dedup, delayed re-adds and per-key backoff.

Counterpart of ``grove_tpu/runtime/workqueue.py``: the single-process,
virtual-time equivalent of client-go's rate-limited workqueue. Items are
(kind, namespace, name) keys, deduped while pending. With ``num_shards >
1`` ready keys are bucketed by ``shard_of`` of their namespace and popped
round-robin across non-empty buckets; the delayed heap stays global and
time-ordered (ties in insertion order). One popping thread only.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Set, Tuple

# the rate-limiter curve and its constants live in runtime/backoff.py —
# the one deterministic-jitter policy shared by every retry loop in the
# tree; re-exported here because this was their historical home and
# consumers (and tests) import them from the queue
from grove_tpu_torch.runtime.backoff import (  # noqa: F401  (re-export)
    BASE_BACKOFF,
    JITTER_FRAC,
    MAX_BACKOFF,
    BackoffPolicy,
)
from grove_tpu_torch.runtime.shards import shard_of

Key = Tuple[str, str, str]  # (kind, namespace, name)
# a zero (or negative) requeue delay would make the key ready again within
# the SAME engine drain round — `Engine.drain` freezes `now` per call and
# drains each controller's whole ready set, so the re-add would livelock
# inside one round, bypassing the max_rounds backstop. Floor every delayed
# re-add at a strictly positive epsilon: the key lands in the NEXT drain.
# 1us, NOT something tinier: `now` under the wall Clock is ~1.7e9 where the
# float64 ULP is ~2.4e-7 — an epsilon below that would vanish in the
# addition and resurrect the livelock.
MIN_DELAY = 1e-6


@dataclass(order=True)
class _Delayed:
    ready_at: float
    seq: int
    key: Key


class WorkQueue:
    def __init__(
        self,
        base_backoff: float = BASE_BACKOFF,
        max_backoff: float = MAX_BACKOFF,
        num_shards: int = 1,
    ) -> None:
        # per-instance rate-limiter curve: reconcile queues keep the
        # client-go-style 5ms base, while coarser consumers (gang requeue
        # after node failure) pick a second-scale base with a tighter cap
        self.policy = BackoffPolicy(base=base_backoff, cap=max_backoff)
        self.num_shards = max(1, num_shards)
        # per-shard ready buckets + rotation pointer (module docstring);
        # one bucket at num_shards=1 keeps the historical FIFO exactly
        self._buckets: List[Deque[Key]] = [
            deque() for _ in range(self.num_shards)
        ]
        self._rotation = 0
        # namespace -> bucket memo (the keyspace map is immutable per
        # queue; crc32 per add is measurable at stress volume)
        self._bucket_memo: Dict[str, Deque[Key]] = {}
        self._ready_count = 0
        self._pending: Set[Key] = set()
        self._delayed: List[_Delayed] = []
        self._seq = itertools.count()
        self._failures: Dict[Key, int] = {}

    @property
    def base_backoff(self) -> float:
        return self.policy.base

    @property
    def max_backoff(self) -> float:
        return self.policy.cap

    def _bucket_of(self, key: Key) -> Deque[Key]:
        if self.num_shards == 1:
            return self._buckets[0]
        # key[1] is the namespace — the same keyspace map the store routes
        # writes with, so a shard's reconcile traffic is exactly its slice
        bucket = self._bucket_memo.get(key[1])
        if bucket is None:
            bucket = self._buckets[shard_of(key[1], self.num_shards)]
            self._bucket_memo[key[1]] = bucket
        return bucket

    def add(self, key: Key) -> None:
        if key not in self._pending:
            self._pending.add(key)
            self._bucket_of(key).append(key)
            self._ready_count += 1

    def add_after(self, key: Key, delay: float, now: float) -> None:
        delay = max(delay, MIN_DELAY)
        heapq.heappush(self._delayed, _Delayed(now + delay, next(self._seq), key))

    def add_rate_limited(self, key: Key, now: float) -> None:
        """Exponential per-key backoff with deterministic jitter, capped at
        MAX_BACKOFF (client-go ItemExponentialFailureRateLimiter + the
        bucket limiter's ceiling). The curve is runtime/backoff.py's
        BackoffPolicy — byte-identical to the formula that used to live
        inline here (tests/test_runtime.py pins the A/B)."""
        failures = self._failures.get(key, 0)
        delay = self.policy.delay(key, failures)
        self._failures[key] = failures + 1
        self.add_after(key, delay, now)

    def failures(self, key: Key) -> int:
        """Consecutive rate-limited failures recorded for the key."""
        return self._failures.get(key, 0)

    def forget(self, key: Key) -> None:
        self._failures.pop(key, None)

    def discard_delayed(self, key: Key) -> int:
        """Drop every not-yet-promoted delayed entry for `key` (O(delayed)).
        For consumers that release a key out of band (e.g. the node-health
        monitor when capacity returns): an orphaned heap entry would later
        pop and grant the key an extra, unscheduled release."""
        before = len(self._delayed)
        self._delayed = [d for d in self._delayed if d.key != key]
        if len(self._delayed) != before:
            heapq.heapify(self._delayed)
        return before - len(self._delayed)

    def _promote_delayed(self, now: float) -> None:
        while self._delayed and self._delayed[0].ready_at <= now:
            item = heapq.heappop(self._delayed)
            self.add(item.key)

    def pop(self, now: float) -> Optional[Key]:
        """Next ready key: FIFO within a shard bucket, deterministic
        round-robin across buckets (the pointer advances past each served
        shard, so consecutive pops rotate shards while any other bucket
        has work — the per-shard fairness pin in tests/test_runtime.py)."""
        self._promote_delayed(now)
        if not self._ready_count:
            return None
        for off in range(self.num_shards):
            idx = (self._rotation + off) % self.num_shards
            bucket = self._buckets[idx]
            if bucket:
                key = bucket.popleft()
                self._pending.discard(key)
                self._ready_count -= 1
                self._rotation = (idx + 1) % self.num_shards
                return key
        return None

    def next_delayed_at(self) -> Optional[float]:
        return self._delayed[0].ready_at if self._delayed else None

    def has_delayed(self, key: Key) -> bool:
        """True while a not-yet-promoted delayed entry exists for the key —
        the chaos harness asserts every monitor-held gang keeps one (a hold
        with no scheduled release would be stranded forever)."""
        return any(d.key == key for d in self._delayed)

    def __len__(self) -> int:
        return self._ready_count

    def empty(self, now: float) -> bool:
        self._promote_delayed(now)
        return not self._ready_count
