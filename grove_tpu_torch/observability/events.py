"""Kubernetes-style event recorder with dedup-and-count.

Counterpart of ``grove_tpu/observability/events.py``, cut to the reasons
the scheduler round records and the deferral details it and the explain
engine cite. ``record`` dedups on
(kind, namespace, name, type, reason), bumps ``count`` and keeps the latest
message; the oldest groups drop past ``max_events``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

TYPE_NORMAL = "Normal"
TYPE_WARNING = "Warning"

REASON_GANG_ADMITTED = "GangAdmitted"
REASON_GANG_DEFERRED = "GangDeferred"
REASON_POD_BOUND = "PodBound"
REASON_PREEMPTED = "Preempted"
# a gang held back because its queue is at its ceiling, and a scheduled
# gang evicted so a queue below its deserved share can place
REASON_QUEUE_PENDING = "QueuePending"
REASON_QUOTA_RECLAIM = "QuotaReclaim"

# deferral-detail slugs: GangDeferred / QueuePending messages start with one
DETAIL_NO_NODES = "no-schedulable-nodes"
DETAIL_INSUFFICIENT_CAPACITY = "insufficient-capacity"
DETAIL_TOPOLOGY_FRAGMENTATION = "topology-fragmentation"
DETAIL_NODE_FRAGMENTATION = "node-fragmentation"
DETAIL_UNSATISFIABLE = "unsatisfiable-constraint"
DETAIL_QUOTA_CEILING = "quota-ceiling"
# explain verdicts only: outcompeted in the solve order, and a monitor hold
DETAIL_QUEUE_POSITION = "queue-position"
DETAIL_DISRUPTION_HOLD = "disruption-hold"


@dataclass
class EventRecord:
    kind: str
    namespace: str
    name: str
    type: str
    reason: str
    message: str
    count: int
    first_timestamp: float
    last_timestamp: float


class EventRecorder:
    def __init__(self, max_events: int = 8192, clock=None) -> None:
        self.max_events = max_events
        self.clock = clock
        self._lock = threading.Lock()
        self._events: "OrderedDict[tuple, EventRecord]" = OrderedDict()

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else time.time()

    def record(self, obj_ref, type: str, reason: str, message: str) -> EventRecord:
        """obj_ref: a (kind, namespace, name) tuple or a typed API object."""
        if not isinstance(obj_ref, tuple):
            obj_ref = (obj_ref.kind, obj_ref.metadata.namespace, obj_ref.metadata.name)
        kind, namespace, name = obj_ref
        key = (kind, namespace, name, type, reason)
        now = self._now()
        with self._lock:
            rec = self._events.get(key)
            if rec is not None:
                rec.count += 1
                rec.last_timestamp = now
                rec.message = message
                self._events.move_to_end(key)
            else:
                rec = EventRecord(kind, namespace, name, type, reason, message, 1, now, now)
                self._events[key] = rec
                while len(self._events) > self.max_events:
                    self._events.popitem(last=False)
        return rec

    def reset(self) -> None:
        with self._lock:
            self._events.clear()


EVENTS = EventRecorder()
