"""Kubernetes-style event recorder with dedup-and-count.

Counterpart of ``grove_tpu/observability/events.py``, with its reasons
(the closed set ``REGISTERED_REASONS`` that grovelint's GL006 holds every
emitted reason to) and its deferral details (``REGISTERED_DETAILS``), which
the round and the explain engine cite. ``record`` dedups on (kind, namespace, name, type, reason),
bumps ``count`` and keeps the latest message; the oldest groups drop past
``max_events``. Each updated record goes to ``sink`` when one is installed
(the flight recorder's ``note_event``).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Tuple

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
# the flight recorder froze its rings into a postmortem bundle
REASON_FLIGHT_RECORDED = "FlightRecorderDumped"
# SLO observatory: an objective's attainment dropped below target (edge
# triggered; also freezes a flight bundle), its burn rate crossed the factor
# on the fast and the slow window, and a breached objective recovered
REASON_SLO_BREACH = "SloBreach"
REASON_SLO_BURN_RATE_HIGH = "SloBurnRateHigh"
REASON_SLO_RECOVERED = "SloRecovered"
# decision ledger: a remediation executed, or considered and skipped
REASON_REMEDIATION_EXECUTED = "RemediationExecuted"
REASON_REMEDIATION_SKIPPED = "RemediationSkipped"
# node-health monitor: heartbeat transitions, the fail-slow (gray) state
# flips, and the gang-recovery outcomes: rescued (the survivors kept their
# floors and the replacements placed), requeued (below a floor: torn down
# and held in backoff) and released from that backoff
REASON_NODE_NOT_READY = "NodeNotReady"
REASON_NODE_LOST = "NodeLost"
REASON_NODE_READY = "NodeReady"
REASON_NODE_DEGRADED = "NodeDegraded"
REASON_NODE_RECOVERED = "NodeRecovered"
REASON_GANG_RESCUED = "GangRescued"
REASON_GANG_REQUEUED = "GangRequeued"
REASON_GANG_RELEASED = "GangBackoffReleased"
# voluntary-disruption layer: the drain lifecycle, budget and breaker
# denials, and the storm breaker's flips
REASON_NODE_DRAINING = "NodeDraining"
REASON_NODE_DRAINED = "NodeDrained"
REASON_NODE_UNCORDONED = "NodeUncordoned"
REASON_GANG_DRAINED = "GangDrained"
REASON_DISRUPTION_THROTTLED = "DisruptionThrottled"
REASON_BREAKER_OPEN = "BreakerOpen"
REASON_BREAKER_CLOSED = "BreakerClosed"
# durability layer: a snapshot taken (and the log truncated), a recovery
# finished, a torn WAL tail truncated at its first bad CRC, and the WAL's
# degradation ladder stepping down (slow fsync, disk full) and back
REASON_SNAPSHOT_TAKEN = "SnapshotTaken"
REASON_RECOVERY_COMPLETED = "RecoveryCompleted"
REASON_WAL_TORN_TAIL = "WalTornTail"
REASON_WAL_DEGRADED = "WalDegraded"
REASON_WAL_RECOVERED = "WalRecovered"
# federation router: a gang moved off its home region because the home
# explain verdict said it cannot admit now; a region lost and rejoined; a
# region suspected partitioned (alive but unreachable) and healed
REASON_GANG_SPILLED = "GangSpilled"
REASON_CLUSTER_LOST = "ClusterLost"
REASON_CLUSTER_REJOINED = "ClusterRejoined"
REASON_CLUSTER_PARTITIONED = "ClusterPartitioned"
REASON_CLUSTER_HEALED = "ClusterHealed"
# the operator's components (the PodCliqueSet components, the rolling
# update, gang termination) emit these as literals at their call sites;
# registered here so grovelint's GL006 holds every emitted reason to this set
REASON_ROLLING_UPDATE_STARTED = "RollingUpdateStarted"
REASON_ROLLING_UPDATE_REPLICA_STARTED = "RollingUpdateReplicaStarted"
REASON_ROLLING_UPDATE_REPLICA_COMPLETED = "RollingUpdateReplicaCompleted"
REASON_ROLLING_UPDATE_COMPLETED = "RollingUpdateCompleted"
REASON_GANG_TERMINATED = "GangTerminated"
REASON_SCALED_REPLICA_GANG_TERMINATED = "ScaledReplicaGangTerminated"
REASON_POD_CREATE_SUCCESSFUL = "PodCreateSuccessful"
REASON_POD_DELETE_SUCCESSFUL = "PodDeleteSuccessful"
REASON_POD_UPDATE_DELETE_SUCCESSFUL = "PodUpdateDeleteSuccessful"
REASON_POD_CLIQUE_CREATE_SUCCESSFUL = "PodCliqueCreateSuccessful"
REASON_POD_CLIQUE_DELETE_SUCCESSFUL = "PodCliqueDeleteSuccessful"
REASON_PCSG_CREATE_SUCCESSFUL = "PCSGCreateSuccessful"
REASON_PCSG_DELETE_SUCCESSFUL = "PCSGDeleteSuccessful"
REASON_PODGANG_CREATE_SUCCESSFUL = "PodGangCreateSuccessful"
REASON_PODGANG_DELETE_SUCCESSFUL = "PodGangDeleteSuccessful"

# the closed set of reasons the port may emit (grovelint GL006)
REGISTERED_REASONS = frozenset(
    v for k, v in list(globals().items()) if k.startswith("REASON_") and isinstance(v, str)
)

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
REGISTERED_DETAILS = frozenset(
    v for k, v in list(globals().items()) if k.startswith("DETAIL_") and isinstance(v, str)
)


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
    # keyspace shard of the object's namespace: 0 on an unsharded store
    shard: int = 0

    def as_dict(self) -> dict:
        """The record as ``GET /events`` serves it (a k8s Event's shape)."""
        return {
            "involvedObject": {
                "kind": self.kind,
                "namespace": self.namespace,
                "name": self.name,
            },
            "type": self.type,
            "reason": self.reason,
            "message": self.message,
            "count": self.count,
            "firstTimestamp": self.first_timestamp,
            "lastTimestamp": self.last_timestamp,
            "shard": self.shard,
        }


def ref_of(obj) -> Tuple[str, str, str]:
    """(kind, namespace, name) of a typed API object."""
    return (getattr(obj, "kind", type(obj).__name__), obj.metadata.namespace, obj.metadata.name)


class EventRecorder:
    def __init__(self, max_events: int = 8192, clock=None) -> None:
        self.max_events = max_events
        self.clock = clock
        # namespace -> keyspace shard, wired by a sharded Store at
        # construction (Store.shard_index); None stamps shard 0
        self.shard_fn = None
        self._lock = threading.Lock()
        self._events: "OrderedDict[tuple, EventRecord]" = OrderedDict()
        # flight-recorder sink: receives each updated record; installed by
        # FLIGHTREC.enable(), one attribute check a record otherwise
        self.sink = None

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else time.time()

    def record(self, obj_ref, type: str, reason: str, message: str) -> EventRecord:
        """obj_ref: a (kind, namespace, name) tuple or a typed API object."""
        if not isinstance(obj_ref, tuple):
            obj_ref = ref_of(obj_ref)
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
                shard = self.shard_fn(namespace) if self.shard_fn is not None else 0
                rec = EventRecord(kind, namespace, name, type, reason, message, 1, now, now,
                                  shard)
                self._events[key] = rec
                while len(self._events) > self.max_events:
                    self._events.popitem(last=False)
        if self.sink is not None:
            self.sink.note_event(rec)
        return rec

    def list(
        self,
        namespace: Optional[str] = None,
        reason: Optional[str] = None,
        kind: Optional[str] = None,
    ) -> List[EventRecord]:
        with self._lock:
            records = list(self._events.values())
        return [
            r
            for r in records
            if (namespace is None or r.namespace == namespace)
            and (reason is None or r.reason == reason)
            and (kind is None or r.kind == kind)
        ]

    def reset(self) -> None:
        with self._lock:
            self._events.clear()


EVENTS = EventRecorder()
