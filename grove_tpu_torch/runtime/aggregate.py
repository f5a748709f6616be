"""Event-driven status aggregation: incremental per-PodClique pod counters.

Counterpart of ``grove_tpu/runtime/aggregate.py``: each committed pod
mutation folds a feature diff into a per-(namespace, podclique) counter row
and into the view's (total, ready) partial, so ``Store.pod_counters`` and
``Store.pod_summary`` read in O(1) what a full rescan of the store would
give (terminating pods are invisible; "updated" is keyed by the
pod-template-hash label; error exits and started-not-ready pods fill the
availability buckets).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.pod import (
    has_erroneous_exit,
    is_ready,
    is_schedule_gated,
    is_scheduled,
)


class PodCounters:
    """One PodClique's incremental pod-status counters (read-only to
    consumers; only the owning PodAggregate mutates them)."""

    __slots__ = (
        "total",
        "ready",
        "scheduled",
        "gated",
        "error_exits",
        "started_not_ready",
        "hash_counts",
    )

    def __init__(self) -> None:
        self.total = 0
        self.ready = 0
        self.scheduled = 0
        self.gated = 0
        self.error_exits = 0
        self.started_not_ready = 0
        self.hash_counts: Dict[str, int] = {}

    def updated(self, current_hash: Optional[str]) -> int:
        """Pods carrying `current_hash` (0 when the PCLQ has no hash yet —
        the falsy-hash guard of the PodClique status flow)."""
        if not current_hash:
            return 0
        return self.hash_counts.get(current_hash, 0)


# the empty row handed out for PodCliques with no live pods — shared,
# never mutated (PodAggregate only mutates rows it stored itself)
EMPTY_COUNTERS = PodCounters()

_Features = Tuple[int, int, int, int, int, int, Optional[str]]


def pod_features(pod) -> Optional[_Features]:
    """The pod's contribution vector to its PCLQ's counters, or None for
    terminating pods (excluded from every counter)."""
    if pod.metadata.deletion_timestamp is not None:
        return None
    ready = is_ready(pod)
    scheduled = is_scheduled(pod)
    err = has_erroneous_exit(pod)
    started = False
    for cs in pod.status.container_statuses:
        if cs.started:
            started = True
            break
    return (
        1,
        1 if ready else 0,
        1 if scheduled else 0,
        1 if is_schedule_gated(pod) else 0,
        # not-ready buckets of the MinAvailableBreached math
        # (the reference operator's reconcilestatus.go:205-215)
        1 if (not ready and err) else 0,
        1 if (scheduled and not ready and not err and started) else 0,
        pod.metadata.labels.get(namegen.LABEL_POD_TEMPLATE_HASH),
    )


class PodAggregate:
    """Per-(namespace, podclique-label) counter rows, folded from deltas.

    One instance mirrors ONE store view (committed, or the lagged read
    cache); the Store applies every mutation of that view here, so reads
    are always exactly the full-rescan answer for that view.
    """

    __slots__ = ("_rows", "grand_total", "grand_ready")

    def __init__(self) -> None:
        self._rows: Dict[Tuple[str, str], PodCounters] = {}
        # this view's (total, ready) pod partial — the LEAF of the
        # store's summary tree (Store.pod_summary folds the shards' leaves):
        # maintained here because _fold already computed the features, so
        # the level-1 cost is two int adds per event
        self.grand_total = 0
        self.grand_ready = 0

    def counters(self, namespace: str, pclq_name: str) -> PodCounters:
        return self._rows.get((namespace, pclq_name), EMPTY_COUNTERS)

    # -- maintenance (Store-internal) ------------------------------------

    def _fold(self, pod, sign: int) -> None:
        feats = pod_features(pod)
        if feats is None:
            return
        # view-wide partial first: EVERY live pod counts toward the shard
        # leaf (clique-labeled or not), so the hierarchical summary equals
        # a full non-terminating-pod rescan
        self.grand_total += sign * feats[0]
        self.grand_ready += sign * feats[1]
        pclq = pod.metadata.labels.get(namegen.LABEL_PODCLIQUE)
        if pclq is None:
            return
        key = (pod.metadata.namespace, pclq)
        row = self._rows.get(key)
        if row is None:
            row = self._rows[key] = PodCounters()
        row.total += sign * feats[0]
        row.ready += sign * feats[1]
        row.scheduled += sign * feats[2]
        row.gated += sign * feats[3]
        row.error_exits += sign * feats[4]
        row.started_not_ready += sign * feats[5]
        h = feats[6]
        if h is not None:
            n = row.hash_counts.get(h, 0) + sign
            if n:
                row.hash_counts[h] = n
            else:
                row.hash_counts.pop(h, None)
        if sign < 0 and row.total == 0 and not row.hash_counts:
            # bound memory: a fully-drained PCLQ (deleted set) drops its row
            self._rows.pop(key, None)

    def apply(self, type_: str, obj, old) -> None:
        """Fold one view mutation. `old` is the view's previous object for
        the same key (None for Added). Deleted folds the removed object out."""
        if obj.kind != "Pod":
            return
        if type_ == "Deleted":
            self._fold(old if old is not None else obj, -1)
            return
        if old is not None:
            self._fold(old, -1)
        self._fold(obj, +1)

    def rebuild(self, pods) -> None:
        """Recompute from scratch (full informer resync)."""
        self._rows.clear()
        self.grand_total = 0
        self.grand_ready = 0
        for pod in pods:
            self._fold(pod, +1)
