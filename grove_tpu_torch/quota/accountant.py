"""Per-queue usage folded from pod watch events.

Counterpart of ``grove_tpu/quota/accountant.py``: a pod adds its
``spec.total_requests()`` to its queue (the ``scheduler.grove.io/queue``
label, else the default queue) while it is bound and not terminating. Equal
to a full rescan (``quota/oracle.py::usage_oracle``) up to the order of the
float additions; a queue's row drops when its last pod leaves.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.pod import is_scheduled, is_terminating
from grove_tpu_torch.api.types import DEFAULT_QUEUE


def pod_quota_features(
    pod, default_queue: str = DEFAULT_QUEUE
) -> Optional[Tuple[str, Dict[str, float]]]:
    """(queue, requests) the pod charges its queue, or None while it holds
    no capacity."""
    if pod.metadata.deletion_timestamp is not None:
        return None
    if not is_scheduled(pod) or is_terminating(pod):
        return None
    queue = pod.metadata.labels.get(namegen.LABEL_QUEUE) or default_queue
    return queue, pod.spec.total_requests()


class QuotaAccountant:
    __slots__ = ("_usage", "_pods", "default_queue", "_built")

    def __init__(self, default_queue: str = DEFAULT_QUEUE) -> None:
        self._usage: Dict[str, Dict[str, float]] = {}
        self._pods: Dict[str, int] = {}  # live bound pods per queue (row GC)
        self.default_queue = default_queue
        self._built = False  # built from a scan on first read

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {q: dict(v) for q, v in self._usage.items()}

    def _fold(self, pod, sign: int) -> None:
        feats = pod_quota_features(pod, self.default_queue)
        if feats is None:
            return
        queue, requests = feats
        row = self._usage.get(queue)
        if row is None:
            row = self._usage[queue] = {}
        for r, v in requests.items():
            row[r] = row.get(r, 0.0) + sign * v
        n = self._pods.get(queue, 0) + sign
        if n > 0:
            self._pods[queue] = n
        else:
            # a drained queue drops its row and any float residue
            self._pods.pop(queue, None)
            self._usage.pop(queue, None)

    def apply(self, type_: str, obj, old=None) -> None:
        """Fold one committed mutation (the store's watch callback shape)."""
        if getattr(obj, "kind", None) != "Pod" or not self._built:
            return
        if type_ == "Deleted":
            self._fold(old if old is not None else obj, -1)
            return
        if old is not None:
            self._fold(old, -1)
        self._fold(obj, +1)

    def on_event(self, ev) -> None:
        self.apply(ev.type, ev.obj, ev.old)

    def rebuild(self, pods) -> None:
        self._usage.clear()
        self._pods.clear()
        self._built = True
        for pod in pods:
            self._fold(pod, +1)

    def ensure_built(self, store) -> None:
        if not self._built:
            self.rebuild(store.scan("Pod"))
