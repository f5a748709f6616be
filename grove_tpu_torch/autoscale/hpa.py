"""Horizontal autoscaler: evaluates HPA objects against observed utilization.

Counterpart of ``grove_tpu/autoscale/hpa.py``.
Plays the role of the kube HPA controller for the two Grove scale targets
(reference components/hpa/hpa.go creates `autoscaling/v2` HPAs against the
CRs' scale subresources; the kube controller then drives .spec.replicas):
- PodClique (standalone autoscaled cliques)
- PodCliqueScalingGroup (group-scaled cliques — scaling it out materializes
  scaled PodGangs, the hierarchical-gang path)

Semantics follow the HPA v2 utilization algorithm:
    desired = ceil(current * observed / target)
clamped to [minReplicas, maxReplicas], with a stabilization window on
scale-down. Metrics come from a pluggable provider; the sim provider reports
per-target utilization injected by tests / scenarios.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional, Protocol, Tuple

from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.runtime.store import Store

DEFAULT_SCALE_DOWN_STABILIZATION = 300.0  # seconds (kube default)

# one scale decision, as logged: (vt, kind, namespace, name, from, to)
ScaleEvent = Tuple[float, str, str, str, int, int]


class MetricsProvider(Protocol):
    def utilization(self, kind: str, namespace: str, name: str) -> Optional[float]:
        """Average utilization (%) across the target's pods, None if unknown."""
        ...


@dataclass
class StaticMetricsProvider:
    """Sim/test provider: utilization set explicitly per target."""

    values: Dict[str, float] = field(default_factory=dict)

    def set(self, kind: str, namespace: str, name: str, value: float) -> None:
        self.values[f"{kind}/{namespace}/{name}"] = value

    def utilization(self, kind: str, namespace: str, name: str) -> Optional[float]:
        return self.values.get(f"{kind}/{namespace}/{name}")


class HorizontalAutoscaler:
    def __init__(
        self,
        store: Store,
        provider: MetricsProvider,
        scale_down_stabilization: float = DEFAULT_SCALE_DOWN_STABILIZATION,
    ) -> None:
        self.store = store
        self.provider = provider
        self.scale_down_stabilization = scale_down_stabilization
        # target key -> (proposed lower replicas, since)
        self._scale_down_candidates: Dict[str, tuple] = {}
        # bounded decision log, stamped with the DECISION's virtual time —
        # scale-up latency (decision → replicas Ready) is only measurable
        # if the decision instant survives the converge that absorbs it
        # (sim/traffic.py and the serving SLO objectives consume this)
        self.scale_log: Deque[ScaleEvent] = deque(maxlen=4096)

    def tick(self, namespace: Optional[str] = None) -> int:
        """Evaluate every HPA once (all namespaces by default); returns the
        number of scale changes."""
        changes = 0
        # readonly scan: evaluation only reads the HPA spec; the target is
        # re-fetched mutably inside _apply_scale when a scale actually fires
        for hpa in self.store.scan("HorizontalPodAutoscaler", namespace):
            if self._evaluate(hpa.metadata.namespace, hpa):
                changes += 1
        return changes

    def next_deadline(self) -> Optional[float]:
        """Earliest pending scale-down stabilization deadline (None if no
        scale-down is held) — lets a virtual-time loop jump to it."""
        if not self._scale_down_candidates:
            return None
        return min(
            since + self.scale_down_stabilization
            for _, since in self._scale_down_candidates.values()
        )

    def scale_target(
        self, kind: str, namespace: str, name: str, replicas: int
    ) -> bool:
        """Direct scale request from a policy controller (the remediator's
        preemptive scale-up ahead of a forecast peak): same mechanics as
        an HPA decision — re-get, write ``spec.replicas``, log, count — so
        the decision log and the hpa_* metrics see one unified stream.
        Returns False when the target is absent, terminating, or already
        at the requested size."""
        view = self.store.get(kind, namespace, name, readonly=True)
        if view is None or view.metadata.deletion_timestamp is not None:
            return False
        if int(view.spec.replicas) == int(replicas):
            return False
        key = f"{kind}/{namespace}/{name}"
        self._scale_down_candidates.pop(key, None)
        return self._apply_scale(view, int(replicas), key)

    # -- core ------------------------------------------------------------

    def _evaluate(self, namespace: str, hpa) -> bool:
        spec = hpa.spec
        kind = spec.get("targetKind")
        name = spec.get("targetName")
        target_util = self._target_utilization(spec)
        if kind is None or name is None or target_util is None:
            return False
        observed = self.provider.utilization(kind, namespace, name)
        if observed is None:
            return False
        obj = self.store.get(kind, namespace, name, readonly=True)
        if obj is None or obj.metadata.deletion_timestamp is not None:
            return False
        current = obj.spec.replicas
        desired = math.ceil(current * observed / max(target_util, 1e-9))
        lo = int(spec.get("minReplicas") or 1)
        hi = int(spec.get("maxReplicas") or current)
        desired = max(lo, min(hi, desired))
        key = f"{kind}/{namespace}/{name}"

        if desired == current:
            self._scale_down_candidates.pop(key, None)
            return False
        if desired > current:
            self._scale_down_candidates.pop(key, None)
            return self._apply_scale(obj, desired, key)

        # scale-down: hold for the stabilization window, track the HIGHEST
        # proposed value within the window (kube semantics)
        now = self.store.clock.now()
        proposed, since = self._scale_down_candidates.get(key, (desired, now))
        proposed = max(proposed, desired)
        self._scale_down_candidates[key] = (proposed, since)
        if now - since < self.scale_down_stabilization:
            return False
        self._scale_down_candidates.pop(key, None)
        return self._apply_scale(obj, proposed, key)

    @staticmethod
    def _target_utilization(spec) -> Optional[float]:
        for metric in spec.get("metrics") or []:
            resource = metric.get("resource") or {}
            target = resource.get("target") or {}
            if target.get("averageUtilization") is not None:
                return float(target["averageUtilization"])
        return None

    def _apply_scale(self, view, desired: int, key: str) -> bool:
        # `view` is a readonly store view — re-get a private copy to write
        obj = self.store.get(
            view.kind, view.metadata.namespace, view.metadata.name
        )
        if obj is None or obj.metadata.deletion_timestamp is not None:
            return False
        previous = int(obj.spec.replicas)
        obj.spec.replicas = desired
        self.store.update(obj)  # generation bump → controllers reconcile
        self.scale_log.append(
            (
                self.store.clock.now(),
                obj.kind,
                obj.metadata.namespace,
                obj.metadata.name,
                previous,
                desired,
            )
        )
        METRICS.inc(f"hpa_scale_total/{key}")
        METRICS.set(f"hpa_replicas/{key}", desired)
        return True


