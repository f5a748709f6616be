"""The Pod model and its categorization helpers.

Counterpart of ``grove_tpu/api/pod.py``: the Ready / Scheduled /
ScheduleGated / Terminating / erroneous-exit buckets that drive PodClique
status.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from grove_tpu_torch.api.meta import Condition, ObjectMeta, get_condition
from grove_tpu_torch.api.types import PodSpec

POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"

COND_POD_SCHEDULED = "PodScheduled"
COND_POD_READY = "Ready"

REASON_SCHEDULING_GATED = "SchedulingGated"


@dataclass
class ContainerStatus:
    name: str
    ready: bool = False
    started: bool = False
    exit_code: Optional[int] = None  # last terminated exit code, if any
    restart_count: int = 0


@dataclass
class PodStatus:
    phase: str = POD_PENDING
    conditions: List[Condition] = field(default_factory=list)
    node_name: str = ""
    container_statuses: List[ContainerStatus] = field(default_factory=list)
    init_waiter_done: bool = False  # sim: grove-initc exited successfully


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)
    kind: str = "Pod"


# --- categorization (utils/kubernetes/pod.go) -------------------------------


def is_terminating(pod: Pod) -> bool:
    return pod.metadata.deletion_timestamp is not None


def is_schedule_gated(pod: Pod) -> bool:
    return bool(pod.spec.scheduling_gates)


def is_scheduled(pod: Pod) -> bool:
    cond = get_condition(pod.status.conditions, COND_POD_SCHEDULED)
    return cond is not None and cond.is_true()


def is_ready(pod: Pod) -> bool:
    cond = get_condition(pod.status.conditions, COND_POD_READY)
    return cond is not None and cond.is_true()


def has_erroneous_exit(pod: Pod) -> bool:
    """A container has terminated with a non-zero exit code.

    Drives the 'starting pods count as available' rule: a pod with no non-zero
    container exit yet is treated as available for MinAvailableBreached
    (reference podclique/reconcilestatus.go:168-225).
    """
    if pod.status.phase == POD_FAILED:
        return True
    return any(
        cs.exit_code is not None and cs.exit_code != 0
        for cs in pod.status.container_statuses
    )


def is_available(pod: Pod) -> bool:
    """Ready, or still starting (scheduled, not terminating, no bad exits)."""
    if is_terminating(pod):
        return False
    if is_ready(pod):
        return True
    return is_scheduled(pod) and not has_erroneous_exit(pod)


@dataclass
class PodCategories:
    """Bucketized view used by the PCLQ status flow."""

    total: int = 0
    ready: List[Pod] = field(default_factory=list)
    scheduled: List[Pod] = field(default_factory=list)
    schedule_gated: List[Pod] = field(default_factory=list)
    terminating: List[Pod] = field(default_factory=list)
    available: List[Pod] = field(default_factory=list)


def categorize_pods(pods: List[Pod]) -> PodCategories:
    cats = PodCategories(total=len(pods))
    for p in pods:
        if is_terminating(p):
            cats.terminating.append(p)
            continue
        if is_schedule_gated(p):
            cats.schedule_gated.append(p)
        if is_scheduled(p):
            cats.scheduled.append(p)
        if is_ready(p):
            cats.ready.append(p)
        if is_available(p):
            cats.available.append(p)
    return cats
