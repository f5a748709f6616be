"""The Pod model and its status predicates.

Counterpart of ``grove_tpu/api/pod.py``, cut to what the scheduler round
reads: ``is_scheduled``, ``is_terminating``, ``is_schedule_gated``,
``is_ready``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from grove_tpu_torch.api.meta import Condition, ObjectMeta, get_condition
from grove_tpu_torch.api.types import PodSpec

POD_PENDING = "Pending"

COND_POD_SCHEDULED = "PodScheduled"
COND_POD_READY = "Ready"


@dataclass
class ContainerStatus:
    name: str
    ready: bool = False
    started: bool = False
    exit_code: Optional[int] = None
    restart_count: int = 0


@dataclass
class PodStatus:
    phase: str = POD_PENDING
    conditions: List[Condition] = field(default_factory=list)
    node_name: str = ""
    container_statuses: List[ContainerStatus] = field(default_factory=list)
    init_waiter_done: bool = False


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)
    kind: str = "Pod"


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
