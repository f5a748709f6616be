"""The API kinds the scheduler round reads and writes.

Counterpart of ``grove_tpu/api/types.py``, cut to PodGang, PodClique,
Queue and the pod template (``PodSpec``, ``Container``), with the phase and
condition constants. Field names and wire names match the JAX package's, so
a document it exports decodes here unchanged (``api/wire.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from grove_tpu_torch.api.meta import Condition, NamespacedName, ObjectMeta

# PodGang phases
PHASE_PENDING = "Pending"
PHASE_STARTING = "Starting"
PHASE_RUNNING = "Running"

# condition types
COND_MIN_AVAILABLE_BREACHED = "MinAvailableBreached"
COND_PODGANG_SCHEDULED = "Scheduled"
COND_PODGANG_UNHEALTHY = "Unhealthy"
COND_PODGANG_DISRUPTION_TARGET = "DisruptionTarget"

SPREAD_DO_NOT_SCHEDULE = "DoNotSchedule"
SPREAD_SCHEDULE_ANYWAY = "ScheduleAnyway"

# queue gangs land in when they carry no queue label
DEFAULT_QUEUE = "default"


@dataclass
class Container:
    name: str
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    requests: Dict[str, float] = field(default_factory=dict)
    limits: Dict[str, float] = field(default_factory=dict)
    env: List[Dict[str, Any]] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Dict[str, Any]] = field(default_factory=list)
    priority_class_name: str = ""
    scheduler_name: str = ""
    restart_policy: str = ""
    hostname: str = ""
    subdomain: str = ""
    scheduling_gates: List[str] = field(default_factory=list)
    service_account_name: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)

    def total_requests(self) -> Dict[str, float]:
        """Resource requests summed over the containers."""
        out: Dict[str, float] = {}
        for c in self.containers:
            for k, v in c.requests.items():
                out[k] = out.get(k, 0.0) + v
        return out


# -- PodClique ---------------------------------------------------------------


@dataclass
class PodCliqueSpec:
    role_name: str = ""
    replicas: int = 1
    min_available: Optional[int] = None
    starts_after: List[str] = field(default_factory=list)
    pod_spec: PodSpec = field(default_factory=PodSpec)


@dataclass
class PodCliqueStatus:
    observed_generation: Optional[int] = None
    replicas: int = 0
    ready_replicas: int = 0
    schedule_gated_replicas: int = 0
    scheduled_replicas: int = 0
    updated_replicas: int = 0
    conditions: List[Condition] = field(default_factory=list)
    selector: Optional[str] = None
    last_errors: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class PodClique:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodCliqueSpec = field(default_factory=PodCliqueSpec)
    status: PodCliqueStatus = field(default_factory=PodCliqueStatus)
    kind: str = "PodClique"


# -- PodGang (the scheduler contract) ----------------------------------------


@dataclass
class TopologyPackConstraint:
    """required/preferred hold topology keys (node-label keys)."""

    required: Optional[str] = None
    preferred: Optional[str] = None


@dataclass
class TopologySpreadConstraint:
    topology_key: str = ""
    min_domains: int = 2
    when_unsatisfiable: str = SPREAD_DO_NOT_SCHEDULE


@dataclass
class SchedTopologyConstraint:
    pack_constraint: Optional[TopologyPackConstraint] = None
    spread_constraint: Optional[TopologySpreadConstraint] = None


@dataclass
class PodGroup:
    name: str
    pod_references: List[NamespacedName] = field(default_factory=list)
    min_replicas: int = 0
    topology_constraint: Optional[SchedTopologyConstraint] = None


@dataclass
class TopologyConstraintGroupConfig:
    """PCSG-level pack groups."""

    pod_group_names: List[str] = field(default_factory=list)
    topology_constraint: Optional[SchedTopologyConstraint] = None


@dataclass
class PodGangSpec:
    pod_groups: List[PodGroup] = field(default_factory=list)
    topology_constraint: Optional[SchedTopologyConstraint] = None
    topology_constraint_group_configs: List[TopologyConstraintGroupConfig] = field(
        default_factory=list
    )
    priority_class_name: str = ""
    reuse_reservation_ref: Optional[NamespacedName] = None


@dataclass
class PodGangStatus:
    phase: str = PHASE_PENDING
    conditions: List[Condition] = field(default_factory=list)
    placement_score: Optional[float] = None


@dataclass
class PodGang:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGangSpec = field(default_factory=PodGangSpec)
    status: PodGangStatus = field(default_factory=PodGangStatus)
    kind: str = "PodGang"


# -- Queue (quota and fair share) --------------------------------------------


@dataclass
class QueueSpec:
    """``deserved``: the per-resource share the queue is entitled to;
    ``ceiling``: a per-resource hard cap (gangs past it are held)."""

    parent: str = ""
    deserved: Dict[str, float] = field(default_factory=dict)
    ceiling: Dict[str, float] = field(default_factory=dict)


@dataclass
class QueueStatus:
    usage: Dict[str, float] = field(default_factory=dict)
    dominant_share: float = 0.0
    admitted_gangs: int = 0
    pending_gangs: int = 0
    conditions: List[Condition] = field(default_factory=list)


@dataclass
class Queue:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: QueueSpec = field(default_factory=QueueSpec)
    status: QueueStatus = field(default_factory=QueueStatus)
    kind: str = "Queue"
