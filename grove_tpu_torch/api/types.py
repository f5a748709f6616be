"""The API kinds the scheduler round reads and writes.

Counterpart of ``grove_tpu/api/types.py``, cut to PodGang, PodClique,
Queue, PodCliqueSet (with its template, scaling-group configs, disruption
budget and status types), ``GenericObject`` and the pod template
(``PodSpec``, ``Container``), with the phase and condition constants and
``parse_duration``. Field names and wire names match the JAX package's, so
a document it exports decodes here unchanged (``api/wire.py``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from grove_tpu_torch.api.meta import Condition, NamespacedName, ObjectMeta, parse_resource_map

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

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Container":
        res = d.get("resources") or {}
        known = {"name", "image", "command", "args", "resources", "env"}
        return Container(
            name=d["name"],
            image=d.get("image", ""),
            command=list(d.get("command") or []),
            args=list(d.get("args") or []),
            requests=parse_resource_map(res.get("requests")),
            limits=parse_resource_map(res.get("limits")),
            env=[dict(e) for e in d.get("env") or []],
            extra={k: v for k, v in d.items() if k not in known},
        )


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

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PodSpec":
        known = {
            "containers",
            "initContainers",
            "nodeSelector",
            "tolerations",
            "priorityClassName",
            "schedulerName",
            "restartPolicy",
        }
        return PodSpec(
            containers=[Container.from_dict(c) for c in d.get("containers") or []],
            init_containers=[
                Container.from_dict(c) for c in d.get("initContainers") or []
            ],
            node_selector=dict(d.get("nodeSelector") or {}),
            tolerations=list(d.get("tolerations") or []),
            priority_class_name=d.get("priorityClassName", ""),
            scheduler_name=d.get("schedulerName", ""),
            restart_policy=d.get("restartPolicy", ""),
            extra={k: v for k, v in d.items() if k not in known},
        )


# -- autoscaling and operator-side topology constraints -----------------------


@dataclass
class AutoScalingConfig:
    """podclique.go:81-101 AutoScalingConfig / scalinggroup ScaleConfig."""

    max_replicas: int = 0
    min_replicas: Optional[int] = None
    metrics: List[Dict[str, Any]] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "AutoScalingConfig":
        return AutoScalingConfig(
            max_replicas=int(d.get("maxReplicas", 0)),
            min_replicas=(
                int(d["minReplicas"]) if d.get("minReplicas") is not None else None
            ),
            metrics=list(d.get("metrics") or []),
        )


@dataclass
class TopologyConstraint:
    """podcliqueset.go:186-199 — packDomain holds a topology *level name*
    (e.g. 'ici-block'); the operator translates it into node-label topology
    keys on the PodGang (docs/designs/topology.md:541-616).

    spreadDomain extends the contract with topology SPREAD (the reference's
    2026 roadmap item, README.md "Topology Spread Constraints", unshipped
    there): balance the unit's pods across the domains of that level —
    fault-tolerance counterpart of packing. Composes with packDomain when
    spreadDomain is strictly narrower (pack the gang into one slice, spread
    its pods across the hosts inside it)."""

    pack_domain: Optional[str] = None
    spread_domain: Optional[str] = None
    # minimum distinct domains a placement must span (defaulted to 2)
    spread_min_domains: Optional[int] = None
    # DoNotSchedule (hard — reject placements below the floor) or
    # ScheduleAnyway (soft — spread shapes the PlacementScore only)
    spread_when_unsatisfiable: Optional[str] = None

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> Optional["TopologyConstraint"]:
        if not d:
            return None
        return TopologyConstraint(
            pack_domain=d.get("packDomain"),
            spread_domain=d.get("spreadDomain"),
            spread_min_domains=d.get("spreadMinDomains"),
            spread_when_unsatisfiable=d.get("spreadWhenUnsatisfiable"),
        )


# -- PodClique ---------------------------------------------------------------


@dataclass
class PodCliqueSpec:
    """podclique.go:53-79."""

    role_name: str = ""
    replicas: int = 1
    min_available: Optional[int] = None
    starts_after: List[str] = field(default_factory=list)
    pod_spec: PodSpec = field(default_factory=PodSpec)
    auto_scaling_config: Optional[AutoScalingConfig] = None

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PodCliqueSpec":
        asc = d.get("autoScalingConfig")
        return PodCliqueSpec(
            role_name=d.get("roleName", ""),
            replicas=int(d.get("replicas", 1)),
            min_available=(
                int(d["minAvailable"]) if d.get("minAvailable") is not None else None
            ),
            starts_after=list(d.get("startsAfter") or []),
            pod_spec=PodSpec.from_dict(d.get("podSpec") or {}),
            auto_scaling_config=AutoScalingConfig.from_dict(asc) if asc else None,
        )


@dataclass
class PodCliqueTemplateSpec:
    """podcliqueset.go:159-183."""

    name: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    topology_constraint: Optional[TopologyConstraint] = None
    spec: PodCliqueSpec = field(default_factory=PodCliqueSpec)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PodCliqueTemplateSpec":
        return PodCliqueTemplateSpec(
            name=d["name"],
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            topology_constraint=TopologyConstraint.from_dict(
                d.get("topologyConstraint")
            ),
            spec=PodCliqueSpec.from_dict(d.get("spec") or {}),
        )


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


# -- PodCliqueSet (the objects the disruption broker reads) ------------------


@dataclass
class PodCliqueScalingGroupConfig:
    """podcliqueset.go:201-233 (template-level config)."""

    name: str = ""
    clique_names: List[str] = field(default_factory=list)
    replicas: Optional[int] = None
    min_available: Optional[int] = None
    scale_config: Optional[AutoScalingConfig] = None
    topology_constraint: Optional[TopologyConstraint] = None

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PodCliqueScalingGroupConfig":
        sc = d.get("scaleConfig")
        return PodCliqueScalingGroupConfig(
            name=d["name"],
            clique_names=list(d.get("cliqueNames") or []),
            replicas=int(d["replicas"]) if d.get("replicas") is not None else None,
            min_available=(
                int(d["minAvailable"]) if d.get("minAvailable") is not None else None
            ),
            scale_config=AutoScalingConfig.from_dict(sc) if sc else None,
            topology_constraint=TopologyConstraint.from_dict(
                d.get("topologyConstraint")
            ),
        )



@dataclass
class HeadlessServiceConfig:
    publish_not_ready_addresses: bool = True


@dataclass
class DisruptionBudget:
    """grove-tpu extension (docs/robustness.md "voluntary disruption"): a
    PodDisruptionBudget at GANG granularity, enforced by the
    DisruptionBroker (``disruption/broker.py``) against every VOLUNTARY
    disruptor — node drain, priority preemption, quota reclaim, rolling
    update. Involuntary failures (node loss) bypass it but still count
    toward the unavailable tally a voluntary request is checked against.

    ``max_unavailable_gangs``: how many of the set's gangs may be
    voluntarily unavailable at once (0 = block all voluntary disruption).
    ``quiet_window``: minimum virtual seconds between granted voluntary
    disruptions of this set (None = no pacing beyond the budget)."""

    max_unavailable_gangs: Optional[int] = None  # defaulted to 1
    quiet_window: Optional[float] = None  # seconds

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> Optional["DisruptionBudget"]:
        if d is None:
            return None
        qw = d.get("quietWindow")
        return DisruptionBudget(
            max_unavailable_gangs=(
                int(d["maxUnavailableGangs"])
                if d.get("maxUnavailableGangs") is not None
                else None
            ),
            quiet_window=parse_duration(qw) if qw is not None else None,
        )


@dataclass
class PodCliqueSetTemplateSpec:
    """podcliqueset.go:123-156."""

    cliques: List[PodCliqueTemplateSpec] = field(default_factory=list)
    startup_type: Optional[str] = None
    priority_class_name: str = ""
    headless_service_config: Optional[HeadlessServiceConfig] = None
    topology_constraint: Optional[TopologyConstraint] = None
    termination_delay: Optional[float] = None  # seconds
    disruption_budget: Optional[DisruptionBudget] = None
    pod_clique_scaling_group_configs: List[PodCliqueScalingGroupConfig] = field(
        default_factory=list
    )

    def clique_template(self, name: str) -> Optional[PodCliqueTemplateSpec]:
        for c in self.cliques:
            if c.name == name:
                return c
        return None

    def standalone_clique_templates(self) -> List[PodCliqueTemplateSpec]:
        """Cliques not owned by any scaling group."""
        in_sg = {
            n
            for cfg in self.pod_clique_scaling_group_configs
            for n in cfg.clique_names
        }
        return [c for c in self.cliques if c.name not in in_sg]

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PodCliqueSetTemplateSpec":
        hsc = d.get("headlessServiceConfig")
        td = d.get("terminationDelay")
        return PodCliqueSetTemplateSpec(
            cliques=[PodCliqueTemplateSpec.from_dict(c) for c in d.get("cliques") or []],
            startup_type=d.get("cliqueStartupType"),
            priority_class_name=d.get("priorityClassName", ""),
            headless_service_config=(
                HeadlessServiceConfig(
                    publish_not_ready_addresses=bool(
                        hsc.get("publishNotReadyAddresses", True)
                    )
                )
                if hsc
                else None
            ),
            topology_constraint=TopologyConstraint.from_dict(
                d.get("topologyConstraint")
            ),
            termination_delay=parse_duration(td) if td is not None else None,
            disruption_budget=DisruptionBudget.from_dict(
                d.get("disruptionBudget")
            ),
            pod_clique_scaling_group_configs=[
                PodCliqueScalingGroupConfig.from_dict(g)
                for g in d.get("podCliqueScalingGroups") or []
            ],
        )


@dataclass
class PodCliqueSetSpec:
    """podcliqueset.go:52-58."""

    replicas: int = 1
    template: PodCliqueSetTemplateSpec = field(
        default_factory=PodCliqueSetTemplateSpec
    )

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PodCliqueSetSpec":
        return PodCliqueSetSpec(
            replicas=int(d.get("replicas", 1)),
            template=PodCliqueSetTemplateSpec.from_dict(d.get("template") or {}),
        )


@dataclass
class PCSReplicaRollingUpdateProgress:
    """podcliqueset.go:110-119."""

    replica_index: int = 0
    update_started_at: float = 0.0


@dataclass
class PCSRollingUpdateProgress:
    """podcliqueset.go:93-108."""

    update_started_at: float = 0.0
    update_ended_at: Optional[float] = None
    updated_pod_clique_scaling_groups: List[str] = field(default_factory=list)
    updated_pod_cliques: List[str] = field(default_factory=list)
    currently_updating: Optional[PCSReplicaRollingUpdateProgress] = None


@dataclass
class PodGangStatusSummary:
    """operator-side PodGangStatus mirror in PCS status — podcliqueset.go:258-265."""

    name: str = ""
    phase: str = PHASE_PENDING
    conditions: List[Condition] = field(default_factory=list)


@dataclass
class PodCliqueSetStatus:
    """podcliqueset.go:61-91."""

    observed_generation: Optional[int] = None
    replicas: int = 0
    updated_replicas: int = 0
    available_replicas: int = 0
    selector: Optional[str] = None
    pod_gang_statuses: List[PodGangStatusSummary] = field(default_factory=list)
    current_generation_hash: Optional[str] = None
    rolling_update_progress: Optional[PCSRollingUpdateProgress] = None
    last_errors: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class PodCliqueSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodCliqueSetSpec = field(default_factory=PodCliqueSetSpec)
    status: PodCliqueSetStatus = field(default_factory=PodCliqueSetStatus)
    kind: str = "PodCliqueSet"

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PodCliqueSet":
        meta = d.get("metadata") or {}
        return PodCliqueSet(
            metadata=ObjectMeta(
                name=meta.get("name", ""),
                namespace=meta.get("namespace", "default"),
                labels=dict(meta.get("labels") or {}),
                annotations=dict(meta.get("annotations") or {}),
            ),
            spec=PodCliqueSetSpec.from_dict(d.get("spec") or {}),
        )


# ---------------------------------------------------------------------------
# PodGang (scheduler contract)
# ---------------------------------------------------------------------------


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


# -- generic child kinds ------------------------------------------------------


@dataclass
class GenericObject:
    """Lightweight stand-in for child kinds the operator materializes but the
    sim doesn't interpret deeply (headless Service, HPA, ServiceAccount, Role,
    RoleBinding, SA-token Secret)."""

    kind: str
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: Dict[str, Any] = field(default_factory=dict)



# -- helpers ------------------------------------------------------------------

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|h|m|s)")


def parse_duration(value: Any) -> float:
    """Parse a Go-style duration ('4h', '30m', '1h30m', '10s') into seconds."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    if not s:
        raise ValueError("empty duration")
    mult = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 1e-3}
    total = 0.0
    pos = 0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration: {value!r}")
        total += float(m.group(1)) * mult[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration: {value!r}")
    return total
