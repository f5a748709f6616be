"""The operator's API kinds.

Counterpart of ``grove_tpu/api/types.py``: PodCliqueSet, PodClique,
PodCliqueScalingGroup, PodGang, Queue and ``GenericObject`` as dataclasses
with the reference's camelCase wire names. Field names and defaults match
the JAX package's one for one: ``api/hashing.py`` normalises dataclasses by
field name, so a renamed or missing field would change every pod-template
hash.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from grove_tpu_torch.api.meta import (
    Condition,
    NamespacedName,
    ObjectMeta,
    parse_resource_map,
)

# ---------------------------------------------------------------------------
# Constants / enums
# ---------------------------------------------------------------------------

API_GROUP = "grove.io"
SCHEDULER_API_GROUP = "scheduler.grove.io"

# CliqueStartupType — podcliqueset.go:243-255
STARTUP_ANY_ORDER = "CliqueStartupTypeAnyOrder"
STARTUP_IN_ORDER = "CliqueStartupTypeInOrder"
STARTUP_EXPLICIT = "CliqueStartupTypeExplicit"
STARTUP_TYPES = (STARTUP_ANY_ORDER, STARTUP_IN_ORDER, STARTUP_EXPLICIT)

# PodGangPhase — scheduler podgang.go:139-151 and operator podcliqueset.go:267-284
PHASE_PENDING = "Pending"
PHASE_STARTING = "Starting"
PHASE_RUNNING = "Running"

# Condition types
COND_POD_CLIQUE_SCHEDULED = "PodCliqueScheduled"
COND_MIN_AVAILABLE_BREACHED = "MinAvailableBreached"
COND_PODGANG_SCHEDULED = "Scheduled"
COND_PODGANG_READY = "Ready"
COND_PODGANG_UNHEALTHY = "Unhealthy"
COND_PODGANG_DISRUPTION_TARGET = "DisruptionTarget"

# Default gang-termination delay — podcliqueset.go:146-153 (4 hours)
DEFAULT_TERMINATION_DELAY_SECONDS = 4 * 60 * 60.0

# Scheduling gate applied to every grove-managed pod at creation
# (reference: podclique/components/pod/pod.go:68 "grove.io/podgang-pending-creation")
PODGANG_SCHEDULING_GATE = "grove.io/podgang-pending-creation"


# ---------------------------------------------------------------------------
# Pod template subset
# ---------------------------------------------------------------------------


@dataclass
class Container:
    name: str
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    requests: Dict[str, float] = field(default_factory=dict)
    limits: Dict[str, float] = field(default_factory=dict)
    env: List[Dict[str, Any]] = field(default_factory=list)
    # Unmodeled container fields (ports, volumeMounts, probes, …) pass through
    # so template hashing sees every user-visible change.
    extra: Dict[str, Any] = field(default_factory=dict)

    def env_value(self, name: str) -> Optional[str]:
        for e in self.env:
            if e.get("name") == name:
                return e.get("value")
        return None

    def set_env(self, name: str, value: str) -> None:
        for e in self.env:
            if e.get("name") == name:
                e["value"] = value
                return
        self.env.append({"name": name, "value": value})

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
    # Fields set by the operator on build (not by users):
    hostname: str = ""
    subdomain: str = ""
    scheduling_gates: List[str] = field(default_factory=list)
    service_account_name: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)

    def total_requests(self) -> Dict[str, float]:
        """Aggregate resource requests across containers (scheduler's view)."""
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


# ---------------------------------------------------------------------------
# Autoscaling
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Topology constraints (operator-side, level *names*)
# ---------------------------------------------------------------------------


SPREAD_DO_NOT_SCHEDULE = "DoNotSchedule"
SPREAD_SCHEDULE_ANYWAY = "ScheduleAnyway"
SPREAD_UNSATISFIABLE_MODES = (SPREAD_DO_NOT_SCHEDULE, SPREAD_SCHEDULE_ANYWAY)


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


# ---------------------------------------------------------------------------
# PodClique
# ---------------------------------------------------------------------------


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
    """podclique.go:103-137."""

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


# ---------------------------------------------------------------------------
# PodCliqueScalingGroup
# ---------------------------------------------------------------------------


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
class PodCliqueScalingGroupSpec:
    """scalinggroup.go:50-71 (materialized CR spec)."""

    replicas: int = 1
    min_available: int = 1
    clique_names: List[str] = field(default_factory=list)


@dataclass
class PCSGRollingUpdateProgress:
    """scalinggroup.go:105-129."""

    update_started_at: float = 0.0
    update_ended_at: Optional[float] = None
    ready_replica_indices_selected_to_update: List[int] = field(default_factory=list)
    updated_replica_indices: List[int] = field(default_factory=list)


@dataclass
class PodCliqueScalingGroupStatus:
    """scalinggroup.go:73-103."""

    observed_generation: Optional[int] = None
    replicas: int = 0
    scheduled_replicas: int = 0
    available_replicas: int = 0
    updated_replicas: int = 0
    selector: Optional[str] = None
    conditions: List[Condition] = field(default_factory=list)
    rolling_update_progress: Optional[PCSGRollingUpdateProgress] = None
    last_errors: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class PodCliqueScalingGroup:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodCliqueScalingGroupSpec = field(default_factory=PodCliqueScalingGroupSpec)
    status: PodCliqueScalingGroupStatus = field(
        default_factory=PodCliqueScalingGroupStatus
    )
    kind: str = "PodCliqueScalingGroup"


# ---------------------------------------------------------------------------
# PodCliqueSet
# ---------------------------------------------------------------------------


@dataclass
class HeadlessServiceConfig:
    publish_not_ready_addresses: bool = True


@dataclass
class DisruptionBudget:
    """grove-tpu extension (docs/robustness.md "voluntary disruption"): a
    PodDisruptionBudget at GANG granularity, enforced by the
    DisruptionBroker (grove_tpu/disruption) against every VOLUNTARY
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


@dataclass
class TopologyPackConstraint:
    """scheduler podgang.go:101-114 — required/preferred hold *topology keys*
    (node-label keys), already translated from level names by the operator."""

    required: Optional[str] = None
    preferred: Optional[str] = None


@dataclass
class TopologySpreadConstraint:
    """grove-tpu extension of the PodGang contract (no reference analogue —
    'Topology Spread Constraints' is an unshipped roadmap item there):
    balance the gang's pods across the domains of `topology_key`, spanning
    at least `min_domains` distinct domains when `when_unsatisfiable` is
    DoNotSchedule."""

    topology_key: str = ""
    min_domains: int = 2
    when_unsatisfiable: str = SPREAD_DO_NOT_SCHEDULE


@dataclass
class SchedTopologyConstraint:
    """scheduler podgang.go:95-99 (+ the spread extension)."""

    pack_constraint: Optional[TopologyPackConstraint] = None
    spread_constraint: Optional[TopologySpreadConstraint] = None


@dataclass
class PodGroup:
    """scheduler podgang.go:76-91."""

    name: str
    pod_references: List[NamespacedName] = field(default_factory=list)
    min_replicas: int = 0
    topology_constraint: Optional[SchedTopologyConstraint] = None


@dataclass
class TopologyConstraintGroupConfig:
    """scheduler podgang.go:117-126 — PCSG-level pack groups."""

    pod_group_names: List[str] = field(default_factory=list)
    topology_constraint: Optional[SchedTopologyConstraint] = None


@dataclass
class PodGangSpec:
    """scheduler podgang.go:50-74."""

    pod_groups: List[PodGroup] = field(default_factory=list)
    topology_constraint: Optional[SchedTopologyConstraint] = None
    topology_constraint_group_configs: List[TopologyConstraintGroupConfig] = field(
        default_factory=list
    )
    priority_class_name: str = ""
    reuse_reservation_ref: Optional[NamespacedName] = None


@dataclass
class PodGangStatus:
    """scheduler podgang.go:168-176."""

    phase: str = PHASE_PENDING
    conditions: List[Condition] = field(default_factory=list)
    placement_score: Optional[float] = None


@dataclass
class PodGang:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGangSpec = field(default_factory=PodGangSpec)
    status: PodGangStatus = field(default_factory=PodGangStatus)
    kind: str = "PodGang"


# ---------------------------------------------------------------------------
# Queue (multi-tenant quota & fair-share — scheduler contract extension)
# ---------------------------------------------------------------------------

# The implicit root of the two-level queue tree; every tenant Queue's
# parent defaults to it. Not a CR — it exists only as the tree's anchor.
QUEUE_ROOT = "root"
# Queue gangs land in when their PodCliqueSet carries no queue label (and
# the implicit catch-all when no Queue CR of this name exists).
DEFAULT_QUEUE = "default"


@dataclass
class QueueSpec:
    """grove-tpu extension of the scheduler contract (docs/quota.md): a
    tenant capacity queue in a two-level tree (root → tenant queues),
    borrowing the deserved-share/ceiling semantics of capacity schedulers
    (Kueue ClusterQueue / KAI hierarchical queues — the feature set the
    reference delegates to the external KAI scheduler).

    ``deserved``: per-resource share the queue is entitled to; fair-share
    ordering ranks queues by dominant share usage/deserved, and a queue
    below its deserved share may RECLAIM capacity from queues above theirs.
    ``ceiling``: per-resource hard cap — gangs that would push usage past
    it are held pending (QueuePending) without consuming a solve slot."""

    parent: str = ""  # defaulted to QUEUE_ROOT (two-level tree only)
    deserved: Dict[str, float] = field(default_factory=dict)
    ceiling: Dict[str, float] = field(default_factory=dict)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "QueueSpec":
        return QueueSpec(
            parent=d.get("parent", ""),
            deserved=parse_resource_map(d.get("deserved")),
            ceiling=parse_resource_map(d.get("ceiling")),
        )


@dataclass
class QueueStatus:
    """Written by the gang scheduler each round (write-on-change)."""

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


# ---------------------------------------------------------------------------
# Generic child resources (Service / HPA / RBAC / Secret)
# ---------------------------------------------------------------------------


@dataclass
class GenericObject:
    """Lightweight stand-in for child kinds the operator materializes but the
    sim doesn't interpret deeply (headless Service, HPA, ServiceAccount, Role,
    RoleBinding, SA-token Secret)."""

    kind: str
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

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
