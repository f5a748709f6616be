"""Operator configuration: versioned file API with defaulting + validation.

Counterpart of ``grove_tpu/config/operator.py``.

Re-host of reference operator/api/config/ (types.go:52-200, defaults.go,
validation/validation.go): one YAML file configures the whole operator —
per-controller concurrency, leader election, server endpoints, logging,
the authorizer, and the cluster-topology reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import yaml

LOG_LEVELS = ("debug", "info", "error")
LOG_FORMATS = ("json", "text")


@dataclass
class ControllerConfig:
    """types.go:149-178 — per-controller ConcurrentSyncs."""

    concurrent_syncs: int = 1


@dataclass
class ControllersConfiguration:
    pod_clique_set: ControllerConfig = field(default_factory=ControllerConfig)
    pod_clique: ControllerConfig = field(default_factory=ControllerConfig)
    pod_clique_scaling_group: ControllerConfig = field(
        default_factory=ControllerConfig
    )


@dataclass
class LeaderElectionConfig:
    enabled: bool = False
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0
    resource_name: str = "grove-tpu-leader-election"


@dataclass
class ServerConfig:
    webhook_port: int = 9443
    metrics_port: int = 8080
    health_probe_port: int = 8081
    profiling_enabled: bool = False


@dataclass
class AuthorizerConfig:
    """types.go:180-190 — config-gated admission guard for managed children."""

    enabled: bool = False
    exempt_service_accounts: List[str] = field(default_factory=list)


@dataclass
class ClusterTopologyConfig:
    """types.go:192-200."""

    enabled: bool = False
    name: str = "default"


@dataclass
class SolverConfig:
    """TPU placement-engine knobs (no reference analogue — the solver is the
    piece the reference delegates to KAI)."""

    chunk_size: int = 128
    max_waves: int = 16
    priority_classes: Dict[str, int] = field(default_factory=dict)
    # route packing solves through a gRPC gang-solver sidecar (host:port;
    # empty -> solve in-process). BASELINE north-star boundary.
    sidecar_address: str = ""


@dataclass
class OperatorConfiguration:
    log_level: str = "info"
    log_format: str = "json"
    leader_election: LeaderElectionConfig = field(
        default_factory=LeaderElectionConfig
    )
    server: ServerConfig = field(default_factory=ServerConfig)
    controllers: ControllersConfiguration = field(
        default_factory=ControllersConfiguration
    )
    authorizer: AuthorizerConfig = field(default_factory=AuthorizerConfig)
    cluster_topology: ClusterTopologyConfig = field(
        default_factory=ClusterTopologyConfig
    )
    solver: SolverConfig = field(default_factory=SolverConfig)


def _controller(d: Dict[str, Any]) -> ControllerConfig:
    return ControllerConfig(concurrent_syncs=int(d.get("concurrentSyncs", 1)))


def load_operator_configuration(text: str) -> OperatorConfiguration:
    """Parse + default + validate (the reference pipeline in cmd/main.go)."""
    raw = yaml.safe_load(text) or {}
    cfg = OperatorConfiguration()
    cfg.log_level = raw.get("logLevel", cfg.log_level)
    cfg.log_format = raw.get("logFormat", cfg.log_format)
    le = raw.get("leaderElection") or {}
    cfg.leader_election = LeaderElectionConfig(
        enabled=bool(le.get("enabled", False)),
        lease_duration=float(le.get("leaseDuration", 15.0)),
        renew_deadline=float(le.get("renewDeadline", 10.0)),
        retry_period=float(le.get("retryPeriod", 2.0)),
        resource_name=le.get("resourceName", "grove-tpu-leader-election"),
    )
    srv = raw.get("server") or {}
    cfg.server = ServerConfig(
        webhook_port=int(srv.get("webhookPort", 9443)),
        metrics_port=int(srv.get("metricsPort", 8080)),
        health_probe_port=int(srv.get("healthProbePort", 8081)),
        profiling_enabled=bool(srv.get("profilingEnabled", False)),
    )
    ctrl = raw.get("controllers") or {}
    cfg.controllers = ControllersConfiguration(
        pod_clique_set=_controller(ctrl.get("podCliqueSet") or {}),
        pod_clique=_controller(ctrl.get("podClique") or {}),
        pod_clique_scaling_group=_controller(
            ctrl.get("podCliqueScalingGroup") or {}
        ),
    )
    auth = raw.get("authorizer") or {}
    cfg.authorizer = AuthorizerConfig(
        enabled=bool(auth.get("enabled", False)),
        exempt_service_accounts=list(auth.get("exemptServiceAccounts") or []),
    )
    topo = raw.get("clusterTopology") or {}
    cfg.cluster_topology = ClusterTopologyConfig(
        enabled=bool(topo.get("enabled", False)),
        name=topo.get("name", "default"),
    )
    solver = raw.get("solver") or {}
    cfg.solver = SolverConfig(
        chunk_size=int(solver.get("chunkSize", 128)),
        max_waves=int(solver.get("maxWaves", 16)),
        priority_classes=dict(solver.get("priorityClasses") or {}),
        sidecar_address=str(solver.get("sidecarAddress", "")),
    )
    validate_operator_configuration(cfg)
    return cfg


def load_operator_configuration_file(path: str) -> OperatorConfiguration:
    with open(path) as f:
        return load_operator_configuration(f.read())


def validate_operator_configuration(cfg: OperatorConfiguration) -> None:
    """validation/validation.go rule set."""
    errors = []
    if cfg.log_level not in LOG_LEVELS:
        errors.append(f"logLevel must be one of {LOG_LEVELS}")
    if cfg.log_format not in LOG_FORMATS:
        errors.append(f"logFormat must be one of {LOG_FORMATS}")
    for name, ctrl in (
        ("podCliqueSet", cfg.controllers.pod_clique_set),
        ("podClique", cfg.controllers.pod_clique),
        ("podCliqueScalingGroup", cfg.controllers.pod_clique_scaling_group),
    ):
        if ctrl.concurrent_syncs <= 0:
            errors.append(f"controllers.{name}.concurrentSyncs must be > 0")
    le = cfg.leader_election
    if le.enabled:
        if le.lease_duration <= le.renew_deadline:
            errors.append("leaderElection.leaseDuration must exceed renewDeadline")
        if le.renew_deadline <= le.retry_period:
            errors.append("leaderElection.renewDeadline must exceed retryPeriod")
    for port_name, port in (
        ("webhookPort", cfg.server.webhook_port),
        ("metricsPort", cfg.server.metrics_port),
        ("healthProbePort", cfg.server.health_probe_port),
    ):
        if not (0 < port < 65536):
            errors.append(f"server.{port_name} must be a valid port")
    if cfg.cluster_topology.enabled and not cfg.cluster_topology.name:
        errors.append("clusterTopology.name is required when enabled")
    if cfg.solver.chunk_size <= 0 or cfg.solver.max_waves <= 0:
        errors.append("solver.chunkSize and solver.maxWaves must be > 0")
    if errors:
        raise ValueError("invalid operator configuration: " + "; ".join(errors))
