"""Validation: webhook-equivalent pure functions.

Counterpart of ``grove_tpu/admission/validation.py``.

Rule-for-rule re-host of
reference operator/internal/webhook/admission/pcs/validation/podcliqueset.go:59-530
(create + update paths) and validation/podcliquedeps.go:24-110 (startup-DAG
cycle detection via Tarjan SCC), plus ClusterTopology validation
(webhook/admission/clustertopology/validation/clustertopology.go).

Validation runs on the *defaulted* object (the reference orders webhooks the
same way: defaulting, then validation).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.topology import TOPOLOGY_DOMAIN_ORDER, ClusterTopology, broader_than
from grove_tpu_torch.api.types import (
    STARTUP_EXPLICIT,
    STARTUP_IN_ORDER,
    STARTUP_TYPES,
    PodCliqueSet,
)

_DNS1123_RE = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
# Pod hostnames are DNS labels: the worst-case generated pod name must fit.
MAX_HOSTNAME_LEN = 63


@dataclass
class ValidationResult:
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors

    def error(self, path: str, msg: str) -> None:
        self.errors.append(f"{path}: {msg}")

    def warn(self, msg: str) -> None:
        self.warnings.append(msg)


class ValidationError(Exception):
    def __init__(self, result: ValidationResult):
        self.result = result
        super().__init__("; ".join(result.errors))


# ---------------------------------------------------------------------------
# Dependency graph + Tarjan SCC (podcliquedeps.go)
# ---------------------------------------------------------------------------


class PodCliqueDependencyGraph:
    """startsAfter DAG; an SCC with >1 node (or a self-loop) is a cycle."""

    def __init__(self) -> None:
        self.adjacency: Dict[str, List[str]] = {}

    def add_dependencies(self, frm: str, to: List[str]) -> None:
        self.adjacency.setdefault(frm, []).extend(to)

    def unknown_cliques(self, discovered: List[str]) -> List[str]:
        known = set(discovered)
        out = []
        for deps in self.adjacency.values():
            out.extend(d for d in deps if d not in known)
        return out

    def strongly_connected_cliques(self) -> List[List[str]]:
        """Tarjan's SCC; single-node components only count with a self-loop
        (reference NOTE at podcliquedeps.go:55-57 excludes trivial SCCs)."""
        index_counter = [0]
        indices: Dict[str, int] = {}
        lowlink: Dict[str, int] = {}
        on_stack: Dict[str, bool] = {}
        stack: List[str] = []
        sccs: List[List[str]] = []

        def strong_connect(v: str) -> None:
            indices[v] = lowlink[v] = index_counter[0]
            index_counter[0] += 1
            stack.append(v)
            on_stack[v] = True
            for w in self.adjacency.get(v, []):
                if w not in indices:
                    strong_connect(w)
                    lowlink[v] = min(lowlink[v], lowlink[w])
                elif on_stack.get(w):
                    lowlink[v] = min(lowlink[v], indices[w])
            if lowlink[v] == indices[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1 or v in self.adjacency.get(v, []):
                    sccs.append(sorted(comp))

        for node in list(self.adjacency):
            if node not in indices:
                strong_connect(node)
        return sccs


# ---------------------------------------------------------------------------
# Create-path validation
# ---------------------------------------------------------------------------


def validate_podcliqueset(
    pcs: PodCliqueSet,
    topology: Optional[ClusterTopology] = None,
    is_update: bool = False,
) -> ValidationResult:
    res = ValidationResult()
    _validate_object_meta(pcs, res)
    _validate_spec(pcs, res, topology, is_update)
    return res


def validate_or_raise(
    pcs: PodCliqueSet, topology: Optional[ClusterTopology] = None
) -> ValidationResult:
    res = validate_podcliqueset(pcs, topology)
    if not res.ok:
        raise ValidationError(res)
    return res


def _validate_object_meta(pcs: PodCliqueSet, res: ValidationResult) -> None:
    name = pcs.metadata.name
    if not name:
        res.error("metadata.name", "name is required")
        return
    if not _DNS1123_RE.match(name):
        res.error("metadata.name", f"{name!r} must be a valid DNS-1123 label")


def _worst_case_pod_name_len(pcs: PodCliqueSet) -> Tuple[int, str]:
    """Longest generated pod hostname across cliques/groups at max replicas
    (the reference enforces generated-name budgets in
    validatePodCliqueNameConstraints / validateScalingGroupPodCliqueNames)."""
    worst, worst_name = 0, ""
    tmpl = pcs.spec.template
    max_pcs_rep = max(pcs.spec.replicas, 1)
    for clique in tmpl.standalone_clique_templates():
        max_pod = max(
            clique.spec.replicas,
            clique.spec.auto_scaling_config.max_replicas
            if clique.spec.auto_scaling_config
            else 0,
        )
        pclq = namegen.podclique_name(pcs.metadata.name, max_pcs_rep - 1, clique.name)
        pod = namegen.pod_name(pclq, max(max_pod - 1, 0))
        if len(pod) > worst:
            worst, worst_name = len(pod), pod
    for sg in tmpl.pod_clique_scaling_group_configs:
        max_sg_rep = max(
            sg.replicas or 1,
            sg.scale_config.max_replicas if sg.scale_config else 0,
        )
        for cname in sg.clique_names:
            clique = tmpl.clique_template(cname)
            if clique is None:
                continue
            pcsg_fqn = namegen.pcsg_name(pcs.metadata.name, max_pcs_rep - 1, sg.name)
            pclq = namegen.podclique_name(pcsg_fqn, max_sg_rep - 1, cname)
            pod = namegen.pod_name(pclq, max(clique.spec.replicas - 1, 0))
            if len(pod) > worst:
                worst, worst_name = len(pod), pod
    return worst, worst_name


def _validate_spec(
    pcs: PodCliqueSet,
    res: ValidationResult,
    topology: Optional[ClusterTopology],
    is_update: bool = False,
) -> None:
    spec = pcs.spec
    tmpl = spec.template
    if spec.replicas < 0:
        res.error("spec.replicas", "must be non-negative")

    if tmpl.startup_type not in STARTUP_TYPES:
        res.error(
            "spec.template.cliqueStartupType",
            f"unsupported value {tmpl.startup_type!r}; must be one of {STARTUP_TYPES}",
        )

    if tmpl.termination_delay is None:
        res.error("spec.template.terminationDelay", "field is required")
    elif tmpl.termination_delay <= 0:
        res.error(
            "spec.template.terminationDelay", "terminationDelay must be greater than 0"
        )

    # --- disruption budget (docs/robustness.md voluntary disruption) ----
    db = tmpl.disruption_budget
    if db is not None:
        if db.max_unavailable_gangs is None:
            res.error(
                "spec.template.disruptionBudget.maxUnavailableGangs",
                "field is required",
            )
        elif db.max_unavailable_gangs < 0:
            res.error(
                "spec.template.disruptionBudget.maxUnavailableGangs",
                "must be non-negative (0 blocks all voluntary disruption)",
            )
        elif db.max_unavailable_gangs == 0:
            res.warn(
                "disruptionBudget.maxUnavailableGangs=0 blocks every"
                " voluntary disruption, including rolling updates and"
                " node drains, until the budget is raised"
            )
        if db.quiet_window is not None and db.quiet_window < 0:
            res.error(
                "spec.template.disruptionBudget.quietWindow",
                "must be non-negative",
            )

    # --- cliques --------------------------------------------------------
    if not tmpl.cliques:
        res.error("spec.template.cliques", "at least one PodClique must be defined")
        return

    clique_names = [c.name for c in tmpl.cliques]
    _unique(clique_names, "spec.template.cliques.name", "clique names must be unique", res)
    role_names = [c.spec.role_name for c in tmpl.cliques if c.spec.role_name]
    _unique(
        role_names, "spec.template.cliques.roleName", "clique roleNames must be unique", res
    )

    scheduler_names = {
        c.spec.pod_spec.scheduler_name or "default-scheduler" for c in tmpl.cliques
    }
    if len(scheduler_names) > 1:
        res.error(
            "spec.template.cliques.spec.podSpec.schedulerName",
            "the schedulerName for all pods have to be the same",
        )

    sg_member_names = {
        n for sg in tmpl.pod_clique_scaling_group_configs for n in sg.clique_names
    }
    # A member clique's effective parent constraint is its scaling group's
    # (falling back to the PCS template's when the group has none).
    parent_tc_by_clique = {}
    for sg in tmpl.pod_clique_scaling_group_configs:
        for n in sg.clique_names:
            parent_tc_by_clique[n] = sg.topology_constraint or tmpl.topology_constraint

    explicit = tmpl.startup_type == STARTUP_EXPLICIT
    for i, clique in enumerate(tmpl.cliques):
        path = f"spec.template.cliques[{i}]"
        if not clique.name:
            res.error(f"{path}.name", "name is required")
        elif not _DNS1123_RE.match(clique.name):
            res.error(f"{path}.name", f"{clique.name!r} must be a valid DNS-1123 label")
        cs = clique.spec
        if cs.replicas <= 0:
            res.error(f"{path}.spec.replicas", "must be greater than 0")
        if cs.min_available is None:
            res.error(f"{path}.spec.minAvailable", "field is required")
        else:
            if cs.min_available <= 0:
                res.error(f"{path}.spec.minAvailable", "must be greater than 0")
            if cs.min_available > cs.replicas:
                res.error(
                    f"{path}.spec.minAvailable",
                    "minAvailable must not be greater than replicas",
                )
        if explicit and cs.starts_after:
            for dep in cs.starts_after:
                if not dep:
                    res.error(
                        f"{path}.spec.startsAfter", "clique dependency must not be empty"
                    )
                if dep == clique.name:
                    res.error(
                        f"{path}.spec.startsAfter",
                        "clique dependency cannot refer to itself",
                    )
            _unique(
                cs.starts_after,
                f"{path}.spec.startsAfter",
                "clique dependencies must be unique",
                res,
            )
        if cs.auto_scaling_config is not None:
            if clique.name in sg_member_names:
                res.error(
                    f"{path}.spec.autoScalingConfig",
                    "AutoScalingConfig is not allowed for a PodClique that is part of"
                    " a scaling group",
                )
            _validate_scale_config(
                cs.auto_scaling_config,
                cs.min_available or 0,
                f"{path}.spec.autoScalingConfig",
                res,
            )
            if cs.auto_scaling_config.max_replicas < cs.replicas:
                res.error(
                    f"{path}.spec.autoScalingConfig.maxReplicas",
                    "must be greater than or equal to replicas",
                )
        _validate_pod_spec(cs.pod_spec, f"{path}.spec.podSpec", res, is_update)
        if clique.topology_constraint is not None:
            _validate_topology_constraint(
                clique.topology_constraint,
                parent_tc_by_clique.get(clique.name, tmpl.topology_constraint),
                f"{path}.topologyConstraint",
                topology,
                res,
            )

    # --- scaling groups -------------------------------------------------
    sg_names = [sg.name for sg in tmpl.pod_clique_scaling_group_configs]
    _unique(
        sg_names,
        "spec.template.podCliqueScalingGroups.name",
        "PodCliqueScalingGroupConfig names must be unique",
        res,
    )
    all_sg_cliques: List[str] = []
    for j, sg in enumerate(tmpl.pod_clique_scaling_group_configs):
        path = f"spec.template.podCliqueScalingGroups[{j}]"
        if not sg.name:
            res.error(f"{path}.name", "name is required")
        elif not _DNS1123_RE.match(sg.name):
            res.error(f"{path}.name", f"{sg.name!r} must be a valid DNS-1123 label")
        unknown = [n for n in sg.clique_names if n not in clique_names]
        if unknown:
            res.error(
                f"{path}.cliqueNames", f"unidentified PodClique names found: {unknown}"
            )
        all_sg_cliques.extend(sg.clique_names)
        if sg.replicas is not None and sg.replicas <= 0:
            res.error(f"{path}.replicas", "must be greater than 0")
        if sg.min_available is not None:
            if sg.min_available <= 0:
                res.error(f"{path}.minAvailable", "must be greater than 0")
            if sg.replicas is not None and sg.min_available > sg.replicas:
                res.error(
                    f"{path}.minAvailable", "minAvailable must not be greater than replicas"
                )
        if sg.scale_config is not None:
            _validate_scale_config(
                sg.scale_config, sg.min_available or 0, f"{path}.scaleConfig", res
            )
        if sg.topology_constraint is not None:
            _validate_topology_constraint(
                sg.topology_constraint,
                tmpl.topology_constraint,
                f"{path}.topologyConstraint",
                topology,
                res,
            )
    _unique(
        all_sg_cliques,
        "spec.template.podCliqueScalingGroups.cliqueNames",
        "clique names must not overlap across scaling groups",
        res,
    )

    # --- startup DAG (Explicit only — podcliqueset.go:143-145; InOrder
    # derives the chain from declaration order and ignores startsAfter) -----
    if tmpl.startup_type == STARTUP_EXPLICIT:
        graph = PodCliqueDependencyGraph()
        for clique in tmpl.cliques:
            graph.add_dependencies(clique.name, list(clique.spec.starts_after))
        unknown = graph.unknown_cliques(clique_names)
        if unknown:
            res.error(
                "spec.template.cliques.startsAfter",
                f"dependencies refer to unknown cliques: {sorted(set(unknown))}",
            )
        cycles = graph.strongly_connected_cliques()
        if cycles:
            res.error(
                "spec.template.cliques",
                f"clique must not have circular dependencies: {cycles}",
            )

    # --- PCS-level topology constraint ---------------------------------
    if tmpl.topology_constraint is not None:
        _validate_topology_constraint(
            tmpl.topology_constraint,
            None,
            "spec.template.topologyConstraint",
            topology,
            res,
            allow_spread=True,
        )
        # gang-level spread and per-group (clique/PCSG) packs are mutually
        # exclusive: the balanced spread fill places the whole gang, so a
        # narrower per-group pack could not be honored at the same time
        if tmpl.topology_constraint.spread_domain is not None:
            offenders = [
                f"clique {c.name!r}"
                for c in tmpl.cliques
                if c.topology_constraint is not None
                and c.topology_constraint.pack_domain is not None
            ] + [
                f"scalingGroup {sg.name!r}"
                for sg in tmpl.pod_clique_scaling_group_configs
                if sg.topology_constraint is not None
                and sg.topology_constraint.pack_domain is not None
            ]
            if offenders:
                res.error(
                    "spec.template.topologyConstraint.spreadDomain",
                    "cannot be combined with per-clique or per-scaling-group"
                    f" packDomain constraints ({', '.join(offenders)})",
                )

    # --- generated-name budget ------------------------------------------
    worst, worst_name = _worst_case_pod_name_len(pcs)
    if worst > MAX_HOSTNAME_LEN:
        res.error(
            "metadata.name",
            f"generated pod hostname {worst_name!r} ({worst} chars) exceeds"
            f" {MAX_HOSTNAME_LEN}; shorten the PodCliqueSet/clique/group names",
        )


def _validate_scale_config(sc, min_available: int, path: str, res: ValidationResult) -> None:
    if sc.min_replicas is None:
        res.error(f"{path}.minReplicas", "field is required")
        return
    if sc.min_replicas < min_available:
        res.error(
            f"{path}.minReplicas",
            "must be greater than or equal to minAvailable",
        )
    if sc.max_replicas < sc.min_replicas:
        res.error(
            f"{path}.maxReplicas", "must be greater than or equal to minReplicas"
        )


def _validate_pod_spec(
    pod_spec, path: str, res: ValidationResult, is_update: bool = False
) -> None:
    if not pod_spec.containers:
        res.error(f"{path}.containers", "at least one container is required")
    if pod_spec.restart_policy and pod_spec.restart_policy != "Always":
        res.warn(f"{path}.restartPolicy will be ignored, it will be set to Always")
    # forbidden fields the operator owns (validatePodSpec — create path only,
    # matching the reference's operation==Create gate)
    if not is_update:
        if pod_spec.extra.get("topologySpreadConstraints"):
            res.error(f"{path}.topologySpreadConstraints", "must not be set")
        if pod_spec.extra.get("nodeName"):
            res.error(f"{path}.nodeName", "must not be set")


def _validate_topology_constraint(
    tc,
    parent_tc,
    path: str,
    topology: Optional[ClusterTopology],
    res: ValidationResult,
    allow_spread: bool = False,
) -> None:
    _validate_spread_constraint(tc, path, topology, res, allow_spread)
    if tc.pack_domain is None:
        return
    if tc.pack_domain not in TOPOLOGY_DOMAIN_ORDER:
        res.error(
            f"{path}.packDomain",
            f"unknown topology domain {tc.pack_domain!r}; must be one of"
            f" {sorted(TOPOLOGY_DOMAIN_ORDER)}",
        )
        return
    if topology is not None and topology.level_index(tc.pack_domain) is None:
        res.error(
            f"{path}.packDomain",
            f"domain {tc.pack_domain!r} is not a level of the cluster topology",
        )
    # Child constraints must be equal to or stricter than the parent's
    # (podcliqueset.go:232-234 docs on PCSG TopologyConstraint). A parent with
    # an unknown domain is reported at its own path; skip the comparison.
    if (
        parent_tc is not None
        and parent_tc.pack_domain is not None
        and parent_tc.pack_domain in TOPOLOGY_DOMAIN_ORDER
    ):
        if broader_than(tc.pack_domain, parent_tc.pack_domain):
            res.error(
                f"{path}.packDomain",
                f"must be equal to or stricter than the parent constraint"
                f" {parent_tc.pack_domain!r}",
            )


def _validate_spread_constraint(
    tc, path: str, topology, res: ValidationResult, allow_spread: bool
) -> None:
    """Topology SPREAD rules (grove-tpu extension; no reference analogue):
    gang-level only, known domain, strictly narrower than a packDomain it
    composes with, minDomains >= 2, whenUnsatisfiable enum."""
    from grove_tpu_torch.api.types import SPREAD_UNSATISFIABLE_MODES

    has_spread_fields = (
        tc.spread_domain is not None
        or tc.spread_min_domains is not None
        or tc.spread_when_unsatisfiable is not None
    )
    if not has_spread_fields:
        return
    if not allow_spread:
        res.error(
            f"{path}.spreadDomain",
            "spread constraints are only supported on the template-level"
            " topologyConstraint (the whole gang), not per clique or"
            " scaling group",
        )
        return
    if tc.spread_domain is None:
        res.error(
            f"{path}.spreadDomain",
            "spreadMinDomains/spreadWhenUnsatisfiable require spreadDomain",
        )
        return
    if tc.spread_domain not in TOPOLOGY_DOMAIN_ORDER:
        res.error(
            f"{path}.spreadDomain",
            f"unknown topology domain {tc.spread_domain!r}; must be one of"
            f" {sorted(TOPOLOGY_DOMAIN_ORDER)}",
        )
        return
    if topology is not None and topology.level_index(tc.spread_domain) is None:
        res.error(
            f"{path}.spreadDomain",
            f"domain {tc.spread_domain!r} is not a level of the cluster"
            " topology",
        )
    if (
        tc.pack_domain is not None
        and tc.pack_domain in TOPOLOGY_DOMAIN_ORDER
        and not broader_than(tc.pack_domain, tc.spread_domain)
    ):
        res.error(
            f"{path}.spreadDomain",
            f"must be strictly narrower than packDomain {tc.pack_domain!r}"
            " (pack into one broad domain, spread across the narrower"
            " domains inside it)",
        )
    if tc.spread_min_domains is not None and tc.spread_min_domains < 2:
        res.error(
            f"{path}.spreadMinDomains", "must be at least 2 when set"
        )
    if (
        tc.spread_when_unsatisfiable is not None
        and tc.spread_when_unsatisfiable not in SPREAD_UNSATISFIABLE_MODES
    ):
        res.error(
            f"{path}.spreadWhenUnsatisfiable",
            f"must be one of {list(SPREAD_UNSATISFIABLE_MODES)}",
        )


def _unique(items: List[str], path: str, msg: str, res: ValidationResult) -> None:
    seen = set()
    for it in items:
        if it in seen:
            res.error(path, f"{msg} (duplicate: {it!r})")
            return
        seen.add(it)


# ---------------------------------------------------------------------------
# Update-path validation (immutability)
# ---------------------------------------------------------------------------


def validate_podcliqueset_update(
    new: PodCliqueSet,
    old: PodCliqueSet,
    topology: Optional[ClusterTopology] = None,
) -> ValidationResult:
    """Full update validation: the create-path rules on the new object plus
    immutability checks — matching the reference webhook handler, which runs
    validate() then validateUpdate() on every update (admission handler.go).
    """
    res = validate_podcliqueset(new, topology, is_update=True)
    nt, ot = new.spec.template, old.spec.template

    if nt.startup_type != ot.startup_type:
        res.error("spec.template.cliqueStartupType", "field is immutable")

    if len(nt.cliques) != len(ot.cliques):
        res.error("spec.template.cliques", "not allowed to change clique composition")
    old_by_name = {c.name: (i, c) for i, c in enumerate(ot.cliques)}
    order_enforced = nt.startup_type in (STARTUP_IN_ORDER, STARTUP_EXPLICIT)
    for i, nc in enumerate(nt.cliques):
        if nc.name not in old_by_name:
            res.error(
                "spec.template.cliques.name",
                f"not allowed to change clique composition, new clique name"
                f" {nc.name!r} is not allowed",
            )
            continue
        oi, oc = old_by_name[nc.name]
        if order_enforced and i != oi:
            res.error(
                "spec.template.cliques",
                f"clique order cannot be changed when StartupType is InOrder or"
                f" Explicit (expected {oc.name!r} at position {oi})",
            )
        if nc.spec.role_name != oc.spec.role_name:
            res.error(f"spec.template.cliques[{i}].spec.roleName", "field is immutable")
        if nc.spec.min_available != oc.spec.min_available:
            res.error(
                f"spec.template.cliques[{i}].spec.minAvailable", "field is immutable"
            )
        if list(nc.spec.starts_after) != list(oc.spec.starts_after):
            res.error(
                f"spec.template.cliques[{i}].spec.startsAfter", "field is immutable"
            )

    if len(nt.pod_clique_scaling_group_configs) != len(
        ot.pod_clique_scaling_group_configs
    ):
        res.error(
            "spec.template.podCliqueScalingGroups",
            "not allowed to add or remove PodCliqueScalingGroupConfigs",
        )
        return res
    old_sgs = {sg.name: sg for sg in ot.pod_clique_scaling_group_configs}
    for sg in nt.pod_clique_scaling_group_configs:
        if sg.name not in old_sgs:
            res.error(
                "spec.template.podCliqueScalingGroups.name",
                f"not allowed to change scaling group composition, new scaling"
                f" group name {sg.name!r} is not allowed",
            )
            continue
        osg = old_sgs[sg.name]
        if list(sg.clique_names) != list(osg.clique_names):
            res.error(
                "spec.template.podCliqueScalingGroups.cliqueNames", "field is immutable"
            )
        if sg.min_available != osg.min_available:
            res.error(
                "spec.template.podCliqueScalingGroups.minAvailable",
                "field is immutable",
            )
    return res


# ---------------------------------------------------------------------------
# ClusterTopology validation
# ---------------------------------------------------------------------------


def validate_cluster_topology(topo: ClusterTopology) -> ValidationResult:
    """webhook/admission/clustertopology/validation: level enum membership,
    uniqueness, and broad→narrow ordering."""
    res = ValidationResult()
    levels = topo.spec.levels
    if not levels:
        res.error("spec.levels", "at least one level is required")
        return res
    if len(levels) > 7:
        res.error("spec.levels", "at most 7 levels are allowed")
    seen_domains, seen_keys = set(), set()
    prev_order = -1
    for i, lvl in enumerate(levels):
        if lvl.domain not in TOPOLOGY_DOMAIN_ORDER:
            res.error(f"spec.levels[{i}].domain", f"unknown domain {lvl.domain!r}")
            continue
        if lvl.domain in seen_domains:
            res.error(f"spec.levels[{i}].domain", f"duplicate domain {lvl.domain!r}")
        seen_domains.add(lvl.domain)
        if not lvl.key:
            res.error(f"spec.levels[{i}].key", "key is required")
        if lvl.key in seen_keys:
            res.error(f"spec.levels[{i}].key", f"duplicate key {lvl.key!r}")
        seen_keys.add(lvl.key)
        order = TOPOLOGY_DOMAIN_ORDER[lvl.domain]
        if order <= prev_order:
            res.error(
                f"spec.levels[{i}].domain",
                "levels must be ordered from broadest to narrowest",
            )
        prev_order = order
    return res


# ---------------------------------------------------------------------------
# Queue validation (quota subsystem — docs/quota.md)
# ---------------------------------------------------------------------------


def validate_queue(queue) -> ValidationResult:
    """Webhook-equivalent Queue validation: DNS-label name, two-level tree
    (parent must be the implicit root), non-negative shares, and per-resource
    ceiling >= deserved (a ceiling below the deserved share is unsatisfiable:
    the queue could never reach what fair-share ordering entitles it to)."""
    from grove_tpu_torch.api.types import QUEUE_ROOT

    res = ValidationResult()
    name = queue.metadata.name
    if not name or not _DNS1123_RE.match(name) or len(name) > 63:
        res.error("metadata.name", f"{name!r} is not a DNS-1123 label")
    if name == QUEUE_ROOT:
        res.error(
            "metadata.name",
            f"{QUEUE_ROOT!r} is the implicit tree root and cannot be a Queue",
        )
    if queue.spec.parent not in ("", QUEUE_ROOT):
        res.error(
            "spec.parent",
            f"must be {QUEUE_ROOT!r} (the queue tree is two-level: "
            "root -> tenant queues)",
        )
    for fname, shares in (
        ("deserved", queue.spec.deserved),
        ("ceiling", queue.spec.ceiling),
    ):
        for r, v in shares.items():
            if v < 0:
                res.error(f"spec.{fname}[{r}]", f"must be >= 0, got {v}")
    for r, cap in queue.spec.ceiling.items():
        deserved = queue.spec.deserved.get(r)
        if deserved is not None and cap < deserved:
            res.error(
                f"spec.ceiling[{r}]",
                f"ceiling {cap} is below deserved {deserved}",
            )
    if not queue.spec.deserved:
        res.warn(
            f"queue {name!r} has no deserved shares: it orders last whenever "
            "it holds any usage and can never justify a reclaim"
        )
    return res
