"""Defaulting: webhook-equivalent pure functions.

Counterpart of ``grove_tpu/admission/defaulting.py``.

Rule-for-rule re-host of
reference operator/internal/webhook/admission/pcs/defaulting/podcliqueset.go:35-120
(plus the kubebuilder schema defaults the apiserver applies before the webhook:
startupType=AnyOrder, PCSG replicas=1, PCSG minAvailable=1).
"""

from __future__ import annotations

from grove_tpu_torch.api.types import (
    DEFAULT_TERMINATION_DELAY_SECONDS,
    QUEUE_ROOT,
    SPREAD_DO_NOT_SCHEDULE,
    STARTUP_ANY_ORDER,
    HeadlessServiceConfig,
    PodCliqueSet,
    Queue,
)

DEFAULT_TERMINATION_GRACE_PERIOD = 30


def default_podcliqueset(pcs: PodCliqueSet) -> PodCliqueSet:
    """Mutates `pcs` in place (callers hold the only copy pre-store) and
    returns it."""
    if not pcs.metadata.namespace:
        pcs.metadata.namespace = "default"
    tmpl = pcs.spec.template

    # kubebuilder default — podcliqueset.go:128
    if tmpl.startup_type is None:
        tmpl.startup_type = STARTUP_ANY_ORDER
    # defaulting/podcliqueset.go:52-54 (4h)
    if tmpl.termination_delay is None:
        tmpl.termination_delay = DEFAULT_TERMINATION_DELAY_SECONDS
    # defaulting/podcliqueset.go:59-66
    if tmpl.headless_service_config is None:
        tmpl.headless_service_config = HeadlessServiceConfig(
            publish_not_ready_addresses=True
        )

    for clique in tmpl.cliques:
        spec = clique.spec
        if spec.replicas == 0:
            spec.replicas = 1
        if spec.min_available is None:
            spec.min_available = spec.replicas
        if spec.auto_scaling_config is not None:
            if spec.auto_scaling_config.min_replicas is None:
                spec.auto_scaling_config.min_replicas = spec.replicas
        pod_spec = spec.pod_spec
        if not pod_spec.restart_policy:
            pod_spec.restart_policy = "Always"
        pod_spec.extra.setdefault(
            "terminationGracePeriodSeconds", DEFAULT_TERMINATION_GRACE_PERIOD
        )

    # disruption budget defaults (grove-tpu extension — see
    # api/types.py DisruptionBudget): a budget block without an explicit
    # cap means "one gang at a time", the PDB-ish conservative default
    if tmpl.disruption_budget is not None:
        if tmpl.disruption_budget.max_unavailable_gangs is None:
            tmpl.disruption_budget.max_unavailable_gangs = 1

    # spread constraint defaults (grove-tpu extension — see
    # api/types.py TopologyConstraint)
    tc = tmpl.topology_constraint
    if tc is not None and tc.spread_domain is not None:
        if tc.spread_min_domains is None:
            tc.spread_min_domains = 2
        if tc.spread_when_unsatisfiable is None:
            tc.spread_when_unsatisfiable = SPREAD_DO_NOT_SCHEDULE

    for sg in tmpl.pod_clique_scaling_group_configs:
        # kubebuilder defaults — podcliqueset.go:211, :224
        if sg.replicas is None:
            sg.replicas = 1
        if sg.min_available is None:
            sg.min_available = 1
        if sg.scale_config is not None and sg.scale_config.min_replicas is None:
            sg.scale_config.min_replicas = sg.replicas

    return pcs


def default_queue(q: Queue) -> Queue:
    """Queue defaulting (quota subsystem, docs/quota.md): cluster-scoped,
    parent anchored at the implicit root (two-level tree)."""
    q.metadata.namespace = ""
    if not q.spec.parent:
        q.spec.parent = QUEUE_ROOT
    return q
