"""PodClique status flow.

Counterpart of ``grove_tpu/controller/podclique/status.py``.

Re-host of reference operator/internal/controller/podclique/reconcilestatus.go:
pod categorization → replica counters → PodCliqueScheduled and
MinAvailableBreached conditions. The two subtle rules preserved exactly:
- NOT breached while scheduledReplicas < minAvailable (never gang-terminate a
  gang that was never scheduled — reconcilestatus.go:192-201)
- "starting" pods (scheduled, no container started-and-failed signal yet)
  count as available; pods with a non-zero container exit, or started-but-
  not-ready pods, count against availability (reconcilestatus.go:205-215)
"""

from __future__ import annotations

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import Condition, set_condition
from grove_tpu_torch.api.pod import (
    has_erroneous_exit,
    is_ready,
    is_schedule_gated,
    is_scheduled,
    is_terminating,
)
from grove_tpu_torch.api.types import (
    COND_MIN_AVAILABLE_BREACHED,
    COND_POD_CLIQUE_SCHEDULED,
    PodClique,
)
from grove_tpu_torch.controller.common import OperatorContext

UPDATE_IN_PROGRESS_ANNOTATION = "grove.io/update-in-progress"


def compute_status(ctx: OperatorContext, pclq: PodClique, pods=None):
    """The status `pclq` SHOULD have, computed WITHOUT mutating it — safe on
    zero-copy readonly store views. The reconciler compares the result
    against the live status and writes only on difference, so steady-state
    reconciles cost no serialization at all (the write-free analogue of the
    reference's status-patch-if-changed). ``pods``: optional pre-scanned
    pod views shared with the pod-sync flow (one scan per reconcile)."""
    from grove_tpu_torch.controller.common import status_shadow

    shadow = status_shadow(pclq)
    reconcile_status(ctx, shadow, pods)
    return shadow.status


def reconcile_status(ctx: OperatorContext, pclq: PodClique, pods=None) -> PodClique:
    ns = pclq.metadata.namespace
    st = pclq.status
    current_hash = pclq.metadata.labels.get(namegen.LABEL_POD_TEMPLATE_HASH)
    counters = None
    if pods is None:
        # event-driven aggregation: the store maintains these counters
        # incrementally from watch deltas (runtime/aggregate.py), exactly
        # equal to a full rescan of the same cached view — so the per-event
        # O(pods) rescan drops to O(1). HttpStore has no aggregate (reads
        # are live lists); it keeps the scan below.
        pod_counters = getattr(ctx.store, "pod_counters", None)
        if pod_counters is not None:
            counters = pod_counters(ns, pclq.metadata.name, cached=True)
    if counters is not None:
        st.replicas = counters.total
        st.ready_replicas = counters.ready
        st.scheduled_replicas = counters.scheduled
        st.schedule_gated_replicas = counters.gated
        st.updated_replicas = counters.updated(current_hash)
        num_error_exits = counters.error_exits
        num_started_not_ready = counters.started_not_ready
    else:
        if pods is None:
            pods = ctx.store.scan(
                "Pod", ns, {namegen.LABEL_PODCLIQUE: pclq.metadata.name}, cached=True
            )
        pods = [p for p in pods if not is_terminating(p)]
        st.replicas = len(pods)
        st.ready_replicas = sum(1 for p in pods if is_ready(p))
        st.scheduled_replicas = sum(1 for p in pods if is_scheduled(p))
        st.schedule_gated_replicas = sum(1 for p in pods if is_schedule_gated(p))
        st.updated_replicas = sum(
            1
            for p in pods
            if current_hash
            and p.metadata.labels.get(namegen.LABEL_POD_TEMPLATE_HASH) == current_hash
        )
        num_error_exits = sum(
            1 for p in pods if not is_ready(p) and has_erroneous_exit(p)
        )
        num_started_not_ready = sum(
            1
            for p in pods
            if is_scheduled(p)
            and not is_ready(p)
            and not has_erroneous_exit(p)
            and any(cs.started for cs in p.status.container_statuses)
        )
    st.selector = f"{namegen.LABEL_PODCLIQUE}={pclq.metadata.name}"
    now = ctx.clock.now()
    set_condition(
        st.conditions, _scheduled_condition(pclq), now
    )
    set_condition(
        st.conditions,
        _min_available_breached_condition(pclq, num_error_exits, num_started_not_ready),
        now,
    )
    return pclq


def _scheduled_condition(pclq: PodClique) -> Condition:
    """reconcilestatus.go:238-254."""
    min_available = pclq.spec.min_available or 0
    if pclq.status.scheduled_replicas < min_available:
        return Condition(
            type=COND_POD_CLIQUE_SCHEDULED,
            status="False",
            reason="InsufficientScheduledPods",
            message=(
                f"Insufficient scheduled pods. expected at least: {min_available},"
                f" found: {pclq.status.scheduled_replicas}"
            ),
        )
    return Condition(
        type=COND_POD_CLIQUE_SCHEDULED,
        status="True",
        reason="SufficientScheduledPods",
        message="Sufficient scheduled pods found",
    )


def _min_available_breached_condition(
    pclq: PodClique, num_error_exits: int, num_started_not_ready: int
) -> Condition:
    """reconcilestatus.go:177-225."""
    if pclq.metadata.annotations.get(UPDATE_IN_PROGRESS_ANNOTATION):
        return Condition(
            type=COND_MIN_AVAILABLE_BREACHED,
            status="Unknown",
            reason="UpdateInProgress",
            message="Update is in progress",
        )
    min_available = pclq.spec.min_available or 0
    scheduled = pclq.status.scheduled_replicas
    if scheduled < min_available:
        return Condition(
            type=COND_MIN_AVAILABLE_BREACHED,
            status="False",
            reason="InsufficientScheduledPods",
            message=(
                f"Insufficient scheduled pods. expected at least: {min_available},"
                f" found: {scheduled}"
            ),
        )
    ready_or_starting = scheduled - num_error_exits - num_started_not_ready
    if ready_or_starting < min_available:
        return Condition(
            type=COND_MIN_AVAILABLE_BREACHED,
            status="True",
            reason="InsufficientReadyPods",
            message=(
                f"Insufficient ready or starting pods. expected at least:"
                f" {min_available}, found: {ready_or_starting}"
            ),
        )
    return Condition(
        type=COND_MIN_AVAILABLE_BREACHED,
        status="False",
        reason="SufficientReadyPods",
        message="Sufficient ready or starting pods found",
    )
