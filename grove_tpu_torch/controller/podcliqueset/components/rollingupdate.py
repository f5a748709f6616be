"""PCS rolling-update orchestration: one replica at a time.

Counterpart of ``grove_tpu/controller/podcliqueset/components/rollingupdate.py``.

Re-host of reference operator/internal/controller/podcliqueset/components/
podcliquesetreplica/rollingupdate.go:39-260:
- triggered by a generation-hash change (reconcilespec.go:72-123; the
  reconciler seeds status.rolling_update_progress)
- replica pick order (rollingupdate.go:196-223): no-scheduled-pods first,
  then MinAvailableBreached-but-not-expired, then ascending index
- the selected replica's PodCliques (standalone + scaling-group-owned) get
  the new template spec + pod-template-hash pushed atomically, plus the
  update-in-progress annotation that turns MinAvailableBreached Unknown
  (podclique/reconcilestatus.go UpdateInProgress) so the gang terminator
  never fires mid-update
- a replica completes when every PCLQ reports updatedReplicas >= replicas and
  ready >= minAvailable; then the next replica is picked; when none remain,
  update_ended_at is stamped
"""

from __future__ import annotations

from typing import List, Optional

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.hashing import pod_template_hash_for
from grove_tpu_torch.api.meta import get_condition
from grove_tpu_torch.api.types import (
    COND_MIN_AVAILABLE_BREACHED,
    PCSReplicaRollingUpdateProgress,
    PodCliqueSet,
)
from grove_tpu_torch.controller.common import OperatorContext
from grove_tpu_torch.controller.podclique.status import UPDATE_IN_PROGRESS_ANNOTATION


def sync(ctx: OperatorContext, pcs: PodCliqueSet) -> Optional[float]:
    """Run one step of the rolling update. Returns a requeue delay while the
    update is in flight, None when idle/complete.

    `pcs` may be the reconciler's readonly view: the steady state (no update
    in flight) returns without touching the store; an ACTIVE update switches
    to a private mutable copy for the whole step (this flow tracks its
    progress in pcs.status)."""
    progress = pcs.status.rolling_update_progress
    if progress is None or progress.update_ended_at is not None:
        return None
    pcs = ctx.store.get("PodCliqueSet", pcs.metadata.namespace, pcs.metadata.name)
    if pcs is None or pcs.metadata.deletion_timestamp is not None:
        return None
    progress = pcs.status.rolling_update_progress
    if progress is None or progress.update_ended_at is not None:
        return None

    current = progress.currently_updating
    if current is not None:
        if not _replica_update_done(ctx, pcs, current.replica_index):
            _push_template_to_replica(ctx, pcs, current.replica_index)
            return 2.0
        _complete_replica(ctx, pcs, current.replica_index)
        pcs = ctx.store.get("PodCliqueSet", pcs.metadata.namespace, pcs.metadata.name)
        progress = pcs.status.rolling_update_progress

    next_replica = _pick_next_replica(ctx, pcs)
    if next_replica is not None and not _disruption_granted(
        ctx, pcs, next_replica
    ):
        # the replica's gangs are protected right now (disruptionBudget /
        # quiet window / storm breaker — grove_tpu/disruption): keep the
        # update pending and retry; the broker emitted DisruptionThrottled
        return 2.0
    if next_replica is None:
        progress.update_ended_at = ctx.clock.now()
        progress.currently_updating = None
        ctx.store.update_status(pcs)
        ctx.record_event(
            "PodCliqueSet",
            "RollingUpdateCompleted",
            pcs.metadata.name,
            namespace=pcs.metadata.namespace,
            name=pcs.metadata.name,
        )
        return None
    progress.currently_updating = PCSReplicaRollingUpdateProgress(
        replica_index=next_replica, update_started_at=ctx.clock.now()
    )
    ctx.store.update_status(pcs)
    ctx.record_event(
        "PodCliqueSet",
        "RollingUpdateReplicaStarted",
        f"{pcs.metadata.name} replica {next_replica}",
        namespace=pcs.metadata.namespace,
        name=pcs.metadata.name,
    )
    _push_template_to_replica(ctx, pcs, next_replica)
    return 2.0


# ---------------------------------------------------------------------------
# disruption gate (grove_tpu/disruption, docs/robustness.md)
# ---------------------------------------------------------------------------


def _replica_gangs(ctx: OperatorContext, pcs: PodCliqueSet, replica: int) -> List:
    """Every PodGang the replica owns: the base gang `{pcs}-{replica}` plus
    scaled gangs named under its PCSGs (`{pcs}-{replica}-{sg}-{i}`)."""
    base = namegen.base_podgang_name(pcs.metadata.name, replica)
    prefix = f"{base}-"
    return [
        g
        for g in ctx.store.list(
            "PodGang",
            pcs.metadata.namespace,
            namegen.default_labels(pcs.metadata.name),
        )
        if g.metadata.name == base or g.metadata.name.startswith(prefix)
    ]


def _disruption_granted(
    ctx: OperatorContext, pcs: PodCliqueSet, replica: int
) -> bool:
    """Rolling updates are voluntary disruptions: before the replica's
    cliques get the new template (and their pods die), the whole replica's
    gang set must clear the broker in one grant — and the granted gangs
    are marked DisruptionTarget=RollingUpdate, so the per-PCS budget
    invariant and gauges see a mid-update replica exactly like a drained
    one (a concurrent drain on the same set is then denied)."""
    if ctx.disruption is None or not ctx.disruption.active():
        return True
    gangs = _replica_gangs(ctx, pcs, replica)
    if not gangs:
        return True
    if not ctx.disruption.grant(gangs, "rolling-update"):
        return False
    from grove_tpu_torch.api.meta import Condition, set_condition
    from grove_tpu_torch.api.types import COND_PODGANG_DISRUPTION_TARGET
    from grove_tpu_torch.runtime.errors import ERR_CONFLICT, GroveError

    for gang in gangs:
        # conflict-tolerant: the scheduler flips this back to False
        # (reason Rescheduled) once the updated gang re-places
        for _ in range(4):
            fresh = ctx.store.get(
                "PodGang", gang.metadata.namespace, gang.metadata.name
            )
            if fresh is None:
                break
            set_condition(
                fresh.status.conditions,
                Condition(
                    type=COND_PODGANG_DISRUPTION_TARGET,
                    status="True",
                    reason="RollingUpdate",
                    message=f"replica {replica} selected for rolling update",
                ),
                ctx.clock.now(),
            )
            try:
                ctx.store.update_status(fresh)
                break
            except GroveError as e:
                if e.code != ERR_CONFLICT:
                    raise
    return True


# ---------------------------------------------------------------------------
# replica selection
# ---------------------------------------------------------------------------


def _replica_pclqs(ctx: OperatorContext, pcs: PodCliqueSet, replica: int) -> List:
    return ctx.store.list(
        "PodClique",
        pcs.metadata.namespace,
        {
            **namegen.default_labels(pcs.metadata.name),
            namegen.LABEL_PCS_REPLICA_INDEX: str(replica),
        },
    )


def _replica_needs_update(ctx: OperatorContext, pcs: PodCliqueSet, replica: int) -> bool:
    for pclq in _replica_pclqs(ctx, pcs, replica):
        tmpl_name = _clique_template_name(pcs, pclq)
        want = pod_template_hash_for(pcs, tmpl_name)
        if want is None:
            continue
        if pclq.metadata.labels.get(namegen.LABEL_POD_TEMPLATE_HASH) != want:
            return True
        if pclq.status.updated_replicas < pclq.spec.replicas:
            return True
    return False


def _clique_template_name(pcs: PodCliqueSet, pclq) -> str:
    """PCLQ FQN → clique template name (strip owner + replica prefix)."""
    pcsg = pclq.metadata.labels.get(namegen.LABEL_PCSG)
    owner = pcsg if pcsg else pcs.metadata.name
    owner_replica = (
        pclq.metadata.labels.get(namegen.LABEL_PCSG_REPLICA_INDEX)
        if pcsg
        else pclq.metadata.labels.get(namegen.LABEL_PCS_REPLICA_INDEX, "0")
    )
    prefix = f"{owner}-{owner_replica}-"
    return pclq.metadata.name[len(prefix):]


def _pick_next_replica(ctx: OperatorContext, pcs: PodCliqueSet) -> Optional[int]:
    """rollingupdate.go:196-250 ordering."""
    candidates = []
    for replica in range(pcs.spec.replicas):
        if not _replica_needs_update(ctx, pcs, replica):
            continue
        pclqs = _replica_pclqs(ctx, pcs, replica)
        scheduled = sum(p.status.scheduled_replicas for p in pclqs)
        breached = any(
            (c := get_condition(p.status.conditions, COND_MIN_AVAILABLE_BREACHED))
            is not None
            and c.is_true()
            for p in pclqs
        )
        candidates.append((0 if scheduled == 0 else 1, 0 if breached else 1, replica))
    if not candidates:
        return None
    return sorted(candidates)[0][2]


# ---------------------------------------------------------------------------
# template push + completion
# ---------------------------------------------------------------------------


def _push_template_to_replica(
    ctx: OperatorContext, pcs: PodCliqueSet, replica: int
) -> None:
    """Update spec + hash label (+ update-in-progress marker) on the
    replica's STANDALONE PodCliques. PCSG-owned cliques are updated by the
    PCSG controller's own replica-by-replica rolling update (reference
    granularity — pcsg components/podclique/rollingupdate.go:55-260), gated
    on this PCS replica being the currently-selected one."""
    from grove_tpu_torch.controller.common import apply_template_to_pclq

    for pclq in _replica_pclqs(ctx, pcs, replica):
        if pclq.metadata.labels.get(namegen.LABEL_PCSG):
            continue  # PCSG controller's responsibility
        name = _clique_template_name(pcs, pclq)
        apply_template_to_pclq(ctx, pcs, pclq, name)


def _replica_update_done(ctx: OperatorContext, pcs: PodCliqueSet, replica: int) -> bool:
    pclqs = _replica_pclqs(ctx, pcs, replica)
    if not pclqs:
        return True
    for pclq in pclqs:
        name = _clique_template_name(pcs, pclq)
        want = pod_template_hash_for(pcs, name)
        if want is None:
            continue
        if pclq.metadata.labels.get(namegen.LABEL_POD_TEMPLATE_HASH) != want:
            return False
        if pclq.status.updated_replicas < pclq.spec.replicas:
            return False
        if pclq.status.ready_replicas < (pclq.spec.min_available or 1):
            return False
    return True


def _finish_pcsg_progress(ctx: OperatorContext, pcs: PodCliqueSet, replica: int) -> None:
    sel = {
        **namegen.default_labels(pcs.metadata.name),
        namegen.LABEL_PCS_REPLICA_INDEX: str(replica),
    }
    for pcsg in ctx.store.list("PodCliqueScalingGroup", pcs.metadata.namespace, sel):
        progress = pcsg.status.rolling_update_progress
        if progress is not None and progress.update_ended_at is None:
            progress.update_ended_at = ctx.clock.now()
            progress.updated_replica_indices = list(range(pcsg.spec.replicas))
            progress.ready_replica_indices_selected_to_update = []
            ctx.store.update_status(pcsg)


def _complete_replica(ctx: OperatorContext, pcs: PodCliqueSet, replica: int) -> None:
    _finish_pcsg_progress(ctx, pcs, replica)
    progress = pcs.status.rolling_update_progress
    for pclq in _replica_pclqs(ctx, pcs, replica):
        if UPDATE_IN_PROGRESS_ANNOTATION in pclq.metadata.annotations:
            pclq.metadata.annotations.pop(UPDATE_IN_PROGRESS_ANNOTATION)
            ctx.store.update(pclq, bump_generation=False)
        if pclq.metadata.labels.get(namegen.LABEL_PCSG):
            if pclq.metadata.labels[namegen.LABEL_PCSG] not in (
                progress.updated_pod_clique_scaling_groups
            ):
                progress.updated_pod_clique_scaling_groups.append(
                    pclq.metadata.labels[namegen.LABEL_PCSG]
                )
        elif pclq.metadata.name not in progress.updated_pod_cliques:
            progress.updated_pod_cliques.append(pclq.metadata.name)
    progress.currently_updating = None
    ctx.store.update_status(pcs)
    ctx.record_event(
        "PodCliqueSet",
        "RollingUpdateReplicaCompleted",
        f"{pcs.metadata.name} replica {replica}",
        namespace=pcs.metadata.namespace,
        name=pcs.metadata.name,
    )
