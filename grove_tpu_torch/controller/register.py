"""Controller registration: wire the three reconcilers + watch mappings.

Counterpart of ``grove_tpu/controller/register.py``.

Re-host of reference operator/internal/controller/register.go:29-43 and
the per-controller watch wiring (podclique/register.go:49-278 etc.), in the
same PCS → PCLQ → PCSG order.
"""

from __future__ import annotations

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.types import COND_MIN_AVAILABLE_BREACHED
from grove_tpu_torch.controller.common import OperatorContext
from grove_tpu_torch.controller.podclique.reconciler import PodCliqueReconciler
from grove_tpu_torch.controller.podcliquescalinggroup.reconciler import (
    PodCliqueScalingGroupReconciler,
)
from grove_tpu_torch.controller.podcliqueset.reconciler import PodCliqueSetReconciler
from grove_tpu_torch.runtime.engine import Controller, Engine
from grove_tpu_torch.runtime.store import ADDED, DELETED, MODIFIED


# ---------------------------------------------------------------------------
# Watch predicates (controller-runtime predicate.Funcs re-hosts).
#
# Every predicate fails OPEN on a MODIFIED event with no `old` payload
# (e.g. an HttpStore informer fresh off a reconnect): an extra reconcile is
# idempotent, a skipped one can stall convergence. The store's no-op write
# suppression already removed events with NO change; these predicates
# remove events whose change is IRRELEVANT to the subscribing controller —
# at stress scale (10k sets / 47k pods) unfiltered pod status churn fanning
# into the PodCliqueSet controller was the single largest reconcile source.
# ---------------------------------------------------------------------------


def _cond_status(conditions, cond_type):
    for c in conditions:
        if c.type == cond_type:
            return c.status
    return None


def _breach_changed(old_status, new_status) -> bool:
    """hasMinAvailableBreachedConditionChanged (podcliqueset/register.go
    :146-158): only the condition's STATUS flip matters."""
    return _cond_status(
        old_status.conditions, COND_MIN_AVAILABLE_BREACHED
    ) != _cond_status(new_status.conditions, COND_MIN_AVAILABLE_BREACHED)


def generation_changed(ev) -> bool:
    """predicate.GenerationChangedPredicate (podcliqueset/register.go:53):
    pass creates/deletes; pass updates only on a spec (generation) change,
    so a controller's own status writes never re-enqueue it.

    Deletion-mark and finalizer transitions also pass: a real apiserver
    bumps metadata.generation when deletionTimestamp is set, but the
    repo's store models that as a version-only write — without this the
    finalizer-gated delete flow would never run. Label/annotation
    transitions pass for the same reason: metadata-only writes use
    bump_generation=False here (e.g. the rolling-update flow popping
    UPDATE_IN_PROGRESS_ANNOTATION, rollingupdate.py:204) where a real
    apiserver WOULD bump generation, and that pop is the only signal that
    un-suspends the MinAvailableBreached condition."""
    if ev.type != MODIFIED or ev.old is None:
        return True
    om, nm = ev.old.metadata, ev.obj.metadata
    return (
        nm.generation != om.generation
        or nm.deletion_timestamp != om.deletion_timestamp
        or nm.finalizers != om.finalizers
        or nm.annotations != om.annotations
        or nm.labels != om.labels
    )


def pclq_changed_for_owner(ev) -> bool:
    """podCliquePredicate (podcliqueset/register.go:90-103): creates are
    the owner's own doing; deletes always matter; updates matter when the
    spec, any status replica counter, or the breach condition moved."""
    if ev.type == ADDED:
        return False
    if ev.type == DELETED:
        return True
    if ev.old is None:
        return True
    old, new = ev.old, ev.obj
    if old.metadata.generation != new.metadata.generation:
        return True
    os, ns = old.status, new.status
    return (
        os.replicas != ns.replicas
        or os.ready_replicas != ns.ready_replicas
        or os.schedule_gated_replicas != ns.schedule_gated_replicas
        # the repo's PCS status/rolling-update flows also aggregate these
        # two (reconciler.py), so their transitions must requeue the owner
        # — the reference's narrower triple suffices for ITS status flow
        or os.scheduled_replicas != ns.scheduled_replicas
        or os.updated_replicas != ns.updated_replicas
        or _breach_changed(os, ns)
    )


def pcsg_changed_for_owner(ev) -> bool:
    """podCliqueScalingGroupPredicate (podcliqueset/register.go:105-120)
    plus the replica counters the repo's PCS status flow aggregates."""
    if ev.type != MODIFIED:
        return ev.type != ADDED
    if ev.old is None:
        return True
    os, ns = ev.old.status, ev.obj.status
    return (
        os.replicas != ns.replicas
        or os.scheduled_replicas != ns.scheduled_replicas
        or os.available_replicas != ns.available_replicas
        or os.updated_replicas != ns.updated_replicas
        or os.rolling_update_progress != ns.rolling_update_progress
        or _breach_changed(os, ns)
    )


def pcs_hash_changed(ev) -> bool:
    """podCliqueSetPredicate (podclique/register.go:191-205): children
    re-reconcile on a PCS event only when the rolled-out generation hash
    moves (the signal that a rolling update started/advanced). Everything
    else a child needs arrives via its own kinds' events."""
    if ev.type != MODIFIED:
        return ev.type == DELETED
    if ev.old is None:
        return True
    return (
        ev.old.status.current_generation_hash
        != ev.obj.status.current_generation_hash
    )


def pod_status_transition(ev) -> bool:
    """podPredicate (podclique/register.go:99-116): creates are the
    PCLQ's own doing (its creating reconcile re-counts in the same flow);
    deletes always matter; updates matter only when the pod's lifecycle
    actually moved (phase, binding, conditions incl. Ready/PodScheduled,
    gates, init-waiter completion, labels, or deletion mark)."""
    if ev.type == ADDED:
        return False
    if ev.type == DELETED:
        return True
    if ev.old is None:
        return True
    old, new = ev.old, ev.obj
    os, ns = old.status, new.status
    return (
        os.phase != ns.phase
        or os.node_name != ns.node_name
        or os.init_waiter_done != ns.init_waiter_done
        or os.conditions != ns.conditions
        or old.spec.scheduling_gates != new.spec.scheduling_gates
        or old.metadata.deletion_timestamp != new.metadata.deletion_timestamp
        or old.metadata.labels != new.metadata.labels
    )


def pcs_rolling_pointer_changed(ev) -> bool:
    """shouldEnqueueOnPCSUpdate (podcliquescalinggroup/register.go:114-145):
    the PCSG controller re-reconciles on a PCS event when the rolled-out
    hash moves (update starts) or the rolling update's currently-updating
    replica POINTER moves (its replica's turn arrives) — both are status
    writes a generation/hash-only gate would swallow."""
    if ev.type != MODIFIED:
        return ev.type == DELETED
    if ev.old is None:
        return True

    def pointer(pcs):
        prog = pcs.status.rolling_update_progress
        if prog is None or prog.currently_updating is None:
            return None
        return prog.currently_updating.replica_index

    return (
        pointer(ev.old) != pointer(ev.obj)
        or ev.old.status.current_generation_hash
        != ev.obj.status.current_generation_hash
    )


def pcsg_rolling_progress_changed(ev) -> bool:
    """podCliqueScalingGroupPredicate on the PCLQ controller
    (podclique/register.go:225-240): constituent PCLQs re-reconcile on a
    PCSG event only when its rolling-update progress moved (the replica
    selection that tells a PCLQ its pods are next)."""
    if ev.type != MODIFIED:
        return False
    if ev.old is None:
        return True
    return (
        ev.old.status.rolling_update_progress
        != ev.obj.status.rolling_update_progress
    )


def podgang_phase_or_spec_changed(ev) -> bool:
    """PodGang events fan out on creation, deletion, SPEC changes (pod
    membership / reservation hints — written with bump_generation=False,
    podgang.py:327, so compared structurally, not via generation), PHASE
    transitions (the base-gang-scheduled signal that unblocks deferred
    scaled-gang creation and pod ungating), and CONDITION transitions (the
    PCS status flow mirrors gang conditions into pod_gang_statuses,
    reconciler.py — a condition-only flip like Unhealthy must refresh the
    mirror; condition flips are rare because the store suppresses no-op
    writes) — NOT on placement-score touches, which move on every
    re-admission. Conditions are compared by (type, status, reason) only:
    _mark_scheduled embeds the score in the Scheduled condition's MESSAGE
    (scheduler.py), so a message-sensitive compare would re-admit the very
    score churn this predicate exists to filter. Reference analogue:
    podGangPredicate
    (podclique/register.go:271-278) passes all updates. The contract test
    (tests/test_podgang_status_contract.py) asserts controller flows read
    ONLY the fields this predicate passes — a new consumer of
    placement_score breaks the build instead of stalling behind the
    filter. DELETED passes so an out-of-band gang deletion re-runs the
    owner's podgang sync (recreate)."""
    if ev.type != MODIFIED:
        return True  # creates AND deletes both matter
    if ev.old is None:
        return True

    def cond_key(conditions):
        return [(c.type, c.status, c.reason) for c in conditions]

    return (
        ev.old.status.phase != ev.obj.status.phase
        or cond_key(ev.old.status.conditions)
        != cond_key(ev.obj.status.conditions)
        or ev.old.spec != ev.obj.spec
    )


def _map_to_part_of(ev):
    """Child event → owning PodCliqueSet (via app.kubernetes.io/part-of)."""
    owner = ev.obj.metadata.labels.get(namegen.LABEL_PART_OF)
    return [(ev.obj.metadata.namespace, owner)] if owner else []


def _map_pod_to_pclq(ev):
    pclq = ev.obj.metadata.labels.get(namegen.LABEL_PODCLIQUE)
    return [(ev.obj.metadata.namespace, pclq)] if pclq else []


def _map_podgang_to_pclqs(ev):
    """podclique/register.go:242-278: PodGang events map back to the PCLQs
    named by its PodGroups (drives the ungating handshake)."""
    ns = ev.obj.metadata.namespace
    return [(ns, group.name) for group in ev.obj.spec.pod_groups]


def _map_pclq_to_pcsg(ev):
    pcsg = ev.obj.metadata.labels.get(namegen.LABEL_PCSG)
    return [(ev.obj.metadata.namespace, pcsg)] if pcsg else []


def _map_pcsg_to_pclqs(ctx: OperatorContext):
    """PCSG event → its constituent PodCliques
    (podclique/register.go:207-222 mapPodCliqueScalingGroupToPCLQs)."""

    def map_fn(ev):
        ns = ev.obj.metadata.namespace
        return [
            (ns, o.metadata.name)
            for o in ctx.store.scan(
                "PodClique", ns, {namegen.LABEL_PCSG: ev.obj.metadata.name}
            )
        ]

    return map_fn


def _map_pcs_to_children_of_kind(ctx: OperatorContext, kind: str):
    def map_fn(ev):
        sel = namegen.default_labels(ev.obj.metadata.name)
        return [
            (o.metadata.namespace, o.metadata.name)
            for o in ctx.store.scan(kind, ev.obj.metadata.namespace, sel)
        ]

    return map_fn


def register_controllers(engine: Engine, ctx: OperatorContext, config=None) -> None:
    pcs = PodCliqueSetReconciler(ctx)
    pclq = PodCliqueReconciler(ctx)
    pcsg = PodCliqueScalingGroupReconciler(ctx)
    syncs = (
        (
            config.controllers.pod_clique_set.concurrent_syncs,
            config.controllers.pod_clique.concurrent_syncs,
            config.controllers.pod_clique_scaling_group.concurrent_syncs,
        )
        if config is not None
        else (1, 1, 1)
    )

    engine.register(
        Controller(
            name="podcliqueset",
            kind="PodCliqueSet",
            reconcile=pcs.reconcile,
            concurrent_syncs=syncs[0],
            primary_predicate=generation_changed,
            watches=[
                ("PodClique", _map_to_part_of, pclq_changed_for_owner),
                (
                    "PodCliqueScalingGroup",
                    _map_to_part_of,
                    pcsg_changed_for_owner,
                ),
                # NOT in the reference's PCS watch set (it watches only
                # PCLQ + PCSG — register.go:53-60; pod churn reaches the
                # owner as coalesced PCLQ status transitions). Kept here
                # because the repo's podgang component defers scaled-gang
                # creation on the base gang's phase and mirrors gang
                # phases + conditions into PCS status — gated to
                # phase/spec/condition transitions, a handful of events
                # per gang lifetime.
                ("PodGang", _map_to_part_of, podgang_phase_or_spec_changed),
            ],
        )
    )
    engine.register(
        Controller(
            name="podclique",
            kind="PodClique",
            reconcile=pclq.reconcile,
            batch_hook=pclq.begin_batch,
            concurrent_syncs=syncs[1],
            primary_predicate=generation_changed,
            watches=[
                ("Pod", _map_pod_to_pclq, pod_status_transition),
                ("PodGang", _map_podgang_to_pclqs, podgang_phase_or_spec_changed),
                (
                    "PodCliqueSet",
                    _map_pcs_to_children_of_kind(ctx, "PodClique"),
                    pcs_hash_changed,
                ),
                (
                    "PodCliqueScalingGroup",
                    _map_pcsg_to_pclqs(ctx),
                    pcsg_rolling_progress_changed,
                ),
            ],
        )
    )
    engine.register(
        Controller(
            name="podcliquescalinggroup",
            kind="PodCliqueScalingGroup",
            reconcile=pcsg.reconcile,
            concurrent_syncs=syncs[2],
            primary_predicate=generation_changed,
            watches=[
                ("PodClique", _map_pclq_to_pcsg, pclq_changed_for_owner),
                (
                    "PodCliqueSet",
                    _map_pcs_to_children_of_kind(ctx, "PodCliqueScalingGroup"),
                    pcs_rolling_pointer_changed,
                ),
            ],
        )
    )
