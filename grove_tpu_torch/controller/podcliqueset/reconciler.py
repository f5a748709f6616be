"""PodCliqueSet reconciler: get → delete-flow → spec-flow → status-flow.

Counterpart of ``grove_tpu/controller/podcliqueset/reconciler.py``.

Re-host of reference operator/internal/controller/podcliqueset/
{reconciler.go,reconcilespec.go,reconcilestatus.go}: ensureFinalizer →
processGenerationHashChange → sync ordered components (SA, Role, RoleBinding,
SATokenSecret, HeadlessService, HPA, PCSReplica, PodClique, PCSG, PodGang —
reconcilespec.go:202-215) → updateObservedGeneration; status aggregates
replica availability and PodGang phases.
"""

from __future__ import annotations

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.hashing import compute_pcs_generation_hash
from grove_tpu_torch.api.meta import get_condition
from grove_tpu_torch.api.types import (
    COND_MIN_AVAILABLE_BREACHED,
    COND_POD_CLIQUE_SCHEDULED,
    PCSRollingUpdateProgress,
    PodCliqueSet,
    PodGangStatusSummary,
)
from grove_tpu_torch.controller.common import (
    FINALIZER,
    OperatorContext,
    record_last_error,
    write_status_if_changed,
)
from grove_tpu_torch.controller.podcliqueset.components import (
    infra,
    podclique,
    podgang,
    replica as replica_component,
    rollingupdate,
    scalinggroup,
)
from grove_tpu_torch.runtime.errors import GroveError
from grove_tpu_torch.runtime.flow import (
    ReconcileStepResult,
    continue_reconcile,
    do_not_requeue,
    reconcile_after,
    reconcile_with_errors,
)
from grove_tpu_torch.runtime.workqueue import Key

CHILD_KINDS_CASCADE = [
    "PodGang",
    "PodClique",
    "PodCliqueScalingGroup",
    "Service",
    "HorizontalPodAutoscaler",
    "ServiceAccount",
    "Role",
    "RoleBinding",
    "Secret",
]


class ChildSnapshot:
    """ONE informer-view fetch of a set's children per reconcile.

    Under cache lag the cached view is FROZEN for the whole drain round
    (events apply to it only at round start), so every component and the
    status flow can be served from this single snapshot instead of
    re-scanning per component — the "one component build" of the batched
    drain. Built only for cache-lag stores; live-read stores keep their
    per-component scans (committed state can move mid-reconcile there).
    All held objects are zero-copy readonly views."""

    __slots__ = ("_ctx", "_ns", "_pcs_name", "pclqs", "pcsgs", "_gangs", "_pods")

    def __init__(self, ctx: OperatorContext, ns: str, pcs_name: str) -> None:
        self._ctx = ctx
        self._ns = ns
        self._pcs_name = pcs_name
        sel = namegen.default_labels(pcs_name)
        self.pclqs = list(ctx.store.scan("PodClique", ns, sel, cached=True))
        self.pcsgs = list(
            ctx.store.scan("PodCliqueScalingGroup", ns, sel, cached=True)
        )
        self._gangs = None
        self._pods = None

    def gangs(self):
        """The set's PodGangs (component-labeled), lazily fetched."""
        if self._gangs is None:
            self._gangs = list(
                self._ctx.store.scan(
                    "PodGang",
                    self._ns,
                    {
                        **namegen.default_labels(self._pcs_name),
                        namegen.LABEL_COMPONENT: namegen.COMPONENT_PODGANG,
                    },
                    cached=True,
                )
            )
        return self._gangs

    def pods_by_pclq(self):
        """The set's pods grouped by their PodClique label — one scan
        instead of one per constituent PCLQ."""
        if self._pods is None:
            grouped: dict = {}
            for pod in self._ctx.store.scan(
                "Pod",
                self._ns,
                namegen.default_labels(self._pcs_name),
                cached=True,
            ):
                pclq = pod.metadata.labels.get(namegen.LABEL_PODCLIQUE)
                if pclq is not None:
                    grouped.setdefault(pclq, []).append(pod)
            self._pods = grouped
        return self._pods

    def pclqs_for_replica(self, replica: int, component: str = None):
        idx = str(replica)
        return [
            p
            for p in self.pclqs
            if p.metadata.labels.get(namegen.LABEL_PCS_REPLICA_INDEX) == idx
            and (
                component is None
                or p.metadata.labels.get(namegen.LABEL_COMPONENT) == component
            )
        ]

    def pcsgs_for_replica(self, replica: int):
        idx = str(replica)
        return [
            g
            for g in self.pcsgs
            if g.metadata.labels.get(namegen.LABEL_PCS_REPLICA_INDEX) == idx
        ]


class PodCliqueSetReconciler:
    def __init__(self, ctx: OperatorContext) -> None:
        self.ctx = ctx

    def reconcile(self, key: Key) -> ReconcileStepResult:
        _, ns, name = key
        # readonly view: the spec flow READS the PCS (components take it as
        # input); the rare writes (finalizer add, hash change, observed
        # generation) each re-get a mutable copy
        pcs = self.ctx.store.get("PodCliqueSet", ns, name, readonly=True)
        if pcs is None:
            return do_not_requeue()
        if pcs.metadata.deletion_timestamp is not None:
            return self._reconcile_delete(pcs)
        snap = (
            ChildSnapshot(self.ctx, ns, name)
            if self.ctx.store.cache_lag
            else None
        )
        try:
            result = self._reconcile_spec(pcs, snap)
            self._reconcile_status(ns, name, snap)
        except GroveError as err:
            record_last_error(self.ctx, "PodCliqueSet", ns, name, err)
            return reconcile_with_errors(f"pcs {ns}/{name}", err)
        return result

    # -- delete flow -----------------------------------------------------

    def _reconcile_delete(self, pcs: PodCliqueSet) -> ReconcileStepResult:
        ns = pcs.metadata.namespace
        selector = namegen.default_labels(pcs.metadata.name)
        remaining = 0
        for kind in CHILD_KINDS_CASCADE:
            victims = self.ctx.store.list(kind, ns, selector)
            for v in victims:
                if v.metadata.deletion_timestamp is None:
                    self.ctx.store.delete(kind, ns, v.metadata.name)
            remaining += len(self.ctx.store.list(kind, ns, selector))
        if remaining:
            # children drain asynchronously (their finalizers); check back
            return reconcile_after(0.001, "waiting for child deletion")
        self.ctx.store.remove_finalizer(
            "PodCliqueSet", ns, pcs.metadata.name, FINALIZER
        )
        return do_not_requeue()

    # -- spec flow -------------------------------------------------------

    def _reconcile_spec(
        self, pcs: PodCliqueSet, snap: ChildSnapshot = None
    ) -> ReconcileStepResult:
        ns, name = pcs.metadata.namespace, pcs.metadata.name
        if FINALIZER not in pcs.metadata.finalizers:
            from grove_tpu_torch.runtime.store import commit_finalizer_add

            pcs = commit_finalizer_add(self.ctx.store, pcs, FINALIZER)
            if pcs is None:  # deleted between view and write
                return continue_reconcile()

        pcs = self._process_generation_hash(pcs)

        infra.sync_rbac(self.ctx, pcs)
        infra.sync_headless_services(self.ctx, pcs)
        infra.sync_hpas(self.ctx, pcs)
        breach_wait = replica_component.sync(self.ctx, pcs, snap)
        update_wait = rollingupdate.sync(self.ctx, pcs)
        podclique.sync(self.ctx, pcs)
        scalinggroup.sync(self.ctx, pcs)
        podgang.sync(self.ctx, pcs, snap)

        view = self.ctx.store.get("PodCliqueSet", ns, name, readonly=True)
        if (
            view is not None
            and view.metadata.deletion_timestamp is None
            and view.status.observed_generation != view.metadata.generation
        ):
            fresh = self.ctx.store.get("PodCliqueSet", ns, name)
            if fresh is not None and fresh.metadata.deletion_timestamp is None:
                fresh.status.observed_generation = fresh.metadata.generation
                self.ctx.store.update_status(fresh)

        waits = [w for w in (breach_wait, update_wait) if w is not None]
        if waits:
            return reconcile_after(min(waits), "breach/rolling-update wait")
        return continue_reconcile()

    def _process_generation_hash(self, pcs: PodCliqueSet) -> PodCliqueSet:
        """reconcilespec.go:72-123: template hash change starts a rolling
        update (progress tracked in status). `pcs` may be a readonly view —
        the steady state (hash unchanged) never touches the store; a change
        re-gets a mutable copy for the write."""
        new_hash = compute_pcs_generation_hash(pcs)
        if pcs.status.current_generation_hash == new_hash:
            return pcs
        fresh = self.ctx.store.get(
            "PodCliqueSet", pcs.metadata.namespace, pcs.metadata.name
        )
        if fresh is None or fresh.metadata.deletion_timestamp is not None:
            return pcs
        if fresh.status.current_generation_hash is None:
            fresh.status.current_generation_hash = new_hash
            return self.ctx.store.update_status(fresh)
        if fresh.status.current_generation_hash != new_hash:
            fresh.status.current_generation_hash = new_hash
            fresh.status.rolling_update_progress = PCSRollingUpdateProgress(
                update_started_at=self.ctx.clock.now()
            )
            self.ctx.record_event(
                "PodCliqueSet",
                "RollingUpdateStarted",
                fresh.metadata.name,
                namespace=fresh.metadata.namespace,
                name=fresh.metadata.name,
            )
            return self.ctx.store.update_status(fresh)
        return fresh

    # -- status flow -----------------------------------------------------

    def _reconcile_status(
        self, ns: str, name: str, snap: ChildSnapshot = None
    ) -> None:
        # compute on the zero-copy view; write only on difference (the
        # steady state then costs no serialization at all)
        view = self.ctx.store.get("PodCliqueSet", ns, name, readonly=True)
        if view is None or view.metadata.deletion_timestamp is not None:
            return
        gangs = (
            snap.gangs()
            if snap is not None
            else self.ctx.store.scan(
                "PodGang",
                ns,
                {
                    **namegen.default_labels(name),
                    namegen.LABEL_COMPONENT: namegen.COMPONENT_PODGANG,
                },
                cached=True,
            )
        )
        import copy as _copy

        # shallow status clone: every bulky field is REBUILT fresh below
        # (pod_gang_statuses, last_errors) or left untouched-and-shared
        # (conditions, rolling_update_progress — written only by flows that
        # work on their own mutable PCS copies), so a deep copy of the old
        # status would only pickle data about to be thrown away
        st = _copy.copy(view.status)
        st.replicas = view.spec.replicas
        st.pod_gang_statuses = [
            PodGangStatusSummary(
                name=g.metadata.name,
                phase=g.status.phase,
                conditions=list(g.status.conditions),
            )
            for g in gangs
        ]
        st.available_replicas = self._count_available_replicas(view, snap)
        st.updated_replicas = self._count_updated_replicas(view, snap)
        st.selector = f"{namegen.LABEL_PART_OF}={name}"
        st.last_errors = []  # cleared on a clean reconcile
        write_status_if_changed(self.ctx, "PodCliqueSet", ns, name, st)

    def _count_updated_replicas(
        self, pcs: PodCliqueSet, snap: ChildSnapshot = None
    ) -> int:
        """Replicas whose every PCLQ carries the current template hash with
        all pods updated (podcliqueset.go:68-70 UpdatedReplicas)."""
        from grove_tpu_torch.api.hashing import pod_template_hash_for
        from grove_tpu_torch.controller.podcliqueset.components.rollingupdate import (
            _clique_template_name,
        )

        ns = pcs.metadata.namespace
        tmpl = pcs.spec.template
        # hash depends only on the template — compute once per clique
        want_hash = {
            clique.name: pod_template_hash_for(pcs, clique.name)
            for clique in tmpl.cliques
        }
        count = 0
        for replica in range(pcs.spec.replicas):
            if snap is not None:
                pclqs = snap.pclqs_for_replica(replica)
            else:
                sel = {
                    **namegen.default_labels(pcs.metadata.name),
                    namegen.LABEL_PCS_REPLICA_INDEX: str(replica),
                }
                pclqs = list(
                    self.ctx.store.scan("PodClique", ns, sel, cached=True)
                )
            if not pclqs:
                continue
            updated = True
            for pclq in pclqs:
                want = want_hash.get(_clique_template_name(pcs, pclq))
                if want is None:
                    continue
                if (
                    pclq.metadata.labels.get(namegen.LABEL_POD_TEMPLATE_HASH)
                    != want
                    or pclq.status.updated_replicas < pclq.spec.replicas
                ):
                    updated = False
                    break
            if updated:
                count += 1
        return count

    def _count_available_replicas(
        self, pcs: PodCliqueSet, snap: ChildSnapshot = None
    ) -> int:
        """A PCS replica is available when every standalone PCLQ is actually
        scheduled up to minAvailable (PodCliqueScheduled=True), every PCSG has
        scheduledReplicas >= minAvailable, and none of them currently breach
        MinAvailable (podcliqueset/reconcilestatus.go availability rule —
        never count a never-scheduled replica as available)."""
        ns = pcs.metadata.namespace
        count = 0
        for replica in range(pcs.spec.replicas):
            if snap is not None:
                pclqs = snap.pclqs_for_replica(
                    replica, namegen.COMPONENT_PCS_PODCLIQUE
                )
                pcsgs = snap.pcsgs_for_replica(replica)
            else:
                sel = {
                    **namegen.default_labels(pcs.metadata.name),
                    namegen.LABEL_PCS_REPLICA_INDEX: str(replica),
                }
                pclqs = [
                    p
                    for p in self.ctx.store.scan(
                        "PodClique", ns, sel, cached=True
                    )
                    if p.metadata.labels.get(namegen.LABEL_COMPONENT)
                    == namegen.COMPONENT_PCS_PODCLIQUE
                ]
                pcsgs = list(self.ctx.store.scan(
                    "PodCliqueScalingGroup", ns, sel, cached=True
                ))
            entities = pclqs + pcsgs
            if not entities:
                continue
            scheduled = all(
                (c := get_condition(p.status.conditions, COND_POD_CLIQUE_SCHEDULED))
                is not None
                and c.is_true()
                for p in pclqs
            ) and all(
                g.status.scheduled_replicas >= g.spec.min_available for g in pcsgs
            )
            breached = any(
                (c := get_condition(e.status.conditions, COND_MIN_AVAILABLE_BREACHED))
                is not None
                and c.is_true()
                for e in entities
            )
            if scheduled and not breached:
                count += 1
        return count
