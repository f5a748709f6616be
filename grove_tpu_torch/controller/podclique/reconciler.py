"""PodClique reconciler: get → delete-flow → spec-flow (pods) → status-flow.

Counterpart of ``grove_tpu/controller/podclique/reconciler.py``.

Re-host of reference operator/internal/controller/podclique/reconciler.go
with the pod component as its single ordered component
(podclique/reconcilespec.go:213-217).
"""

from __future__ import annotations

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.controller.common import (
    FINALIZER,
    OperatorContext,
    record_last_error,
    write_status_if_changed,
)
from grove_tpu_torch.controller.podclique import pods as pod_component
from grove_tpu_torch.controller.podclique.status import compute_status
from grove_tpu_torch.runtime.errors import GroveError
from grove_tpu_torch.runtime.flow import (
    ReconcileStepResult,
    continue_reconcile,
    do_not_requeue,
    reconcile_after,
    reconcile_with_errors,
)
from grove_tpu_torch.runtime.workqueue import Key

GATE_RETRY_SECONDS = 2.0


class PodCliqueReconciler:
    def __init__(self, ctx: OperatorContext) -> None:
        self.ctx = ctx
        self._base_sched_memo = None

    def begin_batch(self, keys) -> None:
        """Engine batch hook (deterministic drain only): scaled PCLQs of a
        set share one base gang, and under cache lag the cached view is
        FROZEN for the whole round — so the base-gang-scheduled check is
        computed once per (ns, base gang) per batch instead of per PCLQ.
        Without cache lag reads are live and the memo stays off."""
        self._base_sched_memo = {} if self.ctx.store.cache_lag else None

    def reconcile(self, key: Key) -> ReconcileStepResult:
        _, ns, name = key
        # readonly view: sync_pods only reads the PCLQ; the one-time
        # finalizer write re-gets a mutable copy
        pclq = self.ctx.store.get("PodClique", ns, name, readonly=True)
        if pclq is None:
            return do_not_requeue()
        if pclq.metadata.deletion_timestamp is not None:
            return self._reconcile_delete(pclq)
        try:
            if FINALIZER not in pclq.metadata.finalizers:
                from grove_tpu_torch.runtime.store import commit_finalizer_add

                pclq = commit_finalizer_add(self.ctx.store, pclq, FINALIZER)
                if pclq is None:  # deleted between view and write
                    return do_not_requeue()
            # ONE pod scan shared by the sync flow and the gate pass (both
            # always decided against the pre-sync view — the diff math uses
            # expectations for in-flight creates). The STATUS compute below
            # keeps its own scan: it must reflect this reconcile's own
            # mutations where the store view can show them (cluster mode),
            # and the predicate rationale for filtering pod-ADDED events
            # relies on the creating reconcile re-counting.
            pods = list(
                self.ctx.store.scan(
                    "Pod", ns, {namegen.LABEL_PODCLIQUE: name}, cached=True
                )
            )
            skipped_gated = pod_component.sync_pods(
                self.ctx, pclq, pods, self._base_sched_memo
            )
            view = self.ctx.store.get("PodClique", ns, name, readonly=True)
            if view is not None and view.metadata.deletion_timestamp is None:
                # compute on the zero-copy view; write only on difference
                # (steady-state reconciles then cost no serialization)
                proposed = compute_status(self.ctx, view)
                proposed.observed_generation = view.metadata.generation
                proposed.last_errors = []  # cleared on a clean reconcile
                write_status_if_changed(
                    self.ctx, "PodClique", ns, name, proposed
                )
        except GroveError as err:
            record_last_error(self.ctx, "PodClique", ns, name, err)
            return reconcile_with_errors(f"podclique {ns}/{name}", err)
        if skipped_gated:
            # pods still gated (not in PodGang yet / base gang unscheduled):
            # retry gate removal (reference pod.go:125-130 ErrCodeRequeueAfter)
            return reconcile_after(GATE_RETRY_SECONDS, "pods still schedule-gated")
        return continue_reconcile()

    def _reconcile_delete(self, pclq) -> ReconcileStepResult:
        ns = pclq.metadata.namespace
        try:
            self.ctx.store.delete_collection(
                "Pod", ns, {namegen.LABEL_PODCLIQUE: pclq.metadata.name}
            )
            self.ctx.pod_expectations.delete_expectations(f"{ns}/{pclq.metadata.name}")
            self.ctx.store.remove_finalizer("PodClique", ns, pclq.metadata.name, FINALIZER)
        except GroveError as err:
            return reconcile_with_errors(f"delete podclique {pclq.metadata.name}", err)
        return do_not_requeue()
