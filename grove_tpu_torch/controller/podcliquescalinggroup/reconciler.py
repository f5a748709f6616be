"""PodCliqueScalingGroup reconciler.

Counterpart of ``grove_tpu/controller/podcliquescalinggroup/reconciler.py``.

Re-host of reference operator/internal/controller/podcliquescalinggroup/
(reconcilespec.go, components/podclique/{podclique,sync}.go, reconcilestatus.go):
- materializes one PodClique per (PCSG replica × member clique) with the gang
  labels that encode the base/scaled split (podclique.go:423-449)
- scale-in removes the highest replica indices (sync.go:130-172)
- a *scaled* replica whose MinAvailableBreached persisted past TerminationDelay
  is torn down and recreated (sync.go:206-251); base-replica breaches are
  handled one level up by the PCS replica component (gang termination)
- status aggregates Scheduled/Available/Updated per PCSG replica
  (reconcilestatus.go:40-207)
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.hashing import pod_template_hash_for
from grove_tpu_torch.api.meta import Condition, ObjectMeta, get_condition, set_condition
from grove_tpu_torch.api.types import (
    COND_MIN_AVAILABLE_BREACHED,
    COND_POD_CLIQUE_SCHEDULED,
    PodClique,
    PodCliqueScalingGroup,
    PodCliqueSet,
)
from grove_tpu_torch.controller.common import (
    FINALIZER,
    OperatorContext,
    create_or_adopt,
    record_last_error,
    resolve_starts_after,
    shared_template_spec,
    write_status_if_changed,
)
from grove_tpu_torch.controller.podclique.pods import STARTUP_DEPS_ANNOTATION
from grove_tpu_torch.runtime.errors import GroveError
from grove_tpu_torch.runtime.flow import (
    ReconcileStepResult,
    continue_reconcile,
    do_not_requeue,
    reconcile_after,
    reconcile_with_errors,
)
from grove_tpu_torch.runtime.workqueue import Key


class PodCliqueScalingGroupReconciler:
    def __init__(self, ctx: OperatorContext) -> None:
        self.ctx = ctx

    # -- entry -----------------------------------------------------------

    def reconcile(self, key: Key) -> ReconcileStepResult:
        _, ns, name = key
        # readonly view: the flows read the PCSG; the one-time finalizer
        # write re-gets a mutable copy
        pcsg = self.ctx.store.get(
            "PodCliqueScalingGroup", ns, name, readonly=True
        )
        if pcsg is None:
            return do_not_requeue()
        if pcsg.metadata.deletion_timestamp is not None:
            return self._reconcile_delete(pcsg)
        pcs = self._owner_pcs(pcsg)
        if pcs is None:
            return do_not_requeue()
        try:
            if FINALIZER not in pcsg.metadata.finalizers:
                from grove_tpu_torch.runtime.store import commit_finalizer_add

                pcsg = commit_finalizer_add(self.ctx.store, pcsg, FINALIZER)
                if pcsg is None:  # deleted between view and write
                    return do_not_requeue()
            update_requeue = self._process_rolling_update(pcsg, pcs)
            requeue_in = self._sync_podcliques(pcsg, pcs)
            self._reconcile_status(pcsg, pcs)
        except GroveError as err:
            record_last_error(self.ctx, "PodCliqueScalingGroup", ns, name, err)
            return reconcile_with_errors(f"pcsg {ns}/{name}", err)
        waits = [w for w in (update_requeue, requeue_in) if w is not None]
        if waits:
            return reconcile_after(min(waits), "pcsg update/breach wait")
        return continue_reconcile()

    def _owner_pcs(self, pcsg) -> Optional[PodCliqueSet]:
        pcs_name = pcsg.metadata.labels.get(namegen.LABEL_PART_OF, "")
        # readonly: PCSG flows only read the owner PCS (template, configs);
        # writes always target PCSG/PodClique objects fetched mutably
        return self.ctx.store.get(
            "PodCliqueSet", pcsg.metadata.namespace, pcs_name, readonly=True
        )

    def _reconcile_delete(self, pcsg) -> ReconcileStepResult:
        ns = pcsg.metadata.namespace
        self.ctx.store.delete_collection(
            "PodClique", ns, {namegen.LABEL_PCSG: pcsg.metadata.name}
        )
        self.ctx.store.remove_finalizer(
            "PodCliqueScalingGroup", ns, pcsg.metadata.name, FINALIZER
        )
        return do_not_requeue()

    # -- spec flow -------------------------------------------------------

    def _sync_podcliques(
        self, pcsg: PodCliqueScalingGroup, pcs: PodCliqueSet
    ) -> Optional[float]:
        ns = pcsg.metadata.namespace
        pcs_replica = int(
            pcsg.metadata.labels.get(namegen.LABEL_PCS_REPLICA_INDEX, "0")
        )
        sg_name = namegen.extract_sg_name_from_pcsg_fqn(
            pcsg.metadata.name, pcs.metadata.name, pcs_replica
        )

        existing_names = {
            p.metadata.name
            for p in self.ctx.store.scan(
                "PodClique",
                ns,
                {namegen.LABEL_PCSG: pcsg.metadata.name},
                cached=True,
            )
        }

        def build() -> Dict[str, PodClique]:
            out: Dict[str, PodClique] = {}
            for replica in range(pcsg.spec.replicas):
                for clique_name in pcsg.spec.clique_names:
                    pclq = self._build_pclq(
                        pcs, pcs_replica, pcsg, sg_name, replica, clique_name
                    )
                    if pclq is not None:
                        out[pclq.metadata.name] = pclq
            return out

        # pure function of the PCSG spec (its generation covers HPA scale
        # writes) and the owning PCS template (its generation covers
        # template pushes) — see ctx.desired_cache
        expected = self.ctx.desired_cache(
            (
                "pcsg-pclq",
                pcsg.metadata.uid,
                pcsg.metadata.generation,
                pcs.metadata.uid,
                pcs.metadata.generation,
            ),
            build,
        )

        # create missing; adopt label/annotation drift on existing
        for pclq in expected.values():
            create_or_adopt(self.ctx, pclq)

        # scale-in: delete excess (highest replica indices first — sync.go:130-172)
        for name in sorted(existing_names - expected.keys(), reverse=True):
            self.ctx.store.delete("PodClique", ns, name)

        return self._terminate_breached_scaled_replicas(pcsg, pcs, pcs_replica)

    def _build_pclq(
        self,
        pcs: PodCliqueSet,
        pcs_replica: int,
        pcsg: PodCliqueScalingGroup,
        sg_name: str,
        replica: int,
        clique_name: str,
    ) -> Optional[PodClique]:
        tmpl = pcs.spec.template.clique_template(clique_name)
        if tmpl is None:
            return None
        sg_cfg = None
        for cfg in pcs.spec.template.pod_clique_scaling_group_configs:
            if cfg.name == sg_name:
                sg_cfg = cfg
        min_available = (
            pcsg.spec.min_available
            if pcsg.spec.min_available
            else (sg_cfg.min_available if sg_cfg else 1)
        )

        fqn = namegen.podclique_name(pcsg.metadata.name, replica, clique_name)
        gang = namegen.podgang_name_for_pcsg_replica(
            pcs.metadata.name, pcs_replica, pcsg.metadata.name, replica, min_available
        )
        labels = dict(namegen.default_labels(pcs.metadata.name))
        labels.update(tmpl.labels)
        labels[namegen.LABEL_COMPONENT] = namegen.COMPONENT_PCSG_PODCLIQUE
        labels[namegen.LABEL_PCS_REPLICA_INDEX] = str(pcs_replica)
        labels[namegen.LABEL_PCSG] = pcsg.metadata.name
        labels[namegen.LABEL_PCSG_REPLICA_INDEX] = str(replica)
        labels[namegen.LABEL_PODGANG] = gang
        labels[namegen.LABEL_POD_TEMPLATE_HASH] = pod_template_hash_for(
            pcs, clique_name
        )
        # tenant queue label flows PCS -> PCLQ -> pods (quota accounting)
        queue = pcs.metadata.labels.get(namegen.LABEL_QUEUE)
        if queue:
            labels[namegen.LABEL_QUEUE] = queue
        if replica >= min_available:
            # scaled replica: points back at its base gang (podclique.go:423-449)
            labels[namegen.LABEL_BASE_PODGANG] = namegen.base_podgang_name(
                pcs.metadata.name, pcs_replica
            )

        annotations = dict(tmpl.annotations)
        deps = resolve_starts_after(
            pcs,
            pcs_replica,
            clique_name,
            owner_pcsg_fqn=pcsg.metadata.name,
            owner_pcsg_replica=replica,
        )
        if deps:
            annotations[STARTUP_DEPS_ANNOTATION] = json.dumps(deps)

        return PodClique(
            metadata=ObjectMeta(
                name=fqn,
                namespace=pcs.metadata.namespace,
                labels=labels,
                annotations=annotations,
            ),
            spec=shared_template_spec(tmpl.spec),
        )

    # -- rolling update (components/podclique/rollingupdate.go:55-260) ----

    def _desired_hash(self, pcs: PodCliqueSet, clique_name: str) -> Optional[str]:
        return pod_template_hash_for(pcs, clique_name)

    def _replica_pclqs(
        self, pcsg, replica: int, readonly: bool = False
    ) -> List[PodClique]:
        ns = pcsg.metadata.namespace
        out = []
        for clique_name in pcsg.spec.clique_names:
            fqn = namegen.podclique_name(pcsg.metadata.name, replica, clique_name)
            pclq = self.ctx.store.get("PodClique", ns, fqn, readonly=readonly)
            if pclq is not None:
                out.append((clique_name, pclq))
        return out

    def _replica_outdated(self, pcsg, pcs, replica: int) -> bool:
        """PCLQ label hash and the PODS' OWN hash labels both checked — the
        PCLQ's status.updatedReplicas is recomputed asynchronously, so right
        after a hash push it still reports the old-hash pod count and the
        replica would momentarily read as done (letting a second replica get
        torn down in the same pass)."""
        from grove_tpu_torch.api.pod import is_terminating

        pairs = self._replica_pclqs(pcsg, replica, readonly=True)
        if len(pairs) < len(pcsg.spec.clique_names):
            return False  # not materialized yet; the sync builds it fresh
        ns = pcsg.metadata.namespace
        for clique_name, pclq in pairs:
            want = self._desired_hash(pcs, clique_name)
            if want is None:
                continue
            if pclq.metadata.labels.get(namegen.LABEL_POD_TEMPLATE_HASH) != want:
                return True
            fresh = [
                p
                for p in self.ctx.store.scan(
                    "Pod", ns, {namegen.LABEL_PODCLIQUE: pclq.metadata.name}
                )
                if not is_terminating(p)
                and p.metadata.labels.get(namegen.LABEL_POD_TEMPLATE_HASH)
                == want
            ]
            if len(fresh) < pclq.spec.replicas:
                return True
        return False

    def _replica_available(self, pcsg, replica: int) -> bool:
        """Every pod of the replica exists and is Ready — a replica the
        updater must take down CAREFULLY (one at a time); anything else is
        force-updated first. Checked against PODS directly: the PCLQ
        conditions lag pod reality and MinAvailableBreached reads Unknown
        while the update-in-progress marker is set, which would let the
        updater tear down the next replica while the previous one is still
        coming back."""
        from grove_tpu_torch.api.pod import is_ready, is_terminating

        pairs = self._replica_pclqs(pcsg, replica, readonly=True)
        if len(pairs) < len(pcsg.spec.clique_names):
            return False
        ns = pcsg.metadata.namespace
        for _, pclq in pairs:
            pods = [
                p
                for p in self.ctx.store.scan(
                    "Pod", ns, {namegen.LABEL_PODCLIQUE: pclq.metadata.name}
                )
                if not is_terminating(p)
            ]
            if len(pods) < pclq.spec.replicas:
                return False
            if not all(is_ready(p) for p in pods):
                return False
        return True

    def _push_template_to_replica(self, pcsg, pcs, replica: int) -> None:
        from grove_tpu_torch.controller.common import apply_template_to_pclq

        for clique_name, pclq in self._replica_pclqs(pcsg, replica):
            apply_template_to_pclq(self.ctx, pcs, pclq, clique_name)

    def _process_rolling_update(
        self, pcsg: PodCliqueScalingGroup, pcs: PodCliqueSet
    ) -> Optional[float]:
        """Replica-by-replica PCSG rolling update, tracked in THIS
        controller's status (reference granularity,
        podcliquescalinggroup/components/podclique/rollingupdate.go:55-260):
        force-update pending/unavailable replicas immediately, then ONE
        ready replica at a time recorded in
        ReadyReplicaIndicesSelectedToUpdate — the rest of the scaling group
        keeps serving while one replica swaps. The PCS-level updater only
        gates WHICH PCS replica updates; it no longer touches PCSG-owned
        cliques."""
        from grove_tpu_torch.api.types import PCSGRollingUpdateProgress

        # `pcsg` may be the readonly reconcile view: the steady state (no
        # outdated replicas, no open progress) reads only; every mutating
        # branch below re-gets a private copy first
        ns = pcsg.metadata.namespace
        progress = pcsg.status.rolling_update_progress
        outdated = [
            r
            for r in range(pcsg.spec.replicas)
            if self._replica_outdated(pcsg, pcs, r)
        ]
        if not outdated:
            if progress is not None and progress.update_ended_at is None:
                fresh = self.ctx.store.get(
                    "PodCliqueScalingGroup", ns, pcsg.metadata.name
                )
                prog = (
                    fresh.status.rolling_update_progress
                    if fresh is not None
                    else None
                )
                if prog is None or prog.update_ended_at is not None:
                    return None
                prog.update_ended_at = self.ctx.clock.now()
                prog.ready_replica_indices_selected_to_update = []
                prog.updated_replica_indices = sorted(
                    set(prog.updated_replica_indices)
                    | set(range(fresh.spec.replicas))
                )
                self.ctx.store.update_status(fresh)
                self.ctx.record_event(
                    "PodCliqueScalingGroup",
                    "RollingUpdateCompleted",
                    fresh.metadata.name,
                    namespace=fresh.metadata.namespace,
                    name=fresh.metadata.name,
                )
            return None
        # active update: switch to a private mutable copy for the rest of
        # the flow (it tracks selection/progress in this CR's status)
        fresh = self.ctx.store.get(
            "PodCliqueScalingGroup", ns, pcsg.metadata.name
        )
        if fresh is None or fresh.metadata.deletion_timestamp is not None:
            return None
        pcsg = fresh
        progress = pcsg.status.rolling_update_progress

        # gate on the PCS-level replica selection: PCSGs of a replica the
        # PCS updater has not reached yet stay on the old template
        pcs_prog = pcs.status.rolling_update_progress
        my_pcs_replica = int(
            pcsg.metadata.labels.get(namegen.LABEL_PCS_REPLICA_INDEX, "0")
        )
        selected = (
            pcs_prog is not None
            and pcs_prog.update_ended_at is None
            and pcs_prog.currently_updating is not None
            and pcs_prog.currently_updating.replica_index == my_pcs_replica
        )
        if not selected and (progress is None or progress.update_ended_at is not None):
            return None

        if progress is None or progress.update_ended_at is not None:
            progress = PCSGRollingUpdateProgress(
                update_started_at=self.ctx.clock.now()
            )
            pcsg.status.rolling_update_progress = progress

        # force-update pending/unavailable replicas first (:96-130)
        ready_outdated = []
        for r in outdated:
            if self._replica_available(pcsg, r):
                ready_outdated.append(r)
            else:
                # grovelint: disable=GL002 -- grant held upstream: the PCS rolling updater cleared the broker for this whole replica before selecting it (components/rollingupdate.py _disruption_granted); an unavailable replica is also excluded from the budget tally by design
                self._push_template_to_replica(pcsg, pcs, r)

        # then one READY replica at a time (:132-260); a freshly-updated
        # replica counts as done the moment its pods carry the new hash,
        # so ALSO wait for it to become available again before tearing the
        # next one down — otherwise two replicas are dark simultaneously
        in_flight = [
            r
            for r in progress.ready_replica_indices_selected_to_update
            if r in outdated
        ]
        settling = [
            r
            for r in range(pcsg.spec.replicas)
            if r not in outdated and not self._replica_available(pcsg, r)
        ]
        if in_flight:
            # grovelint: disable=GL002 -- grant held upstream: in-flight replica was broker-cleared by the PCS rolling updater at selection time
            self._push_template_to_replica(pcsg, pcs, in_flight[0])
        elif ready_outdated and not settling:
            pick = ready_outdated[0]
            progress.ready_replica_indices_selected_to_update.append(pick)
            # grovelint: disable=GL002 -- grant held upstream: this PCSG update only starts while the PCS replica is `selected`, which required _disruption_granted in components/rollingupdate.py
            self._push_template_to_replica(pcsg, pcs, pick)
            self.ctx.record_event(
                "PodCliqueScalingGroup",
                "RollingUpdateReplicaStarted",
                f"{pcsg.metadata.name} replica {pick}",
                namespace=pcsg.metadata.namespace,
                name=pcsg.metadata.name,
            )

        # bookkeeping: replicas no longer outdated are done
        done = [
            r for r in range(pcsg.spec.replicas) if r not in outdated
        ]
        merged = sorted(set(progress.updated_replica_indices) | set(done))
        progress.updated_replica_indices = merged
        self.ctx.store.update_status(pcsg)
        return 2.0

    # -- scaled-replica gang termination ---------------------------------

    def _terminate_breached_scaled_replicas(
        self, pcsg: PodCliqueScalingGroup, pcs: PodCliqueSet, pcs_replica: int
    ) -> Optional[float]:
        """sync.go:206-251: a scaled replica breached longer than
        TerminationDelay is deleted (then recreated by the next sync).
        Returns the minimum remaining wait if any replica is breached."""
        delay = pcs.spec.template.termination_delay or 0.0
        now = self.ctx.clock.now()
        min_available = pcsg.spec.min_available
        ns = pcsg.metadata.namespace
        min_wait: Optional[float] = None
        for replica in range(min_available, pcsg.spec.replicas):
            breach_since = self._replica_breach_since(pcsg, replica)
            if breach_since is None:
                continue
            age = now - breach_since
            if age >= delay:
                for clique_name in pcsg.spec.clique_names:
                    fqn = namegen.podclique_name(
                        pcsg.metadata.name, replica, clique_name
                    )
                    if self.ctx.store.get("PodClique", ns, fqn) is not None:
                        self.ctx.store.delete("PodClique", ns, fqn)
                self.ctx.record_event(
                    "PodCliqueScalingGroup",
                    "ScaledReplicaGangTerminated",
                    f"{pcsg.metadata.name} replica {replica}",
                    namespace=pcsg.metadata.namespace,
                    name=pcsg.metadata.name,
                )
            else:
                remaining = delay - age
                min_wait = remaining if min_wait is None else min(min_wait, remaining)
        return min_wait

    def _replica_breach_since(
        self, pcsg: PodCliqueScalingGroup, replica: int
    ) -> Optional[float]:
        """Earliest still-True MinAvailableBreached transition among the
        replica's constituent PCLQs (None if none breached)."""
        ns = pcsg.metadata.namespace
        since: Optional[float] = None
        for clique_name in pcsg.spec.clique_names:
            fqn = namegen.podclique_name(pcsg.metadata.name, replica, clique_name)
            pclq = self.ctx.store.get("PodClique", ns, fqn, cached=True)
            if pclq is None:
                continue
            cond = get_condition(pclq.status.conditions, COND_MIN_AVAILABLE_BREACHED)
            if cond is not None and cond.is_true():
                t = cond.last_transition_time
                since = t if since is None else min(since, t)
        return since

    # -- status flow -----------------------------------------------------

    def _reconcile_status(
        self, pcsg: PodCliqueScalingGroup, pcs: PodCliqueSet
    ) -> None:
        ns = pcsg.metadata.namespace
        # compute on the zero-copy view; write only on difference (the
        # steady state then costs no serialization at all)
        view = self.ctx.store.get(
            "PodCliqueScalingGroup", ns, pcsg.metadata.name, readonly=True
        )
        if view is None or view.metadata.deletion_timestamp is not None:
            return
        from grove_tpu_torch.controller.common import status_shadow

        fresh = status_shadow(view)
        scheduled = available = updated = 0
        for replica in range(fresh.spec.replicas):
            pclqs: List[PodClique] = []
            for clique_name in fresh.spec.clique_names:
                fqn = namegen.podclique_name(fresh.metadata.name, replica, clique_name)
                pclq = self.ctx.store.get(
                    "PodClique", ns, fqn, cached=True, readonly=True
                )
                if pclq is not None:
                    pclqs.append(pclq)
            if len(pclqs) < len(fresh.spec.clique_names):
                continue
            if all(
                (c := get_condition(p.status.conditions, COND_POD_CLIQUE_SCHEDULED))
                is not None
                and c.is_true()
                for p in pclqs
            ):
                scheduled += 1
            if not any(
                (c := get_condition(p.status.conditions, COND_MIN_AVAILABLE_BREACHED))
                is not None
                and c.is_true()
                for p in pclqs
            ):
                available += 1
            if all(
                p.status.updated_replicas >= p.spec.replicas for p in pclqs
            ):
                updated += 1

        st = fresh.status
        st.observed_generation = fresh.metadata.generation
        st.replicas = fresh.spec.replicas
        st.scheduled_replicas = scheduled
        st.available_replicas = available
        st.updated_replicas = updated
        st.selector = f"{namegen.LABEL_PCSG}={fresh.metadata.name}"
        now = self.ctx.clock.now()
        set_condition(st.conditions, self._breached_condition(fresh), now)
        write_status_if_changed(
            self.ctx, "PodCliqueScalingGroup", ns, pcsg.metadata.name, st
        )

    @staticmethod
    def _breached_condition(pcsg: PodCliqueScalingGroup) -> Condition:
        """reconcilestatus.go:149-207 — with the same never-scheduled guard
        as the PCLQ condition."""
        min_available = pcsg.spec.min_available
        if pcsg.status.scheduled_replicas < min_available:
            return Condition(
                type=COND_MIN_AVAILABLE_BREACHED,
                status="False",
                reason="InsufficientScheduledReplicas",
                message=(
                    f"Insufficient scheduled replicas. expected at least:"
                    f" {min_available}, found: {pcsg.status.scheduled_replicas}"
                ),
            )
        if pcsg.status.available_replicas < min_available:
            return Condition(
                type=COND_MIN_AVAILABLE_BREACHED,
                status="True",
                reason="InsufficientAvailableReplicas",
                message=(
                    f"Insufficient available replicas. expected at least:"
                    f" {min_available}, found: {pcsg.status.available_replicas}"
                ),
            )
        return Condition(
            type=COND_MIN_AVAILABLE_BREACHED,
            status="False",
            reason="SufficientAvailableReplicas",
            message="Sufficient available replicas",
        )
