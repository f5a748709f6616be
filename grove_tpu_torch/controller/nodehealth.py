"""Node-health monitor: heartbeat lifecycle, pod failure, gang rescue.

Counterpart of ``grove_tpu/controller/nodehealth.py``. The node-controller role the reference delegates to Kubernetes itself
(kube-controller-manager's node lifecycle controller) plus the gang-aware
recovery policy its scheduler contract implies (SURVEY §5 failure handling):

- **Lifecycle** — every node heartbeats on the virtual clock
  (``SimCluster.heartbeat_tick``); a crashed kubelet stops, and this monitor
  walks the node through Ready → NotReady (grace window, pods stay bound)
  → Lost (grace exceeded). A restart inside the window is a harmless flap.
- **Pod failure** — pods bound to a Lost node are failed and deleted
  (node-eviction semantics): their bindings and capacity release
  immediately, the PodClique controllers recreate them gated, and the quota
  accountant folds the deltas from the same watch events every other
  consumer sees — usage stays exact through the failure.
- **Gang rescue vs. requeue** (docs/robustness.md decision table) — for
  each gang that lost pods:
  - survivors still satisfy every group's MinReplicas floor → **rescue**:
    survivors keep running, and the scheduler's recovery delta-solve places
    only the missing pods, anchored to the survivors' topology domain by
    the packing kernel's recovery pins (ops/packing.py group_pin/gang_pin).
    ``GangRescued`` is emitted once the gang is whole again.
  - survivors breach a floor → **gang-terminate**: the remaining pods are
    torn down, the gang's Scheduled condition flips False
    (reason NodeFailure), and the whole gang re-enters the all-or-nothing
    solver under rate-limited exponential backoff (``GangRequeued``).

Driven as a tick from the harness loop (like the autoscaler) rather than a
store-keyed reconciler: its primary resource — the node — is cluster
infrastructure, not a stored CR.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import Condition, get_condition, set_condition
from grove_tpu_torch.api.pod import is_terminating
from grove_tpu_torch.api.types import (
    COND_PODGANG_DISRUPTION_TARGET,
    COND_PODGANG_SCHEDULED,
    PHASE_PENDING,
)
from grove_tpu_torch.observability.events import (
    EVENTS,
    REASON_GANG_RELEASED,
    REASON_GANG_REQUEUED,
    REASON_GANG_RESCUED,
    REASON_NODE_DEGRADED,
    REASON_NODE_LOST,
    REASON_NODE_NOT_READY,
    REASON_NODE_READY,
    REASON_NODE_RECOVERED,
    TYPE_NORMAL,
    TYPE_WARNING,
)
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.runtime.errors import ERR_CONFLICT, ERR_NOT_FOUND, GroveError
from grove_tpu_torch.runtime.workqueue import WorkQueue
from grove_tpu_torch.sim.cluster import (
    NODE_DEGRADED,
    NODE_LOST,
    NODE_NOT_READY,
    NODE_READY,
    SimCluster,
)

GangKey = Tuple[str, str]  # (namespace, gang name)


class _EpochSet(set):
    """Set that counts its effective mutations. The scheduler's overlap
    pump keys speculative spec reuse on hold-state staleness: any
    hold/release between speculation and the real encode must invalidate
    the speculated spec (``gang_held`` gates encoding), and the epoch is
    the O(1) way to observe that."""

    def __init__(self, *args) -> None:
        super().__init__(*args)
        self.epoch = 0

    def add(self, item) -> None:
        if item not in self:
            self.epoch += 1
        super().add(item)

    def discard(self, item) -> None:
        if item in self:
            self.epoch += 1
        super().discard(item)

    def clear(self) -> None:
        if self:
            self.epoch += 1
        super().clear()


class NodeHealthMonitor:
    """Grace-period node lifecycle + gang-aware failure recovery over a
    SimCluster. One instance per scheduler/cluster pair."""

    def __init__(
        self,
        store,
        cluster: SimCluster,
        not_ready_after: float = 10.0,
        lost_after: float = 30.0,
        failslow_threshold: Optional[float] = None,
        failslow_recover: Optional[float] = None,
        failslow_alpha: float = 0.3,
    ) -> None:
        assert lost_after >= not_ready_after
        self.store = store
        self.cluster = cluster
        self.not_ready_after = not_ready_after
        self.lost_after = lost_after
        # gray-failure (fail-slow) detection, docs/robustness.md "Gray
        # failures". OFF by default (threshold None): the suspicion lane is
        # one boolean check and the monitor is byte-identical to before.
        # When armed, each tick folds the node's heartbeat LATENESS (age at
        # observation — late-but-inside-grace heartbeats that the binary
        # lifecycle ignores) into an EWMA suspicion score; score above
        # `failslow_threshold` seconds flips Ready → Degraded (masked from
        # new placements via `Node.schedulable`, nothing evicted); decay
        # below `failslow_recover` (hysteresis, default threshold/2) flips
        # back. Eviction is NOT this monitor's call — only the remediation
        # controller may drain a Degraded node, behind a what-if-proven
        # flip and the disruption budget (TRIGGER_FAILSLOW).
        self.failslow_threshold = failslow_threshold
        self.failslow_recover = (
            failslow_recover
            if failslow_recover is not None
            else (failslow_threshold / 2.0 if failslow_threshold else None)
        )
        self.failslow_alpha = failslow_alpha
        # node name -> EWMA suspicion score (seconds of smoothed lateness).
        # Private state: only this monitor writes it.
        self._suspicion: Dict[str, float] = {}
        # requeued gangs in rate-limited backoff: the workqueue's delayed
        # heap paces re-admission; _held is what the scheduler consults
        # (gang_held) to keep a backing-off gang out of the solve. Gang
        # re-admission is paced in SECONDS (one solve attempt per release),
        # not the reconcile queues' 5ms curve — a gang retrying every drain
        # while capacity is gone would just burn solver rounds
        self.requeue = WorkQueue(base_backoff=1.0, max_backoff=60.0)
        self._held: Set[GangKey] = _EpochSet()
        # gangs whose triage (status flip / pod teardown) hit a transient
        # store error: retried level-triggered on the next tick
        self._triage_retry: Dict[GangKey, str] = {}
        # released-from-backoff gangs get exactly ONE scheduler round: still
        # unscheduled at the next tick → re-held with the next backoff step
        # (client-go retry pacing); scheduled → forgotten
        self._probation: Set[GangKey] = set()
        # in-flight rescues: gang key -> {domain_key, domain, survivors,...};
        # completion (gang whole again) emits GangRescued and archives into
        # `rescues` for the chaos harness's placement verification
        self._rescue_pending: Dict[GangKey, dict] = {}
        self.rescues: List[dict] = []
        # GET /nodes drain column: () -> {node name: Draining|Drained},
        # wired to NodeDrainController.states by the harness/manager (the
        # drain workflow is a separate controller; the monitor only
        # surfaces its state in the node table)
        self.drain_states = None

    # -- scheduler contract ----------------------------------------------

    def gang_held(self, namespace: str, name: str) -> bool:
        """True while the gang sits in requeue backoff — the scheduler
        skips encoding it (its pods stay pending, untouched)."""
        return (namespace, name) in self._held

    @property
    def holds_epoch(self) -> int:
        """Mutation counter of the requeue-hold set: any hold or release
        bumps it, so the scheduler's overlap pump can fold hold-state
        into its staleness token without copying the set."""
        return self._held.epoch

    def hold_gang(self, key: GangKey) -> None:
        """Put a gang into rate-limited requeue backoff from OUTSIDE the
        node-failure triage — the drain controller's terminate-and-requeue
        fallback uses the same pacing a NodeFailure termination gets.
        Every hold is paired with a scheduled release (the workqueue's
        delayed entry) — a hold without one would strand the gang, since
        nothing else ever releases it."""
        self._held.add(key)
        self._probation.discard(key)
        self.requeue.add_rate_limited(
            ("PodGang",) + key, self.store.clock.now()
        )

    def resync(self) -> int:
        """Fresh-leader re-prime (manager run-loop failover, chaos
        ``leader_crash``): monitor holds and backoff counters live in
        leader memory, so a standby that takes over mid-outage starts with
        none — every gang the OLD leader had terminated-and-requeued would
        re-enter the solve unpaced (churn), and a NAIVE re-prime that adds
        holds without scheduled releases would strand them forever.

        Re-derive from persisted state: a gang whose Scheduled condition
        is False with a terminate-and-requeue reason (NodeFailure/Drained)
        is re-held WITH a fresh rate-limited release while unhealthy
        capacity is still missing; once every node is back there is
        nothing to wait for — it goes to probation for an immediate solve
        attempt instead. Also drops stale holds for gangs that vanished or
        re-scheduled. Returns entries touched."""
        now = self.store.clock.now()
        # LIVE health, not the state label: `state` is maintained by monitor
        # ticks (this monitor has run none), so a node restarted just
        # before the failover still reads Lost — but its kubelet is up
        # (crashed=False) and the first tick will flip it Ready. Only a
        # dead kubelet means capacity is actually missing.
        unhealthy = any(n.crashed for n in self.cluster.nodes)
        touched = 0
        for gang in self.store.scan("PodGang"):
            key = (gang.metadata.namespace, gang.metadata.name)
            cond = get_condition(
                gang.status.conditions, COND_PODGANG_SCHEDULED
            )
            if cond is None or cond.is_true():
                continue
            if cond.reason not in ("NodeFailure", "Drained"):
                continue
            if key in self._held or key in self._probation:
                continue
            if unhealthy:
                self._held.add(key)
                self.requeue.add_rate_limited(("PodGang",) + key, now)
            else:
                # capacity is all back: pacing a placeable gang would only
                # idle it — one immediate solve attempt, then normal
                # probation re-arming if it still does not fit
                self._probation.add(key)
            touched += 1
        for key in sorted(self._held):
            gang = self.store.get("PodGang", key[0], key[1], readonly=True)
            cond = (
                get_condition(gang.status.conditions, COND_PODGANG_SCHEDULED)
                if gang is not None
                else None
            )
            if gang is None or (cond is not None and cond.is_true()):
                self._held.discard(key)
                wq_key = ("PodGang",) + key
                self.requeue.forget(wq_key)
                self.requeue.discard_delayed(wq_key)
                touched += 1
        touched += self._resync_rescues(now)
        return touched

    def _resync_rescues(self, now: float) -> int:
        """Rescue tracking is leader memory too: a gang mid-rescue at
        failover (Scheduled=True, replacement pods not yet bound) would
        complete silently — no GangRescued, no domain verification. Re-prime
        a pending-rescue record for every scheduled gang with unbound pod
        references; the survivors' domain is recomputed from live bindings
        (the lost node's name is gone with the old leader)."""
        primed = 0
        for gang in self.store.scan("PodGang"):
            key = (gang.metadata.namespace, gang.metadata.name)
            if key in self._rescue_pending or key in self._held:
                continue
            cond = get_condition(
                gang.status.conditions, COND_PODGANG_SCHEDULED
            )
            if cond is None or not cond.is_true():
                continue
            whole = all(
                (ref.namespace, ref.name) in self.cluster.bindings
                for group in gang.spec.pod_groups
                for ref in group.pod_references
            )
            if whole:
                continue
            domain_key, domain = self._survivor_domain(gang)
            self._rescue_pending[key] = {
                "namespace": key[0],
                "gang": key[1],
                "lost_node": "(pre-failover)",
                "survivors": dict(self._group_survivors(gang)),
                "domain_key": domain_key,
                "domain": domain,
                "since": now,
            }
            primed += 1
        return primed

    def next_deadline(self) -> Optional[float]:
        """Earliest future moment this monitor will act: a crashed node
        crossing NotReady/Lost, or a backoff release. The harness jumps
        virtual time here when otherwise idle."""
        deadlines = []
        for node in self.cluster.nodes:
            if not node.crashed or node.state == NODE_LOST:
                continue
            threshold = (
                self.not_ready_after
                if node.state == NODE_READY
                else self.lost_after
            )
            deadlines.append(node.last_heartbeat + threshold)
        wake = self.requeue.next_delayed_at()
        if wake is not None:
            deadlines.append(wake)
        if self.failslow_threshold is not None and (
            self.cluster.failslow_names()
            or any(s > 0.0 for s in self._suspicion.values())
        ):
            # suspicion only moves when a tick observes it: while a
            # fail-slow fault is armed (or a score is still decaying) the
            # harness must keep ticking through idle periods, or Degraded
            # entry/exit would stall with virtual time
            deadlines.append(self.store.clock.now() + 1.0)
        return min(deadlines) if deadlines else None

    # -- tick -------------------------------------------------------------

    def tick(self) -> int:
        """One monitor round. Returns the number of actions taken (state
        transitions + pod evictions + gang decisions + backoff moves) so
        the harness's quiescence check sees monitor work as progress."""
        now = self.store.clock.now()
        actions = 0
        actions += self._check_probation()
        newly_lost, recovered, gray_moves = self._refresh_node_states(now)
        actions += len(newly_lost) + gray_moves
        if recovered and self._held:
            # capacity just returned (a lost node rejoined): waiting out
            # the rest of the backoff would idle a placeable gang — release
            # every held gang for an immediate solve round, with failure
            # counts reset (the world changed; stale backoff is meaningless)
            for gang_key in sorted(self._held):
                wq_key = ("PodGang",) + gang_key
                self.requeue.forget(wq_key)
                # drop the scheduled entry too: it would otherwise pop
                # later and grant an extra release outside the pacing
                self.requeue.discard_delayed(wq_key)
                self._probation.add(gang_key)
                actions += 1
            self._held.clear()
        # evict from EVERY lost node each tick, not just newly-lost ones:
        # a binding can appear on an already-Lost node through commit races
        # (and rebuild_bindings on failover), and the no-binding-to-Lost
        # invariant must be level-triggered, not edge-triggered
        lost = [n for n in self.cluster.nodes if n.state == NODE_LOST]
        affected: Dict[GangKey, str] = dict(self._triage_retry)
        self._triage_retry.clear()
        for node in lost:
            actions += self._evict_lost_node(node, affected)
        for key, lost_node in sorted(affected.items()):
            try:
                actions += self._triage_gang(key, lost_node, now)
            except GroveError:
                # transient store outage mid-triage: every step is
                # idempotent — re-run the whole decision next tick
                self._triage_retry[key] = lost_node
        actions += self._release_due(now)
        actions += self._check_rescues(now)
        self._export_gauges(now)
        return actions

    # -- node lifecycle ---------------------------------------------------

    def _refresh_node_states(self, now: float) -> Tuple[List, bool, int]:
        newly_lost = []
        recovered = False
        gray_moves = 0
        hb_floor = 0.0
        if self.failslow_threshold is not None:
            # peer-relative baseline: the healthiest live kubelet's
            # heartbeat age. Observation cadence and idle-time jumps
            # inflate every node's age equally — subtracting the floor
            # cancels them, so a healthy cohort scores 0 and a fail-slow
            # node's lateness is exactly its extra lag over its peers
            live_ages = [
                now - n.last_heartbeat
                for n in self.cluster.nodes
                if not n.crashed
            ]
            hb_floor = min(live_ages) if live_ages else 0.0
        for node in self.cluster.nodes:
            if not node.crashed:
                if self.failslow_threshold is not None:
                    # suspicion lane (gray failures): Ready ⇄ Degraded is
                    # decided by the EWMA, entirely outside the binary
                    # want-compare below — a Degraded node must not emit a
                    # spurious NodeReady while its heartbeats are merely
                    # late-but-inside-grace
                    gray_moves += self._suspect(node, now, hb_floor)
                    if node.state == NODE_DEGRADED:
                        continue
                # a live kubelet heartbeats by definition (heartbeat_tick
                # refreshes the timestamp); large virtual-time jumps must
                # never read as cluster-wide heartbeat loss
                want = NODE_READY
            else:
                age = now - node.last_heartbeat
                # strict comparisons: next_deadline() wakes the harness at
                # exactly last_heartbeat + threshold, and that tick must
                # already observe the transition (<= would wake to a no-op
                # and stall virtual time)
                if age < self.not_ready_after:
                    want = NODE_READY
                elif age < self.lost_after:
                    want = NODE_NOT_READY
                else:
                    want = NODE_LOST
            if want == NODE_READY and node.state == NODE_DEGRADED:
                # crashed fail-slow node still inside the grace window:
                # keep the Degraded mask (recovery goes through the
                # suspicion hysteresis once the kubelet is back, not
                # through the binary lane)
                continue
            if want == node.state:
                continue
            ref = ("Node", "", node.name)
            if want == NODE_NOT_READY:
                EVENTS.record(
                    ref,
                    TYPE_WARNING,
                    REASON_NODE_NOT_READY,
                    f"no heartbeat for {now - node.last_heartbeat:.1f}s "
                    f"(grace {self.lost_after:g}s)",
                )
            elif want == NODE_LOST:
                EVENTS.record(
                    ref,
                    TYPE_WARNING,
                    REASON_NODE_LOST,
                    f"heartbeat grace period ({self.lost_after:g}s) "
                    "exceeded; failing its pods",
                )
                METRICS.inc("node_lost_total")
                newly_lost.append(node)
            elif want == NODE_READY:
                EVENTS.record(
                    ref,
                    TYPE_NORMAL,
                    REASON_NODE_READY,
                    f"heartbeat restored (was {node.state})",
                )
                if node.state == NODE_NOT_READY:
                    # recovered inside the grace window: a flap, no pod
                    # was failed
                    METRICS.inc("node_flaps_total")
                elif node.state == NODE_LOST:
                    recovered = True  # capacity returned to the pool
            node.state = want
        return newly_lost, recovered, gray_moves

    def _suspect(self, node, now: float, hb_floor: float) -> int:
        """Fold one heartbeat-lateness observation into the node's EWMA
        suspicion score and apply the Ready ⇄ Degraded hysteresis. Returns
        the number of state transitions (0 or 1).

        Lateness is PEER-RELATIVE: this node's heartbeat age minus the
        healthiest live node's (`hb_floor`) — fail-slow means "slow
        compared to the cohort", and the subtraction makes the score
        independent of tick cadence and virtual-time jumps. The score is
        a PURE function of the observed lateness trace:
        s ← α·lateness + (1−α)·s, s₀ = 0 — the storm test replays the
        seeded trace through a NumPy oracle and pins equality."""
        lateness = max(0.0, (now - node.last_heartbeat) - hb_floor)
        s = self.failslow_alpha * lateness + (
            1.0 - self.failslow_alpha
        ) * self._suspicion.get(node.name, 0.0)
        if s < 1e-3:
            # clamp the asymptotic decay tail to a true zero so an idle
            # cluster quiesces (next_deadline stops scheduling wake-ups)
            s = 0.0
        self._suspicion[node.name] = s
        ref = ("Node", "", node.name)
        if node.state == NODE_READY and s > self.failslow_threshold:
            node.state = NODE_DEGRADED
            EVENTS.record(
                ref,
                TYPE_WARNING,
                REASON_NODE_DEGRADED,
                f"fail-slow suspicion {s:.2f}s exceeds"
                f" {self.failslow_threshold:g}s (EWMA of heartbeat"
                " lateness); masking from new placements, running pods"
                " stay bound",
            )
            METRICS.inc("node_degraded_total")
            return 1
        if node.state == NODE_DEGRADED and s < self.failslow_recover:
            node.state = NODE_READY
            EVENTS.record(
                ref,
                TYPE_NORMAL,
                REASON_NODE_RECOVERED,
                f"fail-slow suspicion decayed to {s:.2f}s (below"
                f" {self.failslow_recover:g}s); schedulable again",
            )
            METRICS.inc("node_recovered_total")
            return 1
        return 0

    def _evict_lost_node(self, node, affected: Dict[GangKey, str]) -> int:
        """Fail every pod bound to the Lost node: delete it (the PCLQ
        controller recreates it gated) and release its binding/capacity at
        once. Records each touched gang in `affected` for triage."""
        victims = [
            key
            for key, bound in self.cluster.bindings.items()
            if bound == node.name
        ]
        evicted = 0
        for ns, pod_name in victims:
            pod = self.store.get("Pod", ns, pod_name, readonly=True)
            if pod is None:
                # grovelint: disable=GL012 -- the pod's store Deleted event already fired (it is gone from the store), so the delta fold released this charge; only the stale cluster-map entry remains
                self.cluster.bindings.pop((ns, pod_name), None)
                continue
            gang_name = pod.metadata.labels.get(namegen.LABEL_PODGANG)
            if gang_name:
                affected.setdefault((ns, gang_name), node.name)
            try:
                self.store.delete("Pod", ns, pod_name)
            except GroveError as e:
                if e.code != ERR_NOT_FOUND:
                    # transient store outage: keep the binding so the
                    # level-triggered sweep retries next tick
                    continue
            # release the binding only once the pod is actually gone —
            # a kept binding for a live pod stays visible to capacity
            # accounting and survivor counts
            # grovelint: disable=GL012 -- store.delete above just fired the watch event (or NOT_FOUND: it fired earlier); the event is the registration, this pop only syncs the cluster map
            self.cluster.bindings.pop((ns, pod_name), None)
            evicted += 1
        if evicted:
            EVENTS.record(
                ("Node", "", node.name),
                TYPE_WARNING,
                REASON_NODE_LOST,
                f"failed {evicted} pod(s) bound to lost node {node.name}",
            )
            METRICS.inc("node_evicted_pods_total", evicted)
        return evicted

    # -- gang triage: rescue vs. requeue ----------------------------------

    def _group_survivors(self, gang) -> Dict[str, int]:
        # a pod only counts as a survivor on a HEALTHY node: a binding that
        # outlived a failed eviction attempt (store outage) must not make a
        # doomed gang look rescuable. Degraded is NOT unhealthy here — a
        # fail-slow node's pods are alive and running (that is the whole
        # point of the state); counting them dead would terminate gangs a
        # gray failure never broke
        unhealthy = {
            n.name
            for n in self.cluster.nodes
            if n.state in (NODE_NOT_READY, NODE_LOST)
        }
        out: Dict[str, int] = {}
        for group in gang.spec.pod_groups:
            n = 0
            for ref in group.pod_references:
                bound = self.cluster.bindings.get((ref.namespace, ref.name))
                if bound is None or bound in unhealthy:
                    continue
                pod = self.store.get(
                    "Pod", ref.namespace, ref.name, readonly=True
                )
                if pod is not None and not is_terminating(pod):
                    n += 1
            out[group.name] = n
        return out

    def _triage_gang(self, key: GangKey, lost_node: str, now: float) -> int:
        ns, name = key
        gang = self.store.get("PodGang", ns, name, readonly=True)
        if gang is None:
            return 0
        cond = get_condition(gang.status.conditions, COND_PODGANG_SCHEDULED)
        if cond is None or not cond.is_true():
            # the gang was not placed (or is already torn down / requeued):
            # its pending pods flow through the normal solve, nothing to do
            return 0
        survivors = self._group_survivors(gang)
        rescuable = all(
            survivors.get(g.name, 0) >= g.min_replicas
            for g in gang.spec.pod_groups
        )
        if rescuable:
            self._begin_rescue(key, gang, survivors, lost_node, now)
        else:
            self._terminate_and_requeue(key, gang, survivors, lost_node, now)
        return 1

    def _survivor_domain(self, gang) -> Tuple[Optional[str], Optional[str]]:
        """(topology key, domain label) of the survivors when the gang has a
        gang-level required pack — the domain its replacements must rejoin
        (verified at rescue completion and by the chaos harness)."""
        tc = gang.spec.topology_constraint
        required = (
            tc.pack_constraint.required
            if tc is not None and tc.pack_constraint is not None
            else None
        )
        if required is None:
            return None, None
        for group in gang.spec.pod_groups:
            for ref in group.pod_references:
                bound = self.cluster.bindings.get((ref.namespace, ref.name))
                node = self.cluster.node(bound) if bound else None
                if node is not None:
                    return required, node.labels.get(required)
        return required, None

    def _begin_rescue(
        self, key: GangKey, gang, survivors: Dict, lost_node: str, now: float
    ) -> None:
        domain_key, domain = self._survivor_domain(gang)
        self._rescue_pending[key] = {
            "namespace": key[0],
            "gang": key[1],
            "lost_node": lost_node,
            "survivors": dict(survivors),
            "domain_key": domain_key,
            "domain": domain,
            "since": now,
        }

    def _terminate_and_requeue(
        self, key: GangKey, gang, survivors: Dict, lost_node: str, now: float
    ) -> None:
        ns, name = key
        self._rescue_pending.pop(key, None)
        # tear down the remaining pods: a gang below its floor is broken as
        # a unit (gang semantics) — survivors' fragmented capacity returns
        # to the pool and the whole gang re-places atomically later
        for group in gang.spec.pod_groups:
            for ref in group.pod_references:
                try:
                    self.store.delete("Pod", ref.namespace, ref.name)
                except GroveError as e:
                    if e.code != ERR_NOT_FOUND:
                        raise  # tick-level retry re-runs the triage
                # grovelint: disable=GL012 -- store.delete above fired the Deleted watch event (NOT_FOUND means it fired earlier); the delta fold already released the charge
                self.cluster.bindings.pop((ref.namespace, ref.name), None)
        breached = {
            g.name: (survivors.get(g.name, 0), g.min_replicas)
            for g in gang.spec.pod_groups
            if survivors.get(g.name, 0) < g.min_replicas
        }
        message = (
            f"node {lost_node} lost; survivors below MinReplicas "
            f"({', '.join(f'{g}={s}/{m}' for g, (s, m) in sorted(breached.items()))})"
            "; gang terminated and requeued"
        )
        # retry-with-fresh-read like the scheduler's evictions: the status
        # flip and the pod deletions must land together
        for _ in range(4):
            fresh = self.store.get("PodGang", ns, name)
            if fresh is None:
                break
            set_condition(
                fresh.status.conditions,
                Condition(
                    type=COND_PODGANG_DISRUPTION_TARGET,
                    status="True",
                    reason="NodeFailure",
                    message=message,
                ),
                now,
            )
            set_condition(
                fresh.status.conditions,
                Condition(
                    type=COND_PODGANG_SCHEDULED,
                    status="False",
                    reason="NodeFailure",
                    message=message,
                ),
                now,
            )
            fresh.status.phase = PHASE_PENDING
            fresh.status.placement_score = None
            try:
                self.store.update_status(fresh)
                break
            except GroveError as e:
                if e.code != ERR_CONFLICT:
                    raise
        EVENTS.record(
            ("PodGang", ns, name), TYPE_WARNING, REASON_GANG_REQUEUED, message
        )
        METRICS.inc("gang_requeues_total")
        self._held.add(key)
        self._probation.discard(key)
        self.requeue.add_rate_limited(("PodGang", ns, name), now)

    # -- backoff pacing ----------------------------------------------------

    def _release_due(self, now: float) -> int:
        released = 0
        while True:
            key = self.requeue.pop(now)
            if key is None:
                return released
            gang_key = (key[1], key[2])
            if gang_key not in self._held:
                continue  # forgotten meanwhile (gang deleted)
            self._held.discard(gang_key)
            self._probation.add(gang_key)
            EVENTS.record(
                key,
                TYPE_NORMAL,
                REASON_GANG_RELEASED,
                f"backoff expired after {self.requeue.failures(key)} "
                "attempt(s); re-entering the all-or-nothing solve",
            )
            released += 1

    def _check_probation(self) -> int:
        """Gangs released last tick had one solve round: re-arm the ones
        still unscheduled, forget the ones that made it (or vanished)."""
        moved = 0
        now = self.store.clock.now()
        for gang_key in sorted(self._probation):
            ns, name = gang_key
            wq_key = ("PodGang", ns, name)
            gang = self.store.get("PodGang", ns, name, readonly=True)
            cond = (
                get_condition(gang.status.conditions, COND_PODGANG_SCHEDULED)
                if gang is not None
                else None
            )
            if gang is None or (cond is not None and cond.is_true()):
                self._probation.discard(gang_key)
                self.requeue.forget(wq_key)
                moved += 1
                continue
            # still pending: next backoff step (capacity has not returned)
            self._probation.discard(gang_key)
            self._held.add(gang_key)
            self.requeue.add_rate_limited(wq_key, now)
            moved += 1
        return moved

    # -- rescue completion -------------------------------------------------

    def _check_rescues(self, now: float) -> int:
        done = 0
        for key in sorted(self._rescue_pending):
            rec = self._rescue_pending[key]
            ns, name = key
            gang = self.store.get("PodGang", ns, name, readonly=True)
            if gang is None or key in self._held:
                del self._rescue_pending[key]
                continue
            cond = get_condition(
                gang.status.conditions, COND_PODGANG_SCHEDULED
            )
            if cond is None or not cond.is_true():
                # preempted/reclaimed/terminated while rescuing: the gang
                # re-places whole through its own path — not a rescue
                del self._rescue_pending[key]
                continue
            nodes = []
            whole = True
            for group in gang.spec.pod_groups:
                for ref in group.pod_references:
                    bound = self.cluster.bindings.get(
                        (ref.namespace, ref.name)
                    )
                    if bound is None:
                        whole = False
                        break
                    nodes.append(bound)
                if not whole:
                    break
            if not whole:
                continue  # replacements still pending; check next tick
            rec["completed_at"] = now
            rec["placement_nodes"] = nodes
            if rec["domain_key"] is not None and rec["domain"] is not None:
                rec["rejoined_domain"] = all(
                    (n := self.cluster.node(nn)) is not None
                    and n.labels.get(rec["domain_key"]) == rec["domain"]
                    for nn in nodes
                )
            EVENTS.record(
                ("PodGang", ns, name),
                TYPE_NORMAL,
                REASON_GANG_RESCUED,
                f"gang whole again after losing {rec['lost_node']}"
                + (
                    f"; replacements rejoined {rec['domain_key']}="
                    f"{rec['domain']}"
                    if rec.get("domain") is not None
                    else ""
                ),
            )
            METRICS.inc("gang_rescues_total")
            self.rescues.append(rec)
            del self._rescue_pending[key]
            done += 1
        return done

    # -- observability -----------------------------------------------------

    def _export_gauges(self, now: float) -> None:
        counts = {
            NODE_READY: 0,
            NODE_NOT_READY: 0,
            NODE_LOST: 0,
            NODE_DEGRADED: 0,
        }
        max_age = 0.0
        for node in self.cluster.nodes:
            counts[node.state] = counts.get(node.state, 0) + 1
            if node.crashed:
                max_age = max(max_age, now - node.last_heartbeat)
        METRICS.set("nodes_ready", counts[NODE_READY])
        METRICS.set("nodes_not_ready", counts[NODE_NOT_READY])
        METRICS.set("nodes_lost", counts[NODE_LOST])
        METRICS.set("nodes_degraded", counts[NODE_DEGRADED])
        METRICS.set(
            "node_suspicion_max_seconds",
            max(self._suspicion.values()) if self._suspicion else 0.0,
        )
        METRICS.set("node_heartbeat_age_max_seconds", max_age)
        METRICS.set("gangs_in_requeue_backoff", len(self._held))
        METRICS.set("gang_rescues_pending", len(self._rescue_pending))

    def node_snapshot(self) -> List[dict]:
        """Wire-shape node table for GET /nodes and `cli nodes`
        (docs/observability.md)."""
        now = self.store.clock.now()
        bound_counts: Dict[str, int] = {}
        # list() snapshot: GET /nodes serves from apiserver threads while
        # the sim/scheduler thread binds and evicts concurrently — iterating
        # the live dict would race ("dict changed size during iteration")
        for _key, bound in list(self.cluster.bindings.items()):
            bound_counts[bound] = bound_counts.get(bound, 0) + 1
        drains = self.drain_states() if self.drain_states is not None else {}
        return [
            {
                "name": n.name,
                "state": n.state,
                "cordoned": n.cordoned,
                "schedulable": n.schedulable,
                # "" | Draining | Drained (docs/robustness.md drain flow)
                "drain": drains.get(n.name, ""),
                "heartbeatAgeSeconds": round(max(0.0, now - n.last_heartbeat), 3),
                # EWMA fail-slow suspicion (0.0 while detection is off)
                "suspicion": round(self._suspicion.get(n.name, 0.0), 3),
                "capacity": dict(n.capacity),
                "labels": dict(n.labels),
                "boundPods": bound_counts.get(n.name, 0),
            }
            for n in list(self.cluster.nodes)
        ]
