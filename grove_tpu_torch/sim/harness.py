"""Simulation harness: the operator and the sim cluster in one virtual-time
loop.

Counterpart of ``grove_tpu/sim/harness.py``, the end-to-end run of the
reference quickstart: apply a PodCliqueSet, and the controllers derive its
PodCliques, PodCliqueScalingGroups, PodGangs and Pods, which the
``GangScheduler`` admits on ``device`` (the card unless the caller passes
``device="cpu"``) and the kubelet starts. The harness wires the engine, the
scheduler with the delta round, the explain engine, the node-health monitor,
the disruption broker, node drain, the autoscaler and the remediator.
``durability_dir`` (or ``attach_durability``) attaches a write-ahead log
and snapshots (``durability/``) before the first commit, one stream a
store shard, and ``tick_once`` group-commits it at the tick's end;
``cold_restart`` boots a fresh control plane over a recovered store. The
engine's ``overlap_hook`` is the scheduler's ``speculate_encode`` (only the
process drain calls it).
"""

from __future__ import annotations

from typing import List, Optional

from grove_tpu_torch.admission.defaulting import default_podcliqueset
from grove_tpu_torch.admission.validation import (
    ValidationError,
    validate_or_raise,
    validate_podcliqueset_update,
)
from grove_tpu_torch.api.load import load_podcliquesets
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.api.types import PodCliqueSet
from grove_tpu_torch.controller.common import OperatorContext
from grove_tpu_torch.controller.register import register_controllers
from grove_tpu_torch.runtime.clock import VirtualClock
from grove_tpu_torch.runtime.engine import Engine
from grove_tpu_torch.runtime.store import Store
from grove_tpu_torch.sim.cluster import SimCluster, make_nodes


class SimHarness:
    def __init__(
        self,
        num_nodes: int = 16,
        cache_lag: bool = True,
        topology: Optional[ClusterTopology] = None,
        config=None,  # Optional[OperatorConfiguration]
        store: Optional[Store] = None,
        nodes=None,  # Optional[List[Node]]: carried over on cold restart
        durability_dir: Optional[str] = None,
        device=None,
    ) -> None:
        from grove_tpu_torch.config.operator import OperatorConfiguration

        self.config = config or OperatorConfiguration()
        # `store`: a pre-built store; its clock is the harness clock
        self.clock = store.clock if store is not None else VirtualClock()
        self.store = store if store is not None else Store(
            self.clock, cache_lag=cache_lag
        )
        # the WAL attaches before any commit below, so the log covers the
        # store from rv 1 (on a recovered store: from the first commit
        # after recovery)
        self.durability = None
        if durability_dir is not None:
            self.attach_durability(durability_dir)
        # ClusterTopology lives in the store like any CR; when the config
        # enables it, startup requires the named CR to exist (the reference
        # crashes at boot if enabled-but-missing — cmd/main.go:72-75)
        self.topology = topology or ClusterTopology()
        if self.config.cluster_topology.enabled:
            from grove_tpu_torch.admission.validation import validate_cluster_topology

            res = validate_cluster_topology(self.topology)
            if not res.ok:
                raise ValueError(
                    f"cluster topology invalid: {'; '.join(res.errors)}"
                )
            self.topology.metadata.name = self.config.cluster_topology.name
        # cluster-scoped CR: no namespace, matching the wire/CRD scope and
        # the real-cluster manager's lookup (cluster/manager.py)
        self.topology.metadata.namespace = ""
        # the stored CR is the source of truth — keep its identity (uid/rv);
        # a recovered store already carries it (cold restart)
        existing = self.store.get(
            "ClusterTopology", "", self.topology.metadata.name
        )
        if existing is not None:
            self.topology = existing
        else:
            self.topology = self.store.create(self.topology)
        if self.config.authorizer.enabled:
            from grove_tpu_torch.admission.authorization import AuthorizationGuard

            self.store.guard = AuthorizationGuard(
                enabled=True,
                exempt_users=self.config.authorizer.exempt_service_accounts,
            )
        self.engine = Engine(self.store, self.clock)
        # virtual-clock awareness: spans carry the sim's virtual timestamp
        # (`vt` attr) and event first/last timestamps use virtual time, so
        # traces/events line up with requeue math instead of wall time.
        # Process-global singletons — the newest harness wins (one sim per
        # process in practice).
        from grove_tpu_torch.observability.events import EVENTS
        from grove_tpu_torch.observability.flightrec import FLIGHTREC
        from grove_tpu_torch.observability.journey import JOURNEYS
        from grove_tpu_torch.observability.timeseries import TIMESERIES
        from grove_tpu_torch.observability.tracing import TRACER

        TRACER.clock = self.clock
        EVENTS.clock = self.clock
        JOURNEYS.clock = self.clock
        FLIGHTREC.clock = self.clock
        TIMESERIES.clock = self.clock
        self.ctx = OperatorContext(
            store=self.store, clock=self.clock, topology=self.topology
        )
        register_controllers(self.engine, self.ctx, self.config)
        self.cluster = SimCluster(
            store=self.store,
            nodes=nodes if nodes is not None else make_nodes(num_nodes),
        )
        # TPU-solver-backed gang scheduler (the KAI-replacement); set to None
        # to fall back to the cluster's naive first-fit binder.
        from grove_tpu_torch.solver.scheduler import GangScheduler

        self.scheduler = GangScheduler(
            self.store,
            self.cluster,
            self.topology,
            priority_map=self.config.solver.priority_classes,
            chunk_size=min(self.config.solver.chunk_size, 64),
            max_waves=self.config.solver.max_waves,
            solver_sidecar=self.config.solver.sidecar_address or None,
            device=device,
        )
        # incremental delta-solve (solver/deltastate.py, docs/solver.md):
        # cluster tensors + gang specs folded from the watch stream instead
        # of per-tick full repasses — bit-identical to the from-scratch
        # path (GROVE_TPU_NO_DELTA=1 opts a run out for A/B measurement).
        # Under the runtime sanitizer every tick ALSO re-derives the
        # problem from scratch and asserts bit-equality (delta_selfcheck),
        # so sanitized chaos runs pin the equivalence continuously.
        import os as _os

        from grove_tpu_torch.analysis.sanitize import enabled as _sanitize_enabled

        if _os.environ.get("GROVE_TPU_NO_DELTA", "") not in ("1", "true"):
            self.scheduler.enable_delta()
            if _sanitize_enabled():
                self.scheduler.delta_selfcheck = True
        # partitioned solver frontier (solver/frontier.py): OPT-IN — it
        # changes placement semantics (partition-confined placements with
        # a global residual pass), so only scale-focused runs enable it.
        # Sanitized runs arm the per-tick batched-vs-sequential A/B.
        if _os.environ.get("GROVE_TPU_FRONTIER", "") in ("1", "true"):
            self.scheduler.enable_frontier()
            if _sanitize_enabled():
                self.scheduler.frontier_selfcheck = True
        # admission explain engine (observability/explain.py,
        # docs/observability.md "Admission explain"): on-demand,
        # strictly read-only — nothing runs unless somebody asks
        from grove_tpu_torch.observability.explain import ExplainEngine

        self.explain = ExplainEngine(self.scheduler)
        # node-health monitor (controller/nodehealth.py): heartbeat
        # lifecycle, pod failure on Lost nodes, gang rescue vs. requeue.
        # Inert while no node crashes (one O(nodes) pass per tick).
        from grove_tpu_torch.controller.nodehealth import NodeHealthMonitor

        self.node_monitor = NodeHealthMonitor(self.store, self.cluster)
        self.scheduler.monitor = self.node_monitor
        # the overlap pump: only the process drain calls it, between a
        # round's dispatch and its replies
        self.engine.overlap_hook = self.scheduler.speculate_encode
        # voluntary-disruption layer (grove_tpu/disruption): one broker
        # gates every voluntary evictor — preemption/reclaim (scheduler),
        # rolling update (ctx), node drain (the controller below). Inert
        # until a disruptionBudget exists or a drain is requested.
        from grove_tpu_torch.disruption import DisruptionBroker, NodeDrainController

        self.disruption = DisruptionBroker(self.store)
        self.scheduler.broker = self.disruption
        self.ctx.disruption = self.disruption
        self.drainer = NodeDrainController(
            self.store,
            self.cluster,
            self.scheduler,
            self.node_monitor,
            self.disruption,
        )
        self.node_monitor.drain_states = self.drainer.states
        # HPA controller equivalent (multi-level autoscaling)
        from grove_tpu_torch.autoscale.hpa import (
            HorizontalAutoscaler,
            StaticMetricsProvider,
        )

        self.metrics_provider = StaticMetricsProvider()
        self.autoscaler = HorizontalAutoscaler(
            self.store, self.metrics_provider, scale_down_stabilization=60.0
        )
        # remediation controller (controller/remediate.py,
        # docs/observability.md "Remediation & ledger"): detect→diagnose→
        # simulate→act→account over the existing mechanism layer. Always
        # constructed, OFF by default — a disabled remediator is provably
        # inert (one boolean check per tick, byte-identical A/B pinned).
        from grove_tpu_torch.controller.remediate import RemediationController

        self.remediator = RemediationController(
            self.store,
            self.cluster,
            self.scheduler,
            self.drainer,
            self.disruption,
            self.autoscaler,
            self.explain,
        )

    # -- durability ------------------------------------------------------

    def attach_durability(
        self,
        directory: str,
        segment_max_bytes: int = 4 * 2**20,
        snapshot_every_bytes: int = 32 * 2**20,
    ):
        """Attach a WAL and snapshot writer to this harness's store (one
        stream a shard). A snapshot scans the whole population, so the
        default cadence amortizes it over tens of MB of log."""
        from grove_tpu_torch.durability import StoreDurability

        self.durability = StoreDurability(
            self.store,
            directory,
            segment_max_bytes=segment_max_bytes,
            snapshot_every_bytes=snapshot_every_bytes,
        )
        return self.durability

    @classmethod
    def cold_restart(
        cls,
        store: Store,
        nodes,
        config=None,
        durability_dir: Optional[str] = None,
        device=None,
    ) -> "SimHarness":
        """Boot a fresh control plane over a recovered store: every piece
        of leader memory is rebuilt from persisted state, as in a
        failover."""
        h = cls(
            num_nodes=len(nodes),
            cache_lag=store.cache_lag,
            config=config,
            store=store,
            nodes=nodes,
            durability_dir=durability_dir,
            device=device,
        )
        h.engine.requeue_all()
        h.cluster.rebuild_bindings()
        h.node_monitor.resync()
        return h

    def schedule(self) -> int:
        if self.scheduler is not None:
            return self.scheduler.schedule_pending()
        return self.cluster.schedule_pending()

    # -- user actions ----------------------------------------------------

    def apply(self, pcs: PodCliqueSet) -> PodCliqueSet:
        from grove_tpu_torch.api.types import Queue

        if isinstance(pcs, Queue):
            return self.apply_queue(pcs)
        default_podcliqueset(pcs)
        existing = self.store.get(
            "PodCliqueSet", pcs.metadata.namespace, pcs.metadata.name
        )
        if existing is None:
            validate_or_raise(pcs, self.topology)
            return self.store.create(pcs)
        res = validate_podcliqueset_update(pcs, existing, self.topology)
        if not res.ok:
            raise ValidationError(res)
        existing.spec = pcs.spec
        return self.store.update(existing)

    def apply_queue(self, queue):
        """Create-or-update a tenant Queue (quota subsystem, docs/quota.md)
        through the same defaulting+validation the webhooks run."""
        from grove_tpu_torch.admission.defaulting import default_queue
        from grove_tpu_torch.admission.validation import validate_queue

        default_queue(queue)
        res = validate_queue(queue)
        if not res.ok:
            raise ValidationError(res)
        existing = self.store.get("Queue", "", queue.metadata.name)
        if existing is None:
            return self.store.create(queue)
        existing.spec = queue.spec
        return self.store.update(existing)

    def apply_yaml(self, text: str) -> List[PodCliqueSet]:
        return [self.apply(p) for p in load_podcliquesets(text)]

    def delete(self, name: str, namespace: str = "default") -> None:
        self.store.delete("PodCliqueSet", namespace, name)

    # -- convergence loop ------------------------------------------------

    def tick_once(self):
        """One tick of the convergence loop WITHOUT any clock advance:
        reconcile ⇄ schedule ⇄ kubelet ⇄ WAL pump ⇄ observatory round.
        Returns ``(work, bound, started)`` so callers can apply the same
        idle test converge() uses. Extracted so a federation tier can
        drive K harnesses in lockstep on one shared virtual clock — the
        body is byte-for-byte the old converge() tick."""
        from grove_tpu_torch.observability.profile import PROFILER
        from grove_tpu_torch.observability.slo import SLO
        from grove_tpu_torch.observability.timeseries import TIMESERIES

        # wall attribution (docs/observability.md "Wall-attribution
        # profiler"): every component of the tick gets a top-level
        # phase (engine/scheduler/WAL open their own finer phases
        # inside), so the roll-up's coverage vs an independent wall
        # measurement is arithmetic. phase() is the shared no-op while
        # profiling is off, and this runs per TICK, not per event —
        # the hot paths keep the `if PROFILER.enabled` guard.
        work = self.engine.drain()
        with PROFILER.phase("tick", controller="autoscaler"):
            work += self.autoscaler.tick()
        with PROFILER.phase("tick", controller="node-monitor"):
            work += self.node_monitor.tick()
        with PROFILER.phase("tick", controller="drain"):
            work += self.drainer.tick()
        bound = self.schedule()
        with PROFILER.phase("tick", controller="kubelet"):
            started = self.cluster.kubelet_tick()
        work += self.engine.drain()
        if self.durability is not None:
            # the group commit at the tick boundary (the WAL's own
            # ``wal-flush`` phase opens inside)
            with PROFILER.phase("tick", controller="wal"):
                self.durability.pump()
        # SLO observatory (observability/timeseries.py, slo.py): the
        # sampling round + objective evaluation run at the tick
        # boundary — one boolean check while the observatory is off
        if TIMESERIES.enabled:
            TIMESERIES.sample(self.clock.now())
            SLO.evaluate(self.clock.now())
        # remediation runs AFTER the observatory round so it reads
        # this tick's verdicts, not last tick's (one boolean when off)
        if self.remediator.enabled:
            with PROFILER.phase("tick", controller="remediator"):
                work += self.remediator.tick()
        return work, bound, started

    def next_wake(self) -> Optional[float]:
        """Earliest pending deadline across every deadline source — the
        idle-jump target converge() (and the federation router) uses.
        None means nothing is scheduled to fire."""
        wakes = [
            w
            for w in (
                self.engine.next_wakeup(),
                self.autoscaler.next_deadline(),
                self.node_monitor.next_deadline(),
                self.drainer.next_deadline(),
                self.remediator.next_deadline(),
            )
            if w is not None
        ]
        return min(wakes) if wakes else None

    def converge(self, max_ticks: int = 60, tick_seconds: float = 1.0) -> int:
        """Reconcile ⇄ schedule ⇄ kubelet until quiescent. Each tick advances
        virtual time so requeue_after-based waits can fire."""
        ticks = 0
        for _ in range(max_ticks):
            work, bound, started = self.tick_once()
            ticks += 1
            if bound == 0 and started == 0 and work == 0:
                # idle now — but short-horizon requeues (gate retries), a
                # held HPA scale-down, a node-grace deadline, a gang
                # requeue backoff, or an in-flight drain may be pending;
                # jump to the earliest wakeup rather than stopping early
                wake = self.next_wake()
                if wake is not None and wake - self.clock.now() <= 120.0:
                    self.clock.advance(max(wake - self.clock.now(), 0.0))
                    continue
                break
            self.clock.advance(tick_seconds)
        from grove_tpu_torch.analysis.sanitize import store_guard_enabled

        if store_guard_enabled():
            # test-mode write barrier: a reconciler that mutated a zero-copy
            # readonly view during this converge fails loudly here (the
            # suite sets the flag in conftest, sanitizer mode implies it;
            # production converges don't pay the re-pickle)
            self.store.verify_readonly_integrity()
        return ticks

    def advance(self, seconds: float) -> None:
        self.clock.advance(seconds)

    # -- inspection ------------------------------------------------------

    def tree(self, namespace: str = "default") -> str:
        """kubectl-tree-style dump: pcs > pclq/pcsg > pg > pod."""
        from grove_tpu_torch.api.inspect import render_tree

        return render_tree(self.store, namespace)
