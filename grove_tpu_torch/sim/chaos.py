"""Seeded chaos harness: deterministic fault schedules over a mixed-gang sim.

Counterpart of ``grove_tpu/sim/chaos.py``, with its names, report fields
and seeded schedules; every harness it builds (the run, its fault-free
twin, the failover's scheduler, the cold restart, each federation region)
solves on ``device``, the card unless the caller passes ``device="cpu"``.

The acceptance run for the node-failure & recovery subsystem
(docs/robustness.md): a fixed seed expands into a fault schedule — node
crashes (beyond the heartbeat grace window: real losses), a flap (crash +
restart inside the window), a transient store outage (the
``Store.error_injectors`` hook), a gang-aware node **drain** (the
voluntary-disruption layer: budget-checked, trial-solved, gang-whole
eviction), and a **leader crash** mid-drain (LeaseElector failover: the
standby takes the lease, rebuilds every piece of leader memory — engine
requeue_all, binding map, monitor holds via ``resync()``, drain intents
from the persisted NodeDrain objects — and the run continues) — replayed
on virtual time over a workload that mixes rescuable gangs (with a
``disruptionBudget``), topology-packed rescuable gangs, and strict
(minAvailable == replicas) gangs that must gang-terminate and requeue.

Every tick asserts the chaos invariants:

1. **No binding targets a Lost node** (level-triggered, after the monitor's
   sweep).
2. **No scheduled gang sits below its MinReplicas floor past the grace
   window** — breaches must resolve (rescue or gang-terminate) within
   ``lost_after`` plus a small slack.
3. **Capacity accounting stays exact**: the incremental quota accountant
   equals a full recount (``quota/oracle.py::usage_oracle``), and no node's
   bound requests exceed its capacity.
4. **No disruptionBudget is ever exceeded**: per budgeted PodCliqueSet, the
   gangs unavailable due to a VOLUNTARY disruption never outnumber
   ``maxUnavailableGangs`` — across drain, failover, everything.
5. **No stranded hold**: every gang the monitor holds in requeue backoff
   has a scheduled release in the workqueue (a hold without one would wait
   forever — the failover-resync bug class).

After the last fault clears, the run must converge: every gang Running,
every pod Ready, nothing on an unhealthy node, and the resource tree equal
to a fault-free twin run of the same workload. Rescued packed gangs are
verified — via actual placements — to have rejoined their survivors'
topology domain (the packing kernel's recovery-pin path).

``resource_signature`` is the placement-free shape of a converged tree
that the durability round trip (``sim/recovery.py``) judges too. The
federation and partition runners (``FederationChaosRunner``,
``PartitionChaosRunner``) drive ``federation/router.FederationRouter``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from grove_tpu_torch.analysis.sanitize import accountant_drift, stranded_holds
from grove_tpu_torch.analysis import sanitize
from grove_tpu_torch.api.load import load_podcliquesets
from grove_tpu_torch.api.meta import deep_copy, get_condition
from grove_tpu_torch.api.pod import is_ready
from grove_tpu_torch.api.types import COND_PODGANG_SCHEDULED, PHASE_RUNNING
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.runtime.errors import GroveError
from grove_tpu_torch.sim.cluster import NODE_LOST, NODE_READY
from grove_tpu_torch.sim.harness import SimHarness

# Workload shapes (chaos_workload): pods are sized so a 3-pod packed gang
# spans 3 distinct hosts of ONE ici-block (cpu 5 of 8 → one pod per node) —
# crashing one host then exercises the recovery-pin delta-solve, visibly.
_PLAIN_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: plain
spec:
  replicas: 1
  template:
    disruptionBudget:
      maxUnavailableGangs: 1
    cliques:
      - name: worker
        spec:
          roleName: worker
          replicas: 3
          minAvailable: 2
          podSpec:
            containers:
              - name: w
                image: busybox:stable
                resources:
                  requests:
                    cpu: 2
"""

_PACKED_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: packed
spec:
  replicas: 1
  template:
    topologyConstraint:
      packDomain: ici-block
    cliques:
      - name: worker
        spec:
          roleName: worker
          replicas: 3
          minAvailable: 2
          podSpec:
            containers:
              - name: w
                image: busybox:stable
                resources:
                  requests:
                    cpu: 5
"""

_STRICT_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: strict
spec:
  replicas: 1
  template:
    cliques:
      - name: worker
        spec:
          roleName: worker
          replicas: 2
          podSpec:
            containers:
              - name: w
                image: busybox:stable
                resources:
                  requests:
                    cpu: 3
"""
# minAvailable intentionally omitted in strict: defaulting pins it to
# replicas, so ANY pod loss breaches the floor → gang-terminate + requeue.

_SHAPES = {
    "plain": load_podcliquesets(_PLAIN_YAML)[0],
    "packed": load_podcliquesets(_PACKED_YAML)[0],
    "strict": load_podcliquesets(_STRICT_YAML)[0],
}


def chaos_workload(n_each: int = 2) -> List:
    """n_each PodCliqueSets of every shape (plain / packed / strict)."""
    out = []
    for shape, base in sorted(_SHAPES.items()):
        for i in range(n_each):
            pcs = deep_copy(base)
            pcs.metadata.name = f"{shape}-{i:02d}"
            out.append(pcs)
    return out


@dataclass
class Fault:
    at: float  # virtual seconds after the steady-state snapshot
    kind: str  # crash | restart | outage_begin | outage_end
    target: str = ""  # node name for crash/restart
    note: str = ""

    def as_dict(self) -> dict:
        return {
            "at": round(self.at, 2),
            "kind": self.kind,
            "target": self.target,
            "note": self.note,
        }


@dataclass
class ChaosReport:
    seed: int
    ticks: int = 0
    faults: List[dict] = field(default_factory=list)
    node_losses: int = 0
    flaps: int = 0
    rescues: List[dict] = field(default_factory=list)
    requeues: int = 0
    drain_evictions: int = 0
    drains_completed: int = 0
    failovers: int = 0
    scheduler_errors: int = 0
    invariant_violations: List[str] = field(default_factory=list)
    converged: bool = False
    signature_matches_fault_free: bool = False
    pin_verified_rescues: int = 0
    # controlplane_crash mode (docs/robustness.md durability section):
    # crash-restart recoveries performed, WAL records replayed, whether a
    # torn tail was truncated, and the unacked records the crash lost
    recoveries: int = 0
    require_recoveries: int = 0
    replayed_records: int = 0
    torn_tails: int = 0
    lost_unacked_records: int = 0
    recovery_wall_seconds: float = 0.0
    # flight-recorder bundles dumped during the run (one per invariant
    # violation burst, docs/observability.md "Flight recorder") — the
    # postmortem evidence a failing matrix seed ships with its verdict
    flight_bundles: List[str] = field(default_factory=list)
    # remediator-armed mode: ledger entries written while the remediation
    # controller ran live through the fault schedule (executed + skipped)
    remediator_armed: bool = False
    remediations_executed: int = 0
    remediations_skipped: int = 0
    # worker_crash fault (process executor only): reconcile-worker
    # processes SIGKILLed mid-round and repatriated by the coordinator
    # (runtime/procworkers.py); scheduled only when the process drain is
    # armed, and then REQUIRED to have fired
    worker_crashes: int = 0
    require_worker_crashes: int = 0
    # failslow fault (gray failure, docs/robustness.md): a node's
    # heartbeats run late without ever crossing the binary NotReady
    # grace — the suspicion EWMA must flip it Degraded (masked from new
    # placements, running gangs untouched) and back after the heal
    failslow_degraded: int = 0
    failslow_recovered: int = 0
    require_failslow: int = 0

    @property
    def ok(self) -> bool:
        return (
            not self.invariant_violations
            and self.converged
            and self.signature_matches_fault_free
            and self.node_losses >= 2
            and self.flaps >= 1
            and self.requeues >= 1
            and self.pin_verified_rescues >= 1
            and self.drain_evictions >= 1
            and self.drains_completed >= 1
            and self.failovers >= 1
            and self.recoveries >= self.require_recoveries
            and self.worker_crashes >= self.require_worker_crashes
            and self.failslow_degraded >= self.require_failslow
            and self.failslow_recovered >= self.require_failslow
        )

    def as_dict(self) -> dict:
        return {
            "seed": self.seed,
            "ticks": self.ticks,
            "faults": self.faults,
            "node_losses": self.node_losses,
            "flaps": self.flaps,
            "rescues": len(self.rescues),
            "pin_verified_rescues": self.pin_verified_rescues,
            "requeues": self.requeues,
            "drain_evictions": self.drain_evictions,
            "drains_completed": self.drains_completed,
            "failovers": self.failovers,
            "recoveries": self.recoveries,
            "replayed_records": self.replayed_records,
            "torn_tails": self.torn_tails,
            "lost_unacked_records": self.lost_unacked_records,
            "recovery_wall_seconds": round(self.recovery_wall_seconds, 4),
            "scheduler_errors": self.scheduler_errors,
            "invariant_violations": self.invariant_violations,
            "flight_bundles": self.flight_bundles,
            "remediator_armed": self.remediator_armed,
            "remediations_executed": self.remediations_executed,
            "remediations_skipped": self.remediations_skipped,
            "worker_crashes": self.worker_crashes,
            "failslow_degraded": self.failslow_degraded,
            "failslow_recovered": self.failslow_recovered,
            "converged": self.converged,
            "signature_matches_fault_free": self.signature_matches_fault_free,
            "ok": self.ok,
        }


def resource_signature(store) -> List[tuple]:
    """Placement-free shape of the converged resource tree: gangs with
    phase + per-group (size, floor), cliques with replica/ready counts.
    Node assignments are deliberately EXCLUDED — a post-failure cluster
    legitimately places elsewhere; what must match a fault-free run is the
    tree itself."""
    sig: List[tuple] = []
    for gang in sorted(
        store.scan("PodGang"),
        key=lambda g: (g.metadata.namespace, g.metadata.name),
    ):
        groups = tuple(
            sorted(
                (g.name, len(g.pod_references), g.min_replicas)
                for g in gang.spec.pod_groups
            )
        )
        sig.append(
            (
                "pg",
                gang.metadata.namespace,
                gang.metadata.name,
                gang.status.phase,
                groups,
            )
        )
    for pclq in sorted(
        store.scan("PodClique"),
        key=lambda c: (c.metadata.namespace, c.metadata.name),
    ):
        sig.append(
            (
                "pclq",
                pclq.metadata.namespace,
                pclq.metadata.name,
                pclq.status.replicas,
                pclq.status.ready_replicas,
            )
        )
    return sig


class ChaosRunner:
    """One seeded chaos run over a fresh SimHarness."""

    def __init__(
        self,
        seed: int = 1234,
        num_nodes: int = 16,
        n_each: int = 2,
        tick_seconds: float = 1.0,
        not_ready_after: float = 5.0,
        lost_after: float = 15.0,
        controlplane_crash: bool = False,
        durability_dir: Optional[str] = None,
        remediator: bool = False,
        failslow: bool = False,
        device=None,
    ) -> None:
        from grove_tpu_torch.utils.platform import resolve_device

        # resolved first: without a device and without CUDA nothing is built
        self.device = resolve_device(device)
        self.seed = seed
        # failslow: arm the gray-failure arm — suspicion EWMA on the
        # monitor, a seeded fail-slow node in the schedule, Degraded →
        # heal → Ready required by the verdict
        self.failslow = failslow
        self.failslow_threshold = 1.5
        self.failslow_recover = 0.75
        self.num_nodes = num_nodes
        self.n_each = n_each
        self.tick_seconds = tick_seconds
        self.not_ready_after = not_ready_after
        self.lost_after = lost_after
        # controlplane_crash: run the store durably (WAL + snapshots) and
        # kill store+engine mid-convergence — recovery must rebuild the
        # control plane from disk (docs/robustness.md durability section)
        self.controlplane_crash = controlplane_crash
        # remediator-armed mode (docs/observability.md "Remediation &
        # ledger"): the SLO observatory + remediation controller run live
        # through the WHOLE fault schedule — every action it takes must
        # keep the chaos invariants (budget invariant 4 above all) green
        self.remediator_armed = remediator
        self._own_durability_dir = controlplane_crash and durability_dir is None
        if self._own_durability_dir:
            import tempfile

            durability_dir = tempfile.mkdtemp(prefix="grove-chaos-wal-")
        self.durability_dir = durability_dir
        self.harness = self._build_harness(durable=controlplane_crash)
        self.report = ChaosReport(
            seed=seed,
            require_recoveries=1 if controlplane_crash else 0,
            require_failslow=1 if failslow else 0,
        )
        self._breach_since: Dict[Tuple[str, str], float] = {}
        self._outage_ops = ("create", "update")
        # flight recorder (observability/flightrec.py): armed for the
        # chaotic run so every invariant violation ships its postmortem
        # bundle with the verdict. Test hook: a rel-time at which one
        # clearly-labeled synthetic violation is injected, exercising the
        # dump path end to end without breaking a real invariant.
        self.flight_recorder = True
        self.inject_invariant_failure_at: Optional[float] = None
        self._injected_failure_done = False
        # rescue archives of deposed leaders (the monitor is leader memory;
        # a failover swaps it — completed-rescue records must survive for
        # the report's pin verification)
        self._archived_rescues: List[dict] = []

    def _build_harness(self, durable: bool = False) -> SimHarness:
        h = SimHarness(
            num_nodes=self.num_nodes,
            durability_dir=self.durability_dir if durable else None,
            device=self.device,
        )
        if h.durability is not None:
            # chaos-sized knobs: force segment rotation AND a mid-run
            # snapshot+truncation, so recovery replays a snapshot base
            # plus a multi-segment tail — under fire, not just in units
            h.durability.wal.segment_max_bytes = 64 * 1024
            h.durability.snapshot_every_bytes = 256 * 1024
        h.node_monitor.not_ready_after = self.not_ready_after
        h.node_monitor.lost_after = self.lost_after
        if self.failslow:
            self._arm_failslow_monitor(h.node_monitor)
        for pcs in chaos_workload(self.n_each):
            h.apply(pcs)
        return h

    def _arm_failslow_monitor(self, monitor) -> None:
        """Turn the suspicion EWMA on with chaos-speed thresholds: the
        injected lag band sits BELOW the binary NotReady grace, so only
        this detector can see the sick node."""
        monitor.failslow_threshold = self.failslow_threshold
        monitor.failslow_recover = self.failslow_recover

    # -- schedule construction -------------------------------------------

    def _node_of_one_pod(self, prefix: str, exclude: set) -> Optional[str]:
        """A node hosting exactly one pod of a `prefix-*` gang whose gang
        has survivors elsewhere — the cleanest rescue target. Falls back to
        any node hosting a pod of that shape."""
        per_node: Dict[str, int] = {}
        candidates: List[str] = []
        h = self.harness
        for (ns, pod_name), node in sorted(h.cluster.bindings.items()):
            if pod_name.startswith(prefix) and node not in exclude:
                per_node[node] = per_node.get(node, 0) + 1
        for node, count in sorted(per_node.items()):
            if count == 1:
                candidates.append(node)
        return (candidates or sorted(per_node) or [None])[0]

    def build_schedule(self, rng: random.Random) -> List[Fault]:
        """Deterministic fault schedule against the converged steady state:
        two real node losses (one hitting a packed gang → rescue via
        recovery pin; one hitting a strict gang → gang requeue), one flap,
        one transient store outage. Times jittered from the seed; targets
        resolved from the (deterministic) steady-state placement."""
        used: set = set()
        loss1 = self._node_of_one_pod("packed-", used)
        used.add(loss1)
        loss2 = self._node_of_one_pod("strict-", used)
        used.add(loss2)
        flap = self._node_of_one_pod("plain-", used) or self._node_of_one_pod(
            "packed-", used
        )
        used.add(flap)
        assert loss1 and loss2 and flap, "steady state left shapes unplaced"
        dead_dwell = self.lost_after + 6.0  # comfortably past the grace
        faults = [
            Fault(rng.uniform(1, 3), "crash", loss1, "loss→rescue (packed)"),
            Fault(
                rng.uniform(4, 6), "crash", loss2, "loss→requeue (strict)"
            ),
            Fault(rng.uniform(7, 9), "crash", flap, "flap begin"),
        ]
        # the flap restarts inside the grace window (NotReady, never Lost)
        flap_start = faults[2].at
        faults.append(
            Fault(
                flap_start
                + self.not_ready_after
                + rng.uniform(1.0, self.lost_after - self.not_ready_after - 2.0),
                "restart",
                flap,
                "flap end (inside grace)",
            )
        )
        # transient store outage while recovery is in flight
        outage_at = rng.uniform(10, 14)
        faults.append(Fault(outage_at, "outage_begin", note="store outage"))
        faults.append(
            Fault(outage_at + rng.uniform(2.0, 4.0), "outage_end")
        )
        # voluntary disruption: drain a node hosting a BUDGETED (plain)
        # gang after the outage has cleared — cordon, budget-checked
        # gang-whole eviction with trial-solve pre-placement
        drain = self._node_of_one_pod("plain-", used)
        assert drain, "no drainable node hosts a plain pod"
        used.add(drain)
        drain_at = rng.uniform(18.5, 19.5)
        faults.append(
            Fault(drain_at, "drain", drain, "voluntary drain (budgeted)")
        )
        # kill the leader mid-drain: the standby takes the lease, rebuilds
        # leader memory from the store (requeue_all, rebuild_bindings,
        # monitor resync, persisted NodeDrain intents) and finishes the job
        faults.append(
            Fault(
                drain_at + rng.uniform(0.5, 1.5),
                "leader_crash",
                note="failover mid-drain",
            )
        )
        # worker-process executor armed (GROVE_TPU_CP_BACKEND=process):
        # SIGKILL a reconcile worker while the late re-admission burst is
        # in flight — the coordinator must repatriate its shards and
        # re-execute its keys inline, deterministically (never hang).
        # Scheduled AFTER the leader crash: failover swaps the engine,
        # and a kill armed on the deposed drain would be torn down unfired
        if hasattr(self.harness.engine.workers, "chaos_kill_worker"):
            self.report.require_worker_crashes = 1
            faults.append(
                Fault(
                    dead_dwell + rng.uniform(1.0, 2.0),
                    "worker_crash",
                    note="SIGKILL reconcile worker mid-round (process"
                    " executor); repatriate + inline re-execution",
                )
            )
        # lost nodes come back late — capacity returns, requeued gangs must
        # re-admit atomically
        for i, node in enumerate((loss1, loss2)):
            faults.append(
                Fault(
                    dead_dwell + rng.uniform(0, 3) + 2 * i,
                    "restart",
                    node,
                    "capacity returns",
                )
            )
        if self.controlplane_crash:
            # kill store+engine after capacity returned, while re-admission
            # is still converging: recovery must rebuild the whole control
            # plane from the WAL/snapshot (torn tail injected at the crash)
            # and the rehydrated holds/backoff must finish the job
            faults.append(
                Fault(
                    dead_dwell + rng.uniform(5.2, 5.8),
                    "controlplane_crash",
                    note="store+engine crash, recover from disk",
                )
            )
        # the drained node rejoins the pool once everything else is back
        faults.append(
            Fault(
                dead_dwell + rng.uniform(6.0, 8.0),
                "uncordon",
                drain,
                "drained node returns to service",
            )
        )
        if self.failslow:
            # gray failure: a FOURTH node goes fail-slow mid-run — late
            # heartbeats inside the NotReady grace (binary detector
            # blind), healed only after everything else recovered. Drawn
            # last so the unarmed schedule keeps its exact rng sequence.
            gray = self._node_of_one_pod(
                "packed-", used
            ) or self._node_of_one_pod("plain-", used)
            assert gray, "no candidate node for the fail-slow fault"
            used.add(gray)
            faults.append(
                Fault(
                    rng.uniform(11, 13),
                    "failslow_begin",
                    gray,
                    "gray failure: heartbeats late, below binary grace",
                )
            )
            faults.append(
                Fault(
                    dead_dwell + rng.uniform(9.0, 10.0),
                    "failslow_end",
                    gray,
                    "fail-slow healed (suspicion must decay to Ready)",
                )
            )
        faults.sort(key=lambda f: f.at)
        return faults

    def _apply_fault(self, fault: Fault) -> None:
        h = self.harness
        if fault.kind == "crash":
            h.cluster.crash_node(fault.target)
        elif fault.kind == "restart":
            h.cluster.restart_node(fault.target)
        elif fault.kind == "outage_begin":

            def inject(_obj):
                return GroveError(
                    "ERR_STORE_OUTAGE", "injected transient outage", "write"
                )

            for op in self._outage_ops:
                h.store.error_injectors[op] = inject
        elif fault.kind == "outage_end":
            for op in self._outage_ops:
                h.store.error_injectors.pop(op, None)
        elif fault.kind == "drain":
            h.drainer.request_drain(fault.target)
        elif fault.kind == "uncordon":
            h.drainer.uncordon(fault.target)
        elif fault.kind == "leader_crash":
            self._leader_failover()
        elif fault.kind == "controlplane_crash":
            self._controlplane_crash()
        elif fault.kind == "worker_crash":
            self._worker_crash()
        elif fault.kind == "failslow_begin":
            # lag band strictly below not_ready_after=5.0: the binary
            # detector must stay blind for the arm to prove anything
            h.cluster.inject_failslow(
                fault.target,
                seed=self.seed,
                lag_min=2.0,
                lag_max=4.5,
                start_penalty=10.0,
            )
        elif fault.kind == "failslow_end":
            h.cluster.heal_failslow(fault.target)
        self.report.faults.append(fault.as_dict())

    def _worker_crash(self) -> None:
        """Arm the process executor's chaos hook: the reconcile worker
        owning the workload shard is SIGKILLed right after the next batch
        is dispatched to it (runtime/procworkers.py `chaos_kill_worker`).
        Thread-backend and serial control planes have no worker process
        to kill — the fault degrades to a no-op there, and the schedule
        only requires a crash when the process drain is armed."""
        h = self.harness
        drain = h.engine.workers
        if drain is None or not hasattr(drain, "chaos_kill_worker"):
            return
        # the chaos workload lives in one namespace, so its shard's owner
        # is the worker guaranteed to receive batches; lane 0 is the
        # coordinator itself (no process), so fall back to worker 1
        victim = drain.worker_of(h.store.shard_index("default"))
        drain.chaos_kill_worker = victim if victim != 0 else 1
        # the kill fires at the next batch DISPATCHED to the victim — a
        # quiet engine would never give it one. Storm the queue first:
        # requeue_all is a level-triggered re-list (semantically a no-op
        # for idempotent controllers), so this tick's drain is guaranteed
        # to have a round in flight for the SIGKILL to land mid-round
        h.engine.requeue_all()

    # -- control-plane crash (tentpole: durability + recovery) -------------

    def _controlplane_crash(self) -> None:
        """Kill the store process itself — the one fault the leader
        failover cannot model (there the store survives; here NOTHING in memory
        does). The WAL's unflushed buffer dies with the process and the
        interrupted write leaves a torn frame on disk. Recovery: rebuild
        the store from snapshot + WAL tail (truncate at the first bad
        CRC), audit the acked prefix (no acked commit lost, no phantom
        state), then cold-boot a full control plane over it with the
        failover's resync machinery (requeue_all / rebuild_bindings / monitor
        resync / fresh broker+drainer). Node kubelets are separate
        processes — the Node objects carry over with their live state."""
        from grove_tpu_torch.durability import recover_store, verify_acked_prefix

        h = self.harness
        report = self.report
        self._archived_rescues.extend(h.node_monitor.rescues)
        h.engine.close()
        report.lost_unacked_records += h.durability.simulate_crash(
            torn_tail_bytes=41
        )
        store, recovery = recover_store(
            self.durability_dir, clock=h.clock, cache_lag=True
        )
        report.replayed_records += recovery.replayed_records
        report.recovery_wall_seconds += recovery.wall_seconds
        if recovery.torn_tail:
            report.torn_tails += 1
        # recovery invariant 6: the recovered store IS the durable prefix —
        # audited independently against the on-disk log, before any new
        # commit can blur the comparison
        for problem in verify_acked_prefix(self.durability_dir, store):
            report.invariant_violations.append(f"recovery: {problem}")
        restarted = SimHarness.cold_restart(
            store,
            h.cluster.nodes,
            config=h.config,
            durability_dir=self.durability_dir,
            device=self.device,
        )
        restarted.durability.wal.segment_max_bytes = 64 * 1024
        restarted.durability.snapshot_every_bytes = 256 * 1024
        restarted.node_monitor.not_ready_after = self.not_ready_after
        restarted.node_monitor.lost_after = self.lost_after
        if self.failslow:
            self._arm_failslow_monitor(restarted.node_monitor)
        # an armed fail-slow fault is node state: it rides through the
        # control-plane crash onto the rebuilt SimCluster
        for name in sorted(h.cluster.failslow_names()):
            restarted.cluster.inject_failslow(
                name, *h.cluster.failslow_spec(name)
            )
        # the rebuilt monitor re-primes holds from persisted conditions
        # with the chaos-speed grace windows in place
        restarted.node_monitor.resync()
        if self.remediator_armed:
            # the recovered control plane comes up with a fresh (disabled)
            # remediator — re-arm it; the ledger itself is process-global
            # and survives the crash (it is observability, not leader state)
            self._arm_remediator(restarted)
        self.harness = restarted
        report.recoveries += 1

    # -- leader failover (satellite: leader_crash fault kind) -------------

    def _leader_failover(self) -> None:
        """Crash the leader and promote a standby through the REAL
        LeaseElector protocol, then rebuild every piece of leader memory
        the way cluster/manager.py's run loop does on takeover: fresh
        engine (+ requeue_all), fresh binding map (rebuild_bindings),
        fresh monitor re-primed from persisted conditions (resync), fresh
        scheduler/broker/drainer. Cluster INFRASTRUCTURE — the Node
        objects and the store — carries over; leader memory does not."""
        import time as _time

        from grove_tpu_torch.autoscale.hpa import HorizontalAutoscaler
        from grove_tpu_torch.cluster.lease import LeaseElector
        from grove_tpu_torch.controller.nodehealth import NodeHealthMonitor
        from grove_tpu_torch.controller.register import register_controllers
        from grove_tpu_torch.disruption import (
            DisruptionBroker,
            NodeDrainController,
        )
        from grove_tpu_torch.runtime.engine import Engine
        from grove_tpu_torch.sim.cluster import SimCluster
        from grove_tpu_torch.solver.scheduler import GangScheduler

        h = self.harness
        timings = dict(
            lease_duration=0.3, renew_deadline=0.2, retry_period=0.05
        )
        leader = LeaseElector(
            h.store, identity="chaos-leader", **timings
        )
        assert leader.try_acquire(), "incumbent failed to take the lease"
        leader.stop_renewing()  # crash: the lease ages out un-renewed
        standby = LeaseElector(
            h.store, identity="chaos-standby", **timings
        )
        deadline = _time.monotonic() + 15.0
        while not standby.try_acquire():
            assert (
                _time.monotonic() < deadline
            ), "standby never took over the lease"
            # grovelint: disable=GL001 -- real wall-clock wait: the LeaseElector protocol ages the lease on real time (cluster/lease.py is wall-clock by design); bounded by the deadline above
            _time.sleep(0.05)

        # deposed leader's engine stops draining; the standby builds fresh
        h.engine.close()
        engine = Engine(h.store, h.clock)
        register_controllers(engine, h.ctx, h.config)
        engine.requeue_all()
        cluster = SimCluster(store=h.store, nodes=h.cluster.nodes)
        cluster.rebuild_bindings()
        # fail-slow is NODE state, not leader memory — an armed gray
        # fault must survive the SimCluster rebuild (through the public
        # accessors, not the registry itself)
        for name in sorted(h.cluster.failslow_names()):
            cluster.inject_failslow(name, *h.cluster.failslow_spec(name))
        scheduler = GangScheduler(
            h.store,
            cluster,
            h.topology,
            priority_map=h.config.solver.priority_classes,
            chunk_size=min(h.config.solver.chunk_size, 64),
            max_waves=h.config.solver.max_waves,
            device=self.device,
        )
        monitor = NodeHealthMonitor(
            h.store,
            cluster,
            not_ready_after=self.not_ready_after,
            lost_after=self.lost_after,
        )
        if self.failslow:
            self._arm_failslow_monitor(monitor)
        scheduler.monitor = monitor
        broker = DisruptionBroker(h.store)
        scheduler.broker = broker
        h.ctx.disruption = broker
        drainer = NodeDrainController(
            h.store, cluster, scheduler, monitor, broker
        )
        monitor.drain_states = drainer.states
        monitor.resync()
        self._archived_rescues.extend(h.node_monitor.rescues)
        h.engine = engine
        h.cluster = cluster
        h.scheduler = scheduler
        h.node_monitor = monitor
        h.disruption = broker
        h.drainer = drainer
        h.autoscaler = HorizontalAutoscaler(
            h.store, h.metrics_provider, scale_down_stabilization=60.0
        )
        # remediator + its explain engine are leader memory over the
        # swapped components — rebuild both (policy config carries over;
        # cooldowns/pending effect windows die with the deposed leader)
        self._rebuild_remediator(h)
        self.report.failovers += 1

    def _rebuild_remediator(self, h: SimHarness) -> None:
        """Fresh explain engine + remediation controller over the current
        component set, re-armed with the chaos policy if this run has the
        remediator armed (harness-built ones start disabled)."""
        from grove_tpu_torch.controller.remediate import RemediationController
        from grove_tpu_torch.observability.explain import ExplainEngine

        h.explain = ExplainEngine(h.scheduler)
        h.remediator = RemediationController(
            h.store,
            h.cluster,
            h.scheduler,
            h.drainer,
            h.disruption,
            h.autoscaler,
            h.explain,
        )
        if self.remediator_armed:
            self._arm_remediator(h)

    def _arm_remediator(self, h: SimHarness) -> None:
        """Chaos-speed remediation policy: tight cooldown (the whole run
        is ~1 virtual minute), fragmentation trigger live, effects
        measured against the ready_fraction budget."""
        h.remediator.enable(
            effect_slo="ready_fraction",
            effect_window=10.0,
            cooldown=5.0,
            frag_threshold=0.6,
        )

    # -- invariants -------------------------------------------------------

    def _check_invariants(self, rel_now: float) -> None:
        try:
            self._check_invariants_inner(rel_now)
        finally:
            self._flight_record_violations(rel_now)

    def _flight_record_violations(self, rel_now: float) -> None:
        """Dump a flight-recorder bundle when this tick's invariant sweep
        grew the violation list (the test hook injects one synthetic,
        clearly-labeled violation so the dump path itself is exercised
        without breaking a real invariant)."""
        violations = self.report.invariant_violations
        if (
            self.inject_invariant_failure_at is not None
            and not self._injected_failure_done
            and rel_now >= self.inject_invariant_failure_at
        ):
            self._injected_failure_done = True
            violations.append(
                f"t={rel_now:.0f}s: INJECTED invariant failure"
                " (flight-recorder test hook, not a real breach)"
            )
        n_seen = getattr(self, "_violations_recorded", 0)
        if len(violations) > n_seen:
            self._violations_recorded = len(violations)
            from grove_tpu_torch.observability.flightrec import FLIGHTREC

            if FLIGHTREC.enabled:
                bundle = FLIGHTREC.trigger(
                    "chaos-invariant", violations[n_seen]
                )
                if bundle is not None:
                    self.report.flight_bundles.append(bundle)

    def _check_invariants_inner(self, rel_now: float) -> None:
        h = self.harness
        violations = self.report.invariant_violations
        # 1. no binding to a Lost node
        lost = {n.name for n in h.cluster.nodes if n.state == NODE_LOST}
        for (ns, pod_name), node in sorted(h.cluster.bindings.items()):
            if node in lost:
                violations.append(
                    f"t={rel_now:.0f}s: pod {ns}/{pod_name} still bound to "
                    f"lost node {node}"
                )
        # 2. no scheduled gang below its floor past the grace window
        now = h.clock.now()
        slack = self.lost_after + 4 * self.tick_seconds
        for gang in h.store.scan("PodGang"):
            key = (gang.metadata.namespace, gang.metadata.name)
            cond = get_condition(
                gang.status.conditions, COND_PODGANG_SCHEDULED
            )
            if cond is None or not cond.is_true():
                self._breach_since.pop(key, None)
                continue
            below = any(
                sum(
                    1
                    for ref in group.pod_references
                    if (ref.namespace, ref.name) in h.cluster.bindings
                )
                < group.min_replicas
                for group in gang.spec.pod_groups
            )
            if not below:
                self._breach_since.pop(key, None)
                continue
            since = self._breach_since.setdefault(key, now)
            if now - since > slack:
                violations.append(
                    f"t={rel_now:.0f}s: scheduled gang {key[0]}/{key[1]} "
                    f"below MinReplicas for {now - since:.0f}s "
                    f"(> grace {slack:.0f}s)"
                )
        # 3a. incremental quota accounting equals a full recount (the
        # tick-boundary exactness check shared with the sanitizer)
        for problem in accountant_drift(
            h.scheduler.quota.accountant, h.store
        ):
            violations.append(f"t={rel_now:.0f}s: {problem}")
        # 3b. no node is committed beyond its capacity
        used = h.cluster._used_by_node()
        for node in h.cluster.nodes:
            for r, v in used.get(node.name, {}).items():
                if v > node.capacity.get(r, 0.0) + 1e-6:
                    violations.append(
                        f"t={rel_now:.0f}s: node {node.name} overcommitted "
                        f"on {r}: {v} > {node.capacity.get(r, 0.0)}"
                    )
        # 4. no disruptionBudget ever exceeded (voluntary disruptions only)
        for pcs in h.store.scan("PodCliqueSet"):
            budget = pcs.spec.template.disruption_budget
            if budget is None:
                continue
            key = (pcs.metadata.namespace, pcs.metadata.name)
            disrupted = h.disruption.voluntarily_disrupted_gangs(key)
            cap = budget.max_unavailable_gangs or 0
            if disrupted > cap:
                violations.append(
                    f"t={rel_now:.0f}s: PCS {key[0]}/{key[1]} has "
                    f"{disrupted} voluntarily-disrupted gang(s), budget "
                    f"allows {cap}"
                )
        # 5. no stranded hold: every monitor-held gang keeps a scheduled
        # release (a hold with no delayed workqueue entry waits forever —
        # same check the sanitizer reruns at teardown)
        for problem in stranded_holds(h.node_monitor):
            violations.append(f"t={rel_now:.0f}s: {problem}")
        # 7. no phantom binding after a recovery: every binding the
        # scheduler charges capacity for must be backed by a committed
        # pod actually scheduled to that node (a recovery that resurrected
        # leader memory without store backing would overcommit silently)
        if self.report.recoveries:
            from grove_tpu_torch.api.pod import is_scheduled

            for (ns, pod_name), node in sorted(h.cluster.bindings.items()):
                pod = h.store.get("Pod", ns, pod_name, readonly=True)
                if pod is None or not is_scheduled(pod) or (
                    pod.status.node_name != node
                ):
                    violations.append(
                        f"t={rel_now:.0f}s: phantom binding after recovery:"
                        f" pod {ns}/{pod_name} charged to {node} without a"
                        " matching committed binding"
                    )

    def _remediation_tick(self, h: SimHarness) -> int:
        """One observatory round + one policy round, in harness order:
        sample → judge burns → remediate on THIS tick's verdicts."""
        from grove_tpu_torch.observability.slo import SLO
        from grove_tpu_torch.observability.timeseries import TIMESERIES

        TIMESERIES.sample(h.clock.now())
        SLO.evaluate(h.clock.now())
        return self._guarded(h.remediator.tick)

    def _guarded(self, fn) -> int:
        """Run one control-plane component; a transient store error models
        that component's process crash-looping (it retries next tick)."""
        try:
            return fn() or 0
        except GroveError:
            self.report.scheduler_errors += 1
            return 1  # counted as work: the loop must keep ticking

    # -- run ---------------------------------------------------------------

    def run(self, max_ticks: int = 400) -> ChaosReport:
        h = self.harness
        rng = random.Random(self.seed)
        report = self.report
        losses_before = METRICS.counters.get("node_lost_total", 0)
        flaps_before = METRICS.counters.get("node_flaps_total", 0)
        requeues_before = METRICS.counters.get("gang_requeues_total", 0)
        drains_before = METRICS.counters.get("gang_drains_total", 0)
        drains_done_before = METRICS.counters.get(
            "node_drains_completed_total", 0
        )
        wcrashes_before = METRICS.counters.get("cp_worker_crashes_total", 0)
        degraded_before = METRICS.counters.get("node_degraded_total", 0)
        recovered_before = METRICS.counters.get("node_recovered_total", 0)

        # fault-free twin FIRST (same workload, converged, untouched): the
        # convergence target the chaotic run must reproduce
        twin = self._build_harness()
        twin.converge(max_ticks=120)
        twin_sig = resource_signature(twin.store)
        # building a SimHarness re-points the process-global EVENTS/TRACER
        # clocks ("newest harness wins"); the chaotic run is the one whose
        # event timestamps must stay live — point them back
        from grove_tpu_torch.observability.events import EVENTS
        from grove_tpu_torch.observability.tracing import TRACER

        EVENTS.clock = h.clock
        TRACER.clock = h.clock
        if self.flight_recorder:
            # arm the postmortem rings for the CHAOTIC run only (the twin
            # above is the reference, not the subject); every invariant
            # violation below ships its bundle via _flight_record_violations
            from grove_tpu_torch.observability.flightrec import FLIGHTREC

            import os as _os

            FLIGHTREC.enable(
                num_shards=getattr(h.store, "num_shards", 1),
                clock=h.clock,
                out_dir=_os.environ.get("GROVE_TPU_FLIGHTREC_DIR") or None,
            )

        h.converge(max_ticks=120)  # steady state before the first fault
        if self.remediator_armed:
            # arm the detect→act loop for the CHAOTIC run only, from the
            # steady state on: observatory sampling + burn judging run in
            # the manual tick loop below, remediation actions flow through
            # the same broker/drainer/autoscaler the invariants police
            from grove_tpu_torch.observability.ledger import LEDGER
            from grove_tpu_torch.observability.slo import SLO
            from grove_tpu_torch.observability.timeseries import TIMESERIES
            from grove_tpu_torch.sim.traffic import default_slos

            report.remediator_armed = True
            TIMESERIES.reset()
            SLO.reset()
            LEDGER.reset()
            TIMESERIES.enable(clock=h.clock)
            SLO.enable()
            for text in default_slos():
                SLO.add(text)
            LEDGER.enable(clock=h.clock)
            self._arm_remediator(h)
        t0 = h.clock.now()
        faults = self.build_schedule(rng)
        i = 0
        idle_ticks = 0
        for _tick in range(max_ticks):
            # refetch every tick: a controlplane_crash fault swaps the
            # WHOLE harness (store included) for the recovered one
            h = self.harness
            rel = h.clock.now() - t0
            while i < len(faults) and faults[i].at <= rel:
                self._apply_fault(faults[i])
                i += 1
                h = self.harness
            work = self._guarded(h.engine.drain)
            work += self._guarded(h.autoscaler.tick)
            work += self._guarded(h.node_monitor.tick)
            work += self._guarded(h.drainer.tick)
            bound = self._guarded(h.schedule)
            started = self._guarded(h.cluster.kubelet_tick)
            work += self._guarded(h.engine.drain)
            if self.remediator_armed:
                work += self._remediation_tick(h)
            if h.durability is not None:
                # group commit at the tick boundary (the sim committer)
                h.durability.pump()
            self._check_invariants(rel)
            report.ticks += 1
            if i >= len(faults) and not work and not bound and not started:
                idle_ticks += 1
                wakes = [
                    w
                    for w in (
                        h.engine.next_wakeup(),
                        h.autoscaler.next_deadline(),
                        h.node_monitor.next_deadline(),
                        h.drainer.next_deadline(),
                        h.remediator.next_deadline(),
                    )
                    if w is not None
                ]
                wake = min(wakes) if wakes else None
                if wake is not None and wake - h.clock.now() <= 120.0:
                    h.clock.advance(max(wake - h.clock.now(), 0.0))
                    continue
                if idle_ticks >= 2:
                    break
            else:
                idle_ticks = 0
            # never jump past the next scheduled fault
            step = self.tick_seconds
            if i < len(faults):
                step = min(step, max(faults[i].at - rel, 1e-3))
            h.clock.advance(step)

        report.node_losses = int(
            METRICS.counters.get("node_lost_total", 0) - losses_before
        )
        report.flaps = int(
            METRICS.counters.get("node_flaps_total", 0) - flaps_before
        )
        report.requeues = int(
            METRICS.counters.get("gang_requeues_total", 0) - requeues_before
        )
        report.drain_evictions = int(
            METRICS.counters.get("gang_drains_total", 0) - drains_before
        )
        report.drains_completed = int(
            METRICS.counters.get("node_drains_completed_total", 0)
            - drains_done_before
        )
        report.worker_crashes = int(
            METRICS.counters.get("cp_worker_crashes_total", 0)
            - wcrashes_before
        )
        report.failslow_degraded = int(
            METRICS.counters.get("node_degraded_total", 0) - degraded_before
        )
        report.failslow_recovered = int(
            METRICS.counters.get("node_recovered_total", 0)
            - recovered_before
        )
        report.rescues = self._archived_rescues + list(h.node_monitor.rescues)
        report.pin_verified_rescues = sum(
            1 for r in report.rescues if r.get("rejoined_domain")
        )

        # convergence: every gang Running, every pod Ready, every node back
        pods = h.store.list("Pod")
        gangs = h.store.scan("PodGang")
        unhealthy = {
            n.name for n in h.cluster.nodes if n.state != NODE_READY
        }
        report.converged = (
            bool(pods)
            and all(is_ready(p) for p in pods)
            and all(g.status.phase == PHASE_RUNNING for g in gangs)
            and not any(
                p.status.node_name in unhealthy for p in pods
            )
        )
        report.signature_matches_fault_free = (
            resource_signature(h.store) == twin_sig
        )
        # sanitizer teardown sweep (GROVE_TPU_SANITIZE=1): lock-order
        # inversions, leaked spans, stranded holds, accountant drift, and
        # the store's byte-compare guard — recorded as invariant
        # violations so the smoke's verdict covers them
        if sanitize.active():
            report.invariant_violations.extend(
                f"sanitizer: {p}" for p in sanitize.harness_problems(h)
            )
        if self.remediator_armed:
            # tally the causal chains, then disarm the process-global
            # layers (same discipline as the flight recorder below)
            from grove_tpu_torch.observability.ledger import LEDGER
            from grove_tpu_torch.observability.slo import SLO
            from grove_tpu_torch.observability.timeseries import TIMESERIES

            report.remediations_executed = len(
                LEDGER.entries(outcome="executed")
            )
            report.remediations_skipped = len(
                LEDGER.entries(outcome="skipped")
            )
            h.remediator.disable()
            LEDGER.disable()
            SLO.disable()
            TIMESERIES.disable()
        if self.flight_recorder:
            # disarm the process-global recorder (dumped bundles stay on
            # disk; the report carries their paths) so later runs/tests in
            # this process aren't silently recording
            from grove_tpu_torch.observability.flightrec import FLIGHTREC

            FLIGHTREC.disable()
        if h.durability is not None:
            h.durability.close()
        if self._own_durability_dir:
            import shutil

            shutil.rmtree(self.durability_dir, ignore_errors=True)
        return report


def run_chaos(
    seed: int = 1234,
    num_nodes: int = 16,
    n_each: int = 2,
    max_ticks: int = 400,
    controlplane_crash: bool = False,
    remediator: bool = False,
    failslow: bool = False,
    device=None,
) -> ChaosReport:
    """One seeded end-to-end chaos run."""
    return ChaosRunner(
        seed=seed,
        num_nodes=num_nodes,
        n_each=n_each,
        controlplane_crash=controlplane_crash,
        remediator=remediator,
        failslow=failslow,
        device=device,
    ).run(max_ticks=max_ticks)


def chaos_artifact(seed: int = 1234, device=None) -> dict:
    """Compact chaos block for the integrated bench artifact."""
    report = run_chaos(seed=seed, device=device)
    doc = report.as_dict()
    doc.pop("faults", None)
    doc.pop("invariant_violations", None)
    doc["invariant_violation_count"] = len(report.invariant_violations)
    return doc


# -- federation chaos (docs/federation.md "cluster_crash") -------------------


@dataclass
class FederationChaosReport:
    """Verdict of one seeded federation chaos run: a whole REGION is
    killed mid-traffic and later restored, with the router's re-route
    machinery under the per-tick invariants below."""

    seed: int
    regions: int = 0
    ticks: int = 0
    faults: List[dict] = field(default_factory=list)
    applied: int = 0
    cluster_crashes: int = 0
    rejoins: int = 0
    reroutes: int = 0
    spillovers: int = 0
    stranded: int = 0
    invariant_checks: int = 0
    invariant_violations: List[str] = field(default_factory=list)
    converged: bool = False

    @property
    def ok(self) -> bool:
        return (
            not self.invariant_violations
            and self.converged
            and self.cluster_crashes >= 1
            and self.rejoins >= 1
            and self.reroutes >= 1
            and self.stranded == 0
        )

    def as_dict(self) -> dict:
        return {
            "seed": self.seed,
            "regions": self.regions,
            "ticks": self.ticks,
            "faults": self.faults,
            "applied": self.applied,
            "cluster_crashes": self.cluster_crashes,
            "rejoins": self.rejoins,
            "reroutes": self.reroutes,
            "spillovers": self.spillovers,
            "stranded": self.stranded,
            "invariant_checks": self.invariant_checks,
            "invariant_violations": self.invariant_violations,
            "converged": self.converged,
            "ok": self.ok,
        }


class FederationChaosRunner:
    """One seeded chaos run over a fresh FederationRouter.

    The fault schedule is the `cluster_crash` fault: a second traffic
    wave lands, the busiest region is killed while that wave is still
    converging (genuinely mid-traffic), the survivors absorb the
    re-routes under the ordinary broker/budget machinery, and a later
    `cluster_rejoin` restores the region with a fresh control plane
    (a post-rejoin wave homed there proves it serves again). Two
    federation-specific per-tick invariants ride on top of the
    single-cluster set (quota drift, disruption budgets):

    F1. no gang is placed in — and no placement record points at — a
        dead cluster (a Lost region's harness is gone entirely);
    F2. the global quota fold's root equals the sum of independent
        per-cluster usage recounts (the level-3 analogue of the
        accountant-vs-oracle exactness check).
    """

    def __init__(
        self,
        seed: int = 1234,
        regions: int = 3,
        num_nodes: int = 8,
        n_each: int = 2,
        spill_after: float = 5.0,
        device=None,
    ) -> None:
        from grove_tpu_torch.federation import FederationRouter

        self.seed = seed
        self.n_each = n_each
        self.region_names = [f"region-{i}" for i in range(regions)]
        self.rng = random.Random(seed ^ 0xFEDE)
        self.router = FederationRouter(
            self.region_names,
            num_nodes=num_nodes,
            phase_offsets=[i * 200.0 for i in range(regions)],
            spill_after=spill_after,
            device=device,
        )
        self.report = FederationChaosReport(seed=seed, regions=regions)

    # -- invariants ------------------------------------------------------

    def _check_invariants(self, t0: float) -> None:
        router = self.router
        rep = self.report
        rep.invariant_checks += 1
        rel_now = router.clock.now() - t0
        violations = rep.invariant_violations
        states = {cl.region: cl for cl in router.clusters()}
        # F1: no placement in a dead cluster; Lost regions hold no
        # harness (nothing CAN be bound there), and every placement's
        # PCS actually lives in its recorded Ready region
        for (ns, name), region in sorted(router.placements().items()):
            cl = states.get(region)
            if cl is None or cl.state != "Ready" or cl.harness is None:
                violations.append(
                    f"t={rel_now:.0f}s: placement {ns}/{name} points at"
                    f" dead cluster {region}"
                )
                continue
            if cl.harness.store.get("PodCliqueSet", ns, name) is None:
                violations.append(
                    f"t={rel_now:.0f}s: placement {ns}/{name} missing"
                    f" from cluster {region}'s store"
                )
        for cl in router.clusters():
            if cl.state == "Lost" and cl.harness is not None:
                violations.append(
                    f"t={rel_now:.0f}s: lost cluster {cl.region} still"
                    " holds a live harness"
                )
        # F2: the global fold's root equals the sum of independent
        # per-cluster recounts (usage_oracle over each store's pods) —
        # and each cluster's own accountant has no local drift either
        from grove_tpu_torch.quota.oracle import usage_oracle

        recount: dict = {}
        for cl in router.clusters():
            if cl.harness is None:
                continue
            h = cl.harness
            for problem in accountant_drift(
                h.scheduler.quota.accountant, h.store
            ):
                violations.append(
                    f"t={rel_now:.0f}s: [{cl.region}] {problem}"
                )
            oracle = usage_oracle(
                h.store.scan("Pod"),
                h.scheduler.quota.accountant.default_queue,
            )
            for q, usage in oracle.items():
                row = recount.setdefault(q, {})
                for r, v in usage.items():
                    row[r] = row.get(r, 0.0) + v
        global_usage = router.global_usage()
        for q in sorted(set(global_usage) | set(recount)):
            a = global_usage.get(q, {})
            b = recount.get(q, {})
            for r in sorted(set(a) | set(b)):
                if abs(a.get(r, 0.0) - b.get(r, 0.0)) > 1e-6:
                    violations.append(
                        f"t={rel_now:.0f}s: global fold queue {q}"
                        f" usage {r}: root {a.get(r, 0.0)} != sum of"
                        f" per-cluster recounts {b.get(r, 0.0)}"
                    )
        # per-cluster disruption budgets (chaos invariant 4, unchanged:
        # a crash re-route must never spend voluntary disruption)
        for cl in router.clusters():
            if cl.harness is None:
                continue
            h = cl.harness
            for pcs in h.store.scan("PodCliqueSet"):
                budget = pcs.spec.template.disruption_budget
                if budget is None:
                    continue
                key = (pcs.metadata.namespace, pcs.metadata.name)
                disrupted = h.disruption.voluntarily_disrupted_gangs(key)
                cap = budget.max_unavailable_gangs or 0
                if disrupted > cap:
                    violations.append(
                        f"t={rel_now:.0f}s: [{cl.region}] PCS"
                        f" {key[0]}/{key[1]} has {disrupted}"
                        f" voluntarily-disrupted gang(s), budget"
                        f" allows {cap}"
                    )

    def _all_scheduled(self) -> bool:
        for cl in self.router.clusters():
            if cl.harness is None:
                continue
            for gang in cl.harness.store.list("PodGang"):
                cond = get_condition(
                    gang.status.conditions, COND_PODGANG_SCHEDULED
                )
                if cond is None or not cond.is_true():
                    return False
        return True

    def _apply_wave(self, suffix: str, home: Optional[str] = None) -> None:
        from grove_tpu_torch.api import names as namegen

        for pcs in chaos_workload(n_each=self.n_each):
            if suffix:
                pcs.metadata.name = f"{pcs.metadata.name}{suffix}"
            pcs.metadata.labels[namegen.LABEL_FEDERATION_HOME] = (
                home if home is not None else self.rng.choice(
                    self.region_names
                )
            )
            self.router.apply(pcs)
            self.report.applied += 1

    # -- the run ---------------------------------------------------------

    def run(self, max_ticks: int = 400) -> FederationChaosReport:
        router = self.router
        rep = self.report
        t0 = router.clock.now()
        budget = max_ticks
        # wave 1: steady state across seeded homes
        self._apply_wave("")
        rep.ticks += router.converge(max_ticks=min(60, budget))
        self._check_invariants(t0)
        # wave 2 lands, then the busiest region dies MID-convergence
        self._apply_wave("-w2")
        rep.ticks += router.converge(max_ticks=3, tick_seconds=1.0)
        counts = {name: 0 for name in self.region_names}
        for region in router.placements().values():
            counts[region] += 1
        victim = max(
            self.region_names, key=lambda name: (counts[name], name)
        )
        rep.faults.append(
            Fault(
                at=router.clock.now() - t0,
                kind="cluster_crash",
                target=victim,
                note=f"{counts[victim]} placements",
            ).as_dict()
        )
        crash = router.crash_cluster(victim)
        rep.cluster_crashes += 1
        rep.stranded += len(crash["stranded"])
        rep.ticks += router.converge(max_ticks=min(120, budget))
        self._check_invariants(t0)
        # late restart: fresh control plane, then traffic homed there
        rep.faults.append(
            Fault(
                at=router.clock.now() - t0,
                kind="cluster_rejoin",
                target=victim,
            ).as_dict()
        )
        router.rejoin_cluster(victim)
        rep.rejoins += 1
        rep.ticks += router.converge(max_ticks=40)
        self._check_invariants(t0)
        self._apply_wave("-late", home=victim)
        rep.ticks += router.converge(max_ticks=min(160, budget))
        self._check_invariants(t0)
        rep.reroutes = router.reroutes
        rep.spillovers = router.spillovers
        rep.converged = self._all_scheduled()
        return rep


def run_federation_chaos(
    seed: int = 1234,
    regions: int = 3,
    num_nodes: int = 8,
    n_each: int = 2,
    max_ticks: int = 400,
    device=None,
) -> FederationChaosReport:
    """One seeded federation chaos run."""
    return FederationChaosRunner(
        seed=seed, regions=regions, num_nodes=num_nodes, n_each=n_each,
        device=device,
    ).run(max_ticks=max_ticks)


# -- partition chaos (docs/robustness.md "Gray failures") --------------------


@dataclass
class PartitionChaosReport:
    """Verdict of one seeded partition chaos run: a region becomes
    UNREACHABLE (its control plane stays alive and converging — the
    gray cousin of `cluster_crash`), pending work spills, the region
    heals, and the split-brain invariant F3 is policed every tick."""

    seed: int
    regions: int = 0
    ticks: int = 0
    faults: List[dict] = field(default_factory=list)
    applied: int = 0
    partitions: int = 0
    heals: int = 0
    partition_spills: int = 0
    placements_kept: int = 0
    placements_in_partition: int = 0
    invariant_checks: int = 0
    invariant_violations: List[str] = field(default_factory=list)
    converged: bool = False

    @property
    def ok(self) -> bool:
        return (
            not self.invariant_violations
            and self.converged
            and self.partitions >= 1
            and self.heals >= 1
            and self.partition_spills >= 1
            # every gang Scheduled inside the partition kept its
            # placement across the heal (partition ≠ crash: nothing
            # fails over that was already placed)
            and self.placements_in_partition >= 1
            and self.placements_kept == self.placements_in_partition
        )

    def as_dict(self) -> dict:
        return {
            "seed": self.seed,
            "regions": self.regions,
            "ticks": self.ticks,
            "faults": self.faults,
            "applied": self.applied,
            "partitions": self.partitions,
            "heals": self.heals,
            "partition_spills": self.partition_spills,
            "placements_kept": self.placements_kept,
            "placements_in_partition": self.placements_in_partition,
            "invariant_checks": self.invariant_checks,
            "invariant_violations": self.invariant_violations,
            "converged": self.converged,
            "ok": self.ok,
        }


class PartitionChaosRunner:
    """One seeded chaos run exercising `cluster_partition` — the fault
    `cluster_crash` is NOT: the region's control plane keeps running
    (its harness converges on the shared clock the whole time), only
    the router's view of it goes dark. A second traffic wave is caught
    mid-convergence by the partition, so the victim region holds BOTH
    Scheduled gangs (which must stay bound — partition ≠ crash) and
    still-pending gangs (which the router spills after the suspicion
    timeout). On heal, the router deletes its own spilled copies from
    the rejoined region and the split-brain invariant must have held
    throughout:

    F3. no PodGang is ever Scheduled in two clusters across a
        partition/heal cycle — checked per tick by scanning EVERY
        harness (including the partitioned one; it is alive, that is
        the point) for PCSes whose gangs are Scheduled in more than
        one region at once.

    The federation F1 invariant ("placements point at Ready clusters")
    deliberately does NOT ride along: a placement staying in a
    Partitioned region is the CORRECT outcome here, not a violation.
    """

    def __init__(
        self,
        seed: int = 1234,
        regions: int = 3,
        num_nodes: int = 8,
        n_each: int = 2,
        spill_after: float = 5.0,
        partition_suspect_after: float = 5.0,
        device=None,
    ) -> None:
        from grove_tpu_torch.federation import FederationRouter

        self.seed = seed
        self.n_each = n_each
        self.region_names = [f"region-{i}" for i in range(regions)]
        self.rng = random.Random(seed ^ 0x9A47)
        self.router = FederationRouter(
            self.region_names,
            num_nodes=num_nodes,
            phase_offsets=[i * 200.0 for i in range(regions)],
            spill_after=spill_after,
            partition_suspect_after=partition_suspect_after,
            device=device,
        )
        self.report = PartitionChaosReport(seed=seed, regions=regions)

    # -- invariants ------------------------------------------------------

    def _scheduled_regions(self) -> Dict[Tuple[str, str], Set[str]]:
        """PCS key -> regions where at least one of its gangs is
        currently Scheduled, over EVERY live harness (reachable or
        not — the partitioned control plane is alive and counts)."""
        from grove_tpu_torch.api import names as namegen

        where: Dict[Tuple[str, str], Set[str]] = {}
        for cl in self.router.clusters():
            if cl.harness is None:
                continue
            for gang in cl.harness.store.scan("PodGang"):
                cond = get_condition(
                    gang.status.conditions, COND_PODGANG_SCHEDULED
                )
                if cond is None or not cond.is_true():
                    continue
                pcs_name = gang.metadata.labels.get(namegen.LABEL_PART_OF)
                if not pcs_name:
                    continue
                where.setdefault(
                    (gang.metadata.namespace, pcs_name), set()
                ).add(cl.region)
        return where

    def _check_invariants(self, t0: float) -> None:
        router = self.router
        rep = self.report
        rep.invariant_checks += 1
        rel_now = router.clock.now() - t0
        violations = rep.invariant_violations
        # F3: split-brain — a PCS with Scheduled gangs in two regions
        for key, regions in sorted(self._scheduled_regions().items()):
            if len(regions) > 1:
                violations.append(
                    f"t={rel_now:.0f}s: F3 split-brain — PCS"
                    f" {key[0]}/{key[1]} Scheduled in"
                    f" {sorted(regions)}"
                )
        # the global quota fold only folds reachable Ready regions —
        # it must equal the sum of recounts over exactly that set
        from grove_tpu_torch.quota.oracle import usage_oracle

        recount: dict = {}
        for cl in router.clusters():
            if (
                cl.harness is None
                or cl.state != "Ready"
                or not cl.reachable
            ):
                continue
            oracle = usage_oracle(
                cl.harness.store.scan("Pod"),
                cl.harness.scheduler.quota.accountant.default_queue,
            )
            for q, usage in oracle.items():
                row = recount.setdefault(q, {})
                for r, v in usage.items():
                    row[r] = row.get(r, 0.0) + v
        global_usage = router.global_usage()
        for q in sorted(set(global_usage) | set(recount)):
            a = global_usage.get(q, {})
            b = recount.get(q, {})
            for r in sorted(set(a) | set(b)):
                if abs(a.get(r, 0.0) - b.get(r, 0.0)) > 1e-6:
                    violations.append(
                        f"t={rel_now:.0f}s: global fold queue {q}"
                        f" usage {r}: root {a.get(r, 0.0)} != sum over"
                        f" reachable clusters {b.get(r, 0.0)}"
                    )

    def _all_scheduled(self) -> bool:
        for cl in self.router.clusters():
            if cl.harness is None:
                continue
            for gang in cl.harness.store.list("PodGang"):
                cond = get_condition(
                    gang.status.conditions, COND_PODGANG_SCHEDULED
                )
                if cond is None or not cond.is_true():
                    return False
        return True

    def _apply_wave(self, suffix: str, home: Optional[str] = None) -> None:
        from grove_tpu_torch.api import names as namegen

        for pcs in chaos_workload(n_each=self.n_each):
            if suffix:
                pcs.metadata.name = f"{pcs.metadata.name}{suffix}"
            pcs.metadata.labels[namegen.LABEL_FEDERATION_HOME] = (
                home if home is not None else self.rng.choice(
                    self.region_names
                )
            )
            self.router.apply(pcs)
            self.report.applied += 1

    # -- the run ---------------------------------------------------------

    def run(self, max_ticks: int = 400) -> PartitionChaosReport:
        router = self.router
        rep = self.report
        t0 = router.clock.now()
        budget = max_ticks
        # wave 1: steady state across seeded homes
        self._apply_wave("")
        rep.ticks += router.converge(max_ticks=min(60, budget))
        self._check_invariants(t0)
        # the busiest wave-1 region is the victim; wave 2 is homed
        # there and the partition lands in the same instant — before a
        # single converge tick — so the victim holds wave-1 gangs
        # Scheduled AND wave-2 gangs still pending (the split the spill
        # walk must honor: pending spills, Scheduled never moves)
        counts = {name: 0 for name in self.region_names}
        for region in router.placements().values():
            counts[region] += 1
        victim = max(
            self.region_names, key=lambda name: (counts[name], name)
        )
        self._apply_wave("-w2", home=victim)
        bound_before = {
            key: regions
            for key, regions in self._scheduled_regions().items()
            if victim in regions
        }
        rep.placements_in_partition = len(bound_before)
        rep.faults.append(
            Fault(
                at=router.clock.now() - t0,
                kind="cluster_partition",
                target=victim,
                note=(
                    f"{counts[victim]} placements,"
                    f" {len(bound_before)} Scheduled inside"
                ),
            ).as_dict()
        )
        assert router.partition_cluster(victim)
        # converge in short slices so the per-tick F3 scan brackets the
        # suspicion flip, the spill walk, and the fenced dwell
        for _ in range(6):
            rep.ticks += router.converge(max_ticks=10)
            self._check_invariants(t0)
        # heal: reachable again, stale spilled copies deleted, fence up
        rep.faults.append(
            Fault(
                at=router.clock.now() - t0,
                kind="cluster_heal",
                target=victim,
            ).as_dict()
        )
        assert router.heal_cluster(victim)
        rep.ticks += router.converge(max_ticks=min(120, budget))
        self._check_invariants(t0)
        # a late wave homed at the healed region proves it serves again
        self._apply_wave("-late", home=victim)
        rep.ticks += router.converge(max_ticks=min(160, budget))
        self._check_invariants(t0)
        after = self._scheduled_regions()
        rep.placements_kept = sum(
            1
            for key, regions in bound_before.items()
            if victim in after.get(key, set())
        )
        row = next(
            cl for cl in router.clusters() if cl.region == victim
        )
        rep.partitions = row.partitions
        rep.partition_spills = router.partition_spills
        rep.heals = 1 if row.reachable and row.state == "Ready" else 0
        rep.converged = self._all_scheduled()
        return rep


def run_partition_chaos(
    seed: int = 1234,
    regions: int = 3,
    num_nodes: int = 8,
    n_each: int = 2,
    max_ticks: int = 400,
    device=None,
) -> PartitionChaosReport:
    """One seeded partition chaos run."""
    return PartitionChaosRunner(
        seed=seed, regions=regions, num_nodes=num_nodes, n_each=n_each,
        device=device,
    ).run(max_ticks=max_ticks)
