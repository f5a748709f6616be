"""Operator runtime for real-cluster mode.

Counterpart of ``grove_tpu/cluster/manager.py``, with the same names and
keywords plus ``device``: ``start_operator`` assembles the apiserver
connection (``HttpStore``), the webhook server and its TLS certs, the
controllers, the solver-backed scheduler and the run loop, as the upstream
manager bootstrap (operator/internal/controller/manager.go:42-115) does.
Health, readiness and metrics are served by the embedded apiserver
(``/healthz``, ``/readyz``, ``/metrics``).

The scheduler solves on ``device``: the card unless the caller passes
another (``device="cpu"``, as the tests do). ``start_operator`` resolves it
before it boots anything, so without CUDA and without a device it raises
and leaves no server running; it never falls back to the CPU.

Leader election (manager.go:84-98) comes in two tiers:
  - **Lease-based** (`leader_election=True`): a coordination.k8s.io/v1
    Lease object on the apiserver, client-go protocol (cluster/lease.py) —
    works across hosts, the reference's HA deployment shape.
  - File lock (`leader_lock_path`): exclusive-create lockfile with
    mtime-staleness stealing — single shared filesystem only; kept for
    setups without an apiserver reachable at boot.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.cluster.apiserver import APIServer
from grove_tpu_torch.cluster.client import HttpStore
from grove_tpu_torch.cluster.webhook import WebhookServer
from grove_tpu_torch.controller.common import OperatorContext
from grove_tpu_torch.controller.register import register_controllers
from grove_tpu_torch.runtime.engine import Engine
from grove_tpu_torch.sim.cluster import Node, SimCluster
from grove_tpu_torch.solver.scheduler import GangScheduler


class FileLeaderLock:
    """Exclusive-create lockfile with liveness heartbeat (leader election
    stub; manager.go:84-98)."""

    def __init__(self, path: str, stale_after: float = 30.0) -> None:
        self.path = path
        self.stale_after = stale_after
        self.held = False

    def try_acquire(self) -> bool:
        try:
            fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            # steal stale locks (crashed leader with no heartbeat)
            try:
                if time.time() - os.path.getmtime(self.path) > self.stale_after:
                    os.unlink(self.path)
                    return self.try_acquire()
            except OSError:
                pass
            return False
        with os.fdopen(fd, "w") as f:
            f.write(str(os.getpid()))
        self.held = True
        return True

    def heartbeat(self) -> None:
        if self.held:
            os.utime(self.path, None)

    def release(self) -> None:
        if self.held:
            try:
                os.unlink(self.path)
            except OSError:
                pass
            self.held = False

    def acquire_blocking(self, poll: float = 0.5) -> None:
        while not self.try_acquire():
            time.sleep(poll)


@dataclass
class OperatorRuntime:
    """Assembled operator: store client + engine + scheduler over a cluster
    of nodes, against an embedded or external apiserver."""

    store: HttpStore
    engine: Engine
    scheduler: Optional[GangScheduler]
    cluster: Optional[SimCluster]
    apiserver: Optional[APIServer]
    webhooks: Optional[WebhookServer]
    leader_lock: Optional[FileLeaderLock] = None
    # lease-based election (cluster/lease.py): run() campaigns in standby,
    # a background thread renews while leading (decoupled from reconcile
    # round length), and run() re-enters standby on leadership loss
    elector: Optional[object] = None
    # deferred shared-state publication: with election enabled, only the
    # LEADER may create/reconcile the ClusterTopology CR — a standby that
    # booted with a different hierarchy must not overwrite the active
    # leader's published contract
    topology_publish: Optional[object] = None
    # real threaded reconciles (MaxConcurrentReconciles equivalent) — safe
    # here because the HttpStore/apiserver boundary is thread-safe
    threaded: bool = False
    # multi-level autoscaling (HPA controller equivalent, reference
    # components/hpa) — evaluated each control round like the kube HPA sync
    autoscaler: Optional[object] = None
    metrics_provider: Optional[object] = None
    # node-health monitor + voluntary-disruption layer (docs/robustness.md):
    # heartbeat lifecycle/gang recovery, the disruption broker every
    # voluntary evictor consults, and the drain workflow behind
    # POST /nodes/{name}/drain
    node_monitor: Optional[object] = None
    disruption: Optional[object] = None
    drainer: Optional[object] = None
    # durability attachment of the EMBEDDED apiserver's store (WAL +
    # snapshots + background committer; grove_tpu_torch/durability): set when
    # start_operator ran with durability_dir — shutdown() must stop the
    # committer and drain the final group commit
    durability: Optional[object] = None

    def _drain(self) -> int:
        if self.threaded:
            return self.engine.drain_concurrent()
        return self.engine.drain()

    def converge_once(self) -> int:
        """One control round: reconcile, autoscale, schedule, kubelet.
        Store conflicts in the autoscale/schedule passes are routine under
        concurrent writers (the HPA's read-modify-write isn't atomic over
        the wire) — they re-derive next round; the run loop must survive."""
        from grove_tpu_torch.runtime.errors import GroveError

        if self.elector is not None:
            # leadership is maintained by the elector's background renewer;
            # a deposed leader must not act (the standby that stole the
            # lease is already reconciling)
            if not self.elector.is_leader:
                return 0
        if self.topology_publish is not None:
            try:
                self.topology_publish()
            except GroveError:
                # apiserver blip at the takeover moment: keep the publish
                # pending and retry next round — the run loop must survive
                pass
            else:
                self.topology_publish = None
        work = self._drain()
        if self.autoscaler is not None:
            try:
                work += self.autoscaler.tick()
            except GroveError:
                pass  # conflicting writer; next tick re-reads
        if self.node_monitor is not None:
            try:
                work += self.node_monitor.tick()
            except GroveError:
                pass  # transient apiserver blip; level-triggered retry
        if self.drainer is not None:
            try:
                work += self.drainer.tick()
            except GroveError:
                pass  # intent is persisted; the drain resumes next round
        if self.scheduler is not None:
            try:
                work += self.scheduler.schedule_pending()
            except GroveError:
                pass  # conflict or sidecar outage; next round retries
        if self.cluster is not None:
            work += self.cluster.kubelet_tick()
        work += self._drain()
        # SLO observatory (observability/timeseries.py, slo.py): sampling
        # + objective evaluation at the round boundary, mirroring the sim
        # harness's tick-boundary feed — one boolean check while off
        # (arm with GROVE_TPU_TIMESERIES=1 GROVE_TPU_SLO=1; GET
        # /debug/slo and `cli slo` read the result)
        from grove_tpu_torch.observability.slo import SLO
        from grove_tpu_torch.observability.timeseries import TIMESERIES

        if TIMESERIES.enabled:
            now = self.store.clock.now()
            TIMESERIES.sample(now)
            SLO.evaluate(now)
        if self.leader_lock is not None:
            self.leader_lock.heartbeat()
        return work

    def run(self, stop: Optional[threading.Event] = None, poll: float = 0.2) -> None:
        stop = stop or threading.Event()
        try:
            while not stop.is_set():
                if self.elector is not None and not self.elector.is_leader:
                    # standby: campaign until leadership or stop, dropping
                    # queued watch events nobody will drain meanwhile
                    if not self.elector.acquire_blocking(
                        stop, on_wait=self.engine.discard_pending_events
                    ):
                        break
                    # fresh leader: full resync covers the dropped events,
                    # and the scheduler re-learns bindings made by the old
                    # leader (else node_free() over-commits occupied nodes)
                    self.engine.discard_pending_events()
                    self.engine.requeue_all()
                    if self.cluster is not None:
                        self.cluster.rebuild_bindings()
                    if self.node_monitor is not None:
                        # re-prime gang holds/backoff from persisted
                        # conditions: a failover landing mid-outage must
                        # neither strand a held gang (hold without a
                        # scheduled release) nor let every terminated gang
                        # churn the solver unpaced
                        self.node_monitor.resync()
                    continue
                if self.converge_once() == 0:
                    stop.wait(poll)
        finally:
            if self.elector is not None:
                self.elector.release()
            if self.leader_lock is not None:
                self.leader_lock.release()

    def shutdown(self) -> None:
        self.engine.close()
        self.store.stop()
        if self.durability is not None:
            self.durability.close()  # stop the committer, final flush
        if self.webhooks is not None:
            self.webhooks.stop()
        if self.apiserver is not None:
            self.apiserver.stop()
        if self.elector is not None:
            self.elector.release()
        if self.leader_lock is not None:
            self.leader_lock.release()


def start_operator(
    nodes: Optional[List[Node]] = None,
    topology: Optional[ClusterTopology] = None,
    config=None,
    with_webhooks: bool = True,
    with_tls: bool = False,
    with_authorizer: bool = False,
    with_scheduler: bool = True,
    # tri-state: None = default (single-threaded drain, unless
    # GROVE_TPU_CP_WORKERS maps onto threaded reconciles — see below);
    # an explicit True/False always wins over the env knob
    threaded: Optional[bool] = None,
    apiserver_url: Optional[str] = None,
    leader_lock_path: Optional[str] = None,
    leader_election: Optional[bool] = None,
    leader_identity: Optional[str] = None,
    metrics_provider=None,
    durability_dir: Optional[str] = None,
    device=None,
) -> OperatorRuntime:
    """Boot the full real-cluster operator (embedded apiserver unless
    `apiserver_url` points at an external one), mirroring main.go startup:
    config → topology check → certs → webhooks → controllers → run.

    `durability_dir` (embedded apiserver only): recover the store from
    the directory's snapshot + WAL tail before serving — a crash-restart
    then converges like a failover, via the same resync machinery the
    lease-takeover path runs (requeue_all / rebuild_bindings / monitor
    resync) — and attach the WAL with a background group-commit thread.

    `device`: where the scheduler solves (the card unless given; resolved
    first, so a missing card raises before anything boots)."""
    from grove_tpu_torch.config.operator import OperatorConfiguration
    from grove_tpu_torch.sim.cluster import make_nodes
    from grove_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)

    config = config or OperatorConfiguration()
    topology = topology or ClusterTopology()

    durability = None
    backing_store = None
    recovered_objects = 0
    if durability_dir is not None and apiserver_url is None:
        from grove_tpu_torch.durability import recover_store

        backing_store, recovery = recover_store(durability_dir)
        recovered_objects = recovery.restored_objects

    webhooks = None
    registrations = []
    if with_webhooks:
        certs = None
        if with_tls:
            from grove_tpu_torch.cluster.cert import ensure_certs

            certs = ensure_certs(
                os.path.join(tempfile.gettempdir(), "grove-tpu-webhook-certs")
            )
        guard = None
        if with_authorizer:
            from grove_tpu_torch.admission.authorization import AuthorizationGuard

            guard = AuthorizationGuard(
                enabled=True,
                exempt_users=config.authorizer.exempt_service_accounts,
            )
        webhooks = WebhookServer(
            topology=topology, guard=guard, certs=certs
        ).start()
        registrations = webhooks.registrations()

    apiserver = None
    if apiserver_url is None:
        apiserver = APIServer(
            store=backing_store,
            webhooks=registrations,
            enable_profiling=config.server.profiling_enabled,
        )
        if durability_dir is not None:
            from grove_tpu_torch.durability import StoreDurability

            # attach AFTER recovery, BEFORE the apiserver starts serving:
            # a commit from an early HTTP client must be logged too, or
            # its ack would not survive the next crash-restart; the
            # apiserver's request lock serializes snapshot scans against
            # concurrent handlers
            durability = StoreDurability(
                apiserver.store, durability_dir, lock=apiserver.lock
            )
            durability.start_committer()
        apiserver.start()
        apiserver_url = apiserver.address

    leader_lock = None
    if leader_lock_path:
        leader_lock = FileLeaderLock(leader_lock_path)
        leader_lock.acquire_blocking()

    store = HttpStore(apiserver_url).start()

    # SLO-observatory clock (observability/timeseries.py): ring ticks come
    # from the store's clock from the FIRST reconcile round — a journey
    # completing before the first sampling round must not stamp tick 0
    from grove_tpu_torch.observability.timeseries import TIMESERIES

    if TIMESERIES.enabled:
        TIMESERIES.clock = store.clock

    # materialize the hierarchy as a CR so wire clients can inspect what the
    # operator schedules against (the reference crashes when the configured
    # CR is missing, cmd/main.go validateClusterTopology; here the operator
    # OWNS the CR — incl. an auto-detected one — and publishes it)
    def publish_topology() -> None:
        from grove_tpu_torch.runtime.errors import ERR_CONFLICT, GroveError

        try:
            store.create(topology)
        except GroveError as exc:
            if exc.code != ERR_CONFLICT:
                raise
            # restart / external apiserver: the stored CR must match what
            # the operator actually schedules against — a stale hierarchy
            # (e.g. nodes relabeled before an --auto-detect-topology
            # restart) would make the published contract silently wrong
            stored = store.get("ClusterTopology", "", topology.metadata.name)
            if [(l.domain, l.key) for l in stored.spec.levels] != [
                (l.domain, l.key) for l in topology.spec.levels
            ]:
                stored.spec = topology.spec
                store.update(stored)

    if not topology.metadata.name:
        topology.metadata.name = "default"
    engine = Engine(store, store.clock)
    # parallel control plane (docs/control-plane.md §5): the env opt-in
    # (GROVE_TPU_CP_WORKERS) arms only over a SHARDED in-memory store —
    # cluster mode drains an HttpStore, where per-shard ownership cannot
    # be enforced across the wire. Map the same intent onto this tier's
    # concurrency model instead: MaxConcurrentReconciles-style threaded
    # reconciles (drain_concurrent), which the thread-safe apiserver
    # boundary already supports. An EXPLICIT threaded=True/False from the
    # caller always wins — the env knob names a deterministic feature,
    # so it must never silently override a caller who pinned the
    # single-threaded drain; only the unset (None) default maps.
    if threaded is None:
        from grove_tpu_torch.runtime.workers import workers_from_env

        threaded = engine.workers is None and workers_from_env() > 1
    ctx = OperatorContext(store=store, clock=store.clock, topology=topology)
    register_controllers(engine, ctx, config)
    if recovered_objects:
        # recovered state predates every watch: enqueue it all once — the
        # informer ListAndWatch-restart a fresh process performs (the same
        # resync a lease takeover runs; rebuild_bindings/monitor resync
        # below complete the machinery)
        engine.requeue_all()
    # with_scheduler=False leaves binding entirely to an EXTERNAL scheduler
    # consuming the PodGang contract over the wire (the reference's KAI
    # deployment shape — grove_tpu_torch.cluster.extscheduler is the stand-in)
    cluster = scheduler = node_monitor = disruption = drainer = None
    if with_scheduler:
        cluster = SimCluster(store=store, nodes=nodes or make_nodes(16))
        # restart path: account for pods a predecessor already bound (an
        # external apiserver outlives operator processes)
        cluster.rebuild_bindings()
        scheduler = GangScheduler(
            store,
            cluster,
            topology,
            priority_map=config.solver.priority_classes,
            chunk_size=min(config.solver.chunk_size, 64),
            max_waves=config.solver.max_waves,
            solver_sidecar=config.solver.sidecar_address or None,
            device=device,
        )
        # node-health + voluntary-disruption layer (docs/robustness.md):
        # same wiring shape as the sim harness
        from grove_tpu_torch.controller.nodehealth import NodeHealthMonitor
        from grove_tpu_torch.disruption import (
            DisruptionBroker,
            NodeDrainController,
        )

        node_monitor = NodeHealthMonitor(store, cluster)
        scheduler.monitor = node_monitor
        disruption = DisruptionBroker(store)
        scheduler.broker = disruption
        drainer = NodeDrainController(
            store, cluster, scheduler, node_monitor, disruption
        )
        node_monitor.drain_states = drainer.states
        node_monitor.resync()  # restart path: re-prime persisted requeues
        ctx.disruption = disruption  # rolling update consults it too
        if apiserver is not None:
            apiserver.node_provider = node_monitor.node_snapshot
            apiserver.drain_handler = drainer.request_drain
            apiserver.uncordon_handler = drainer.uncordon
            # decision explainability (docs/observability.md "Admission
            # explain"): GET /gangs/{ns}/{name}/explain, /debug/capacity,
            # POST /debug/whatif — read-only, so no lock coupling
            from grove_tpu_torch.observability.explain import ExplainEngine

            apiserver.explain_engine = ExplainEngine(scheduler)
    from grove_tpu_torch.autoscale.hpa import (
        HorizontalAutoscaler,
        StaticMetricsProvider,
    )

    # real deployments inject a provider backed by their metrics pipeline
    # (HPAs are inert without one — StaticMetricsProvider only serves what
    # tests/sims poke into it)
    metrics_provider = metrics_provider or StaticMetricsProvider()
    autoscaler = HorizontalAutoscaler(store, metrics_provider)
    elector = None
    elect = (
        leader_election
        if leader_election is not None
        else config.leader_election.enabled
    )
    if elect:
        from grove_tpu_torch.cluster.lease import LeaseElector

        le = config.leader_election
        elector = LeaseElector(
            store,
            name=le.resource_name,
            identity=leader_identity,
            lease_duration=le.lease_duration,
            renew_deadline=le.renew_deadline,
            retry_period=le.retry_period,
            background_renew=True,
        )
    else:
        # no election: this process is the only writer — publish now, the
        # startup-crash semantics of the reference's validateClusterTopology
        publish_topology()
    return OperatorRuntime(
        store=store,
        engine=engine,
        scheduler=scheduler,
        cluster=cluster,
        apiserver=apiserver,
        webhooks=webhooks,
        leader_lock=leader_lock,
        elector=elector,
        topology_publish=publish_topology if elect else None,
        threaded=threaded,
        autoscaler=autoscaler,
        metrics_provider=metrics_provider,
        node_monitor=node_monitor,
        disruption=disruption,
        drainer=drainer,
        durability=durability,
    )
