"""Solver-backed gang scheduler: the from-scratch admission round.

Counterpart of ``grove_tpu/solver/scheduler.py``. One round: the pending
scan, each pending gang's spec encoded from its PodGang, PodClique and Pod
objects, the quota ceiling holds and the DRF fair-share order (a CUDA scan,
``quota/ordering.py``), the batch solve (``solver/kernel.solve_waves``, whose
fills run the CUDA fill kernel), priority preemption and cross-queue quota
reclaim with their trial solves, binding, PodGang and Queue status writes,
and events. Solves and the ordering scan run on ``device`` (default: the
card; raises without one unless ``device="cpu"``).

``enable_delta()`` attaches the incremental delta-solve state
(``solver/deltastate.py``): the round then encodes from a free-capacity
matrix and a gang-spec cache folded from the store's watch events, skips the
solve when the solver input equals the last tick's (``_delta_last``), and
with ``delta_selfcheck`` holds every delta problem and solve to a
from-scratch one. Delta is opt-in on a bare scheduler, as in the JAX
package. ``enable_frontier()`` then attaches the partitioned frontier
(``solver/frontier.py``): the delta round solves its pending gangs as
per-slab subproblems stacked into batched dispatches, plus a global
residual pass, and with ``frontier_selfcheck`` holds every stacked lane to
a solo solve.

The round opens the JAX round's spans and observes its metrics, and with
the wall profiler (``observability/profile.py``) on it attributes its time
to the ``schedule`` (controller ``scheduler``), ``pending-scan``,
``encode``, ``solve`` and ``commit`` phases; with gang journeys
(``observability/journey.py``) on it stamps each gang's first scan, the
round's encode and solve walls, its commit and its Scheduled=True. Every
site costs one boolean check while off, and the round's results are the
same on and off.

With ``solver_sidecar`` (host:port) the batch solve goes over gRPC
(``cluster/grpcsolver.py``): the identical request, built from the round's
free-capacity dicts, answered by the sidecar and mapped back onto the
locally encoded problem's index space, so binding, preemption trials and
recovery pins do not care where the solve ran. A sidecar that fails solves
that batch in process, on the round's ``device``, and counts
``sidecar_fallbacks``; a per-request failure (DEADLINE_EXCEEDED,
RESOURCE_EXHAUSTED, INVALID_ARGUMENT) also skips the sidecar for
``sidecar_backoff_s``, a connectivity failure reattaches at the next round.
The frontier stays off with a sidecar.

``broker`` (``disruption/broker.DisruptionBroker``) gates every voluntary
eviction: resolved once a round (``_active_broker``), its ``would_allow``
keeps protected gangs out of the preemption and reclaim trials and its
``grant`` must pass a victim set before anything is evicted. ``monitor``
(``controller/nodehealth.NodeHealthMonitor``) holds requeued gangs out of
the encode (``gang_held``) until it releases them. Both stay None on a bare
scheduler, as in the JAX package (every eviction ungated, nothing held);
an un-armed broker is inert.

``speculate_encode`` is the overlap pump: the process drain calls it (as
the engine's ``overlap_hook``) while its workers reconcile, and it builds
the pending gangs' specs ahead of the next round into ``_overlap_cache``,
each under a staleness token (the namespace shard's emitted count, the
binding epoch, the monitor's hold epoch, the cordoned names).
``_encode_pending`` takes a speculated spec only while its token still
matches (``cp_overlap_hits_total``), else rebuilds it
(``cp_overlap_stale_total``), so a round is the same with the pump on or
off.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import Condition, clone_status, get_condition, set_condition
from grove_tpu_torch.api.pod import is_ready, is_scheduled, is_terminating
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.api.types import (
    COND_MIN_AVAILABLE_BREACHED,
    COND_PODGANG_DISRUPTION_TARGET,
    COND_PODGANG_SCHEDULED,
    COND_PODGANG_UNHEALTHY,
    PHASE_PENDING,
    PHASE_RUNNING,
    PHASE_STARTING,
    SPREAD_SCHEDULE_ANYWAY,
    QueueStatus,
)
from grove_tpu_torch.observability.events import (
    DETAIL_QUOTA_CEILING,
    EVENTS,
    REASON_GANG_ADMITTED,
    REASON_GANG_DEFERRED,
    REASON_POD_BOUND,
    REASON_PREEMPTED,
    REASON_QUEUE_PENDING,
    REASON_QUOTA_RECLAIM,
    TYPE_NORMAL,
    TYPE_WARNING,
)
from grove_tpu_torch.observability.journey import JOURNEYS
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.profile import PROFILER
from grove_tpu_torch.observability.tracing import TRACER
from grove_tpu_torch.quota.manager import QuotaManager, spec_demand
from grove_tpu_torch.quota.oracle import dominant_share_of
from grove_tpu_torch.runtime.errors import ERR_CONFLICT, ERR_NOT_FOUND, GroveError
from grove_tpu_torch.runtime.store import Store, commit_status
from grove_tpu_torch.sim.cluster import SimCluster
from grove_tpu_torch.solver.encode import StickyGroupPad, build_problem
from grove_tpu_torch.solver.introspect import classify_rejections
from grove_tpu_torch.solver.kernel import solve_waves
from grove_tpu_torch.utils.platform import resolve_device


class GangScheduler:
    """All-or-nothing, topology-aware binder over a SimCluster."""

    def __init__(
        self,
        store,
        cluster,
        topology: Optional[ClusterTopology] = None,
        priority_map: Optional[Dict[str, int]] = None,
        chunk_size: int = 32,
        max_waves: int = 16,
        solver_sidecar: Optional[str] = None,
        device=None,
    ) -> None:
        self.store = store
        self.cluster = cluster
        self.topology = topology or ClusterTopology()
        # priorityClassName -> numeric priority (higher schedules first)
        self.priority_map = priority_map or {}
        self.chunk_size = chunk_size
        self.max_waves = max_waves
        self.device = resolve_device(device)
        # the packing solve through a gRPC sidecar (host:port) instead of in
        # process: the boundary the reference's scheduler plugin puts KAI
        # behind
        self.solver_sidecar = solver_sidecar
        self._sidecar_client = None
        # per-solve gRPC deadline: past it the sidecar aborts the solve
        # (DEADLINE_EXCEEDED) and the batch is solved in process
        self.sidecar_timeout = 120.0
        # batches solved in process because the sidecar failed (the client
        # is rebuilt after each failure, so a restarted sidecar reattaches)
        self.sidecar_fallbacks = 0
        # a per-request failure is doomed on an identical retry: skip the
        # sidecar this long instead of re-sending the request every round
        self.sidecar_backoff_s = 60.0
        self._sidecar_skip_until = 0.0
        # sticky group-axis padding: grows to the widest template seen
        self._pad_groups = StickyGroupPad()
        # with no Queue CRs the quota subsystem is inert: the solve order
        # is the flat (-priority, name) sort
        self.quota = QuotaManager(store, device=self.device)
        # pods bound by the most recent _commit_admitted pass
        self._last_commit_bound = 0
        # the overlap pump's cache: (namespace, gang) -> (token, sorted pod
        # names, spec, pods_by_pclq); at most ``overlap_budget`` specs are
        # built per speculate_encode call
        self._overlap_cache: Dict[tuple, tuple] = {}
        self.overlap_budget = 32
        # incremental delta-solve state (solver/deltastate.py): None runs
        # the from-scratch round; enable_delta() attaches it
        self.delta = None
        # after every delta solve, re-derive the problem from scratch and
        # assert problem and admissions equal bit for bit (tests, the smoke)
        self.delta_selfcheck = False
        # seconds the self-check spent inside schedule_pending() since the
        # caller last reset this: latency reports subtract it
        self.last_selfcheck_seconds = 0.0
        # (fingerprint + solve options, result) of the last delta solve:
        # an equal key means identical solver input, and the solve is
        # skipped and its result reused
        self._delta_last = None
        # True while the most recent batch "solve" was such a reuse: gates
        # the gang_solve_seconds observation
        self._solve_reused = False
        # partitioned solver frontier (solver/frontier.py): None solves the
        # pending gangs globally; enable_frontier() attaches it (it needs the
        # delta state)
        self.frontier = None
        # after every partitioned solve, solve each subproblem alone and
        # assert the batched composite equal bit for bit (tests, the smoke)
        self.frontier_selfcheck = False
        # True while the most recent solve went through the frontier: the
        # delta A/B then pins the encode only, and the frontier self-check
        # owns the solve comparison
        self._frontier_solved = False
        # partition admission fence (federation/router.py): set by the
        # federation router when this region's lease expires mid-partition;
        # schedule_pending returns 0 while set. False (always, outside
        # federation faults) leaves the round as it was
        self.admission_fenced = False
        # disruption broker (disruption/broker.py): preemption and quota
        # reclaim must be granted their victim sets before evicting. None:
        # ungated; an un-armed broker (no budgets, no drains) is inert
        self.broker = None
        # node-health monitor (controller/nodehealth.py): gangs it holds in
        # requeue backoff stay out of the solve until released. None: no
        # holds
        self.monitor = None
        # shards whose pending_namespaces gauge was set last round (zeroed
        # when they drain)
        self._pending_ns_shards: set = set()
        # wall stamp of the round's encode end, set only while JOURNEYS is
        # on: splits encode from solve in the admission decomposition
        self._journey_encode_end = None

    def enable_delta(self) -> bool:
        """Attach the incremental delta-solve state. The port's in-memory
        store and simulated cluster only: the fold consumes the store's
        synchronous ``subscribe_system`` watch. Safe to call twice."""
        if self.delta is not None:
            return True
        if not isinstance(self.store, Store) or not isinstance(self.cluster, SimCluster):
            return False
        from grove_tpu_torch.solver.deltastate import DeltaSolveState

        self.delta = DeltaSolveState(self.store, self.cluster, self.topology)
        return True

    def enable_frontier(self) -> bool:
        """Attach the partitioned solver frontier (solver/frontier.py). Needs
        the delta state (the plan rides its cached NodeEncoding and
        maintained free matrix) and an in-process solver (the sidecar keeps
        the global solve). Safe to call twice."""
        if self.frontier is not None:
            return True
        if self.solver_sidecar is not None or not self.enable_delta():
            return False
        from grove_tpu_torch.solver.frontier import FrontierState

        self.frontier = FrontierState(self.topology)
        return True

    def _solve_batch_delta(self, nodes: List, gang_specs: List[dict]):
        """The delta round's solve: this tick's problem assembled from the
        dirty-masked cluster state (no bindings pass, no topology re-sort),
        and no solve at all when the solver input equals the last tick's
        (equal fingerprints give equal arrays, and the wave solve is
        deterministic). Returns (PackingResult, PackingProblem)."""
        prof = PROFILER.phase("encode") if PROFILER.enabled else None
        try:
            with TRACER.span(
                "solve.delta_encode", gangs=len(gang_specs), nodes=len(nodes)
            ) as span:
                problem, fingerprint = self.delta.encode(
                    nodes,
                    gang_specs,
                    pad_groups=self._pad_groups.grow(gang_specs),
                )
                span.set("reencoded", self.delta.last_reencoded)
        finally:
            if prof is not None:
                prof.end()
        if JOURNEYS.enabled:
            self._journey_encode_end = JOURNEYS.t()
        key = (fingerprint, self.chunk_size, self.max_waves)
        if self._delta_last is not None and self._delta_last[0] == key:
            self.delta.solve_reuses += 1
            METRICS.inc("delta_solve_reuses_total")
            # no solve ran this tick: the latency histogram must not
            # observe the cached result's solve_seconds again
            self._solve_reused = True
            return self._delta_last[1], problem
        self._frontier_solved = False
        if self.frontier is not None and self.solver_sidecar is None:
            # partitioned frontier: slab subproblems in batched dispatches
            # plus a global residual pass; None (one slab, or every gang
            # residual) falls through to the global solve below
            prof = PROFILER.phase("solve") if PROFILER.enabled else None
            try:
                result = self.frontier.solve(self, gang_specs, problem)
            finally:
                if prof is not None:
                    prof.end()
            if result is not None:
                self._solve_reused = False
                self._frontier_solved = True
                self._delta_last = (key, result)
                return result, problem
        # the sidecar's request is built from free-capacity dicts: serve them
        # from the kept matrix (an in-process solve takes the problem's
        # arrays and needs none)
        free = self.delta.free_dicts(nodes) if self.solver_sidecar is not None else None
        result, problem = self._solve_batch(nodes, gang_specs, free, problem=problem)
        self._delta_last = (key, result)
        return result, problem

    def _delta_ab_check(self, nodes, gang_specs, problem, result) -> None:
        """The A/B pin of ``delta_selfcheck``: re-derive the solver input
        from scratch (a full bindings pass, a full topology encode) and
        assert that the problem arrays and the solve's outcome equal the
        delta path's bit for bit. The full solve runs on ``self.device``."""
        from grove_tpu_torch.solver.deltastate import problems_identical

        t0 = time.perf_counter()
        free = self.cluster.node_free_all(nodes)
        full = build_problem(
            nodes,
            gang_specs,
            self.topology,
            free_capacity=free,
            pad_groups=self._pad_groups.grow(gang_specs),
        )
        mismatch = problems_identical(problem, full)
        if mismatch:
            raise AssertionError(
                f"delta-solve problem diverged from the from-scratch encode: {mismatch}"
            )
        if self._frontier_solved:
            # the frontier's result is its own (slab-confined placements):
            # this pins the encode, and the frontier self-check owns the
            # solve comparison
            self.last_selfcheck_seconds += time.perf_counter() - t0
            return
        full_result = solve_waves(
            full,
            chunk_size=self.chunk_size,
            max_waves=self.max_waves,
            with_alloc=True,
            device=self.device,
        )
        for field in ("admitted", "placed", "score", "chosen_level", "alloc"):
            a = getattr(result, field)
            b = getattr(full_result, field)
            if (a is None) != (b is None) or (
                a is not None and not np.array_equal(a, b)
            ):
                raise AssertionError(
                    f"delta-solve result diverged from the full solve on {field!r}"
                )
        self.last_selfcheck_seconds += time.perf_counter() - t0

    def _solve_batch(
        self,
        nodes: List,
        gang_specs: List[dict],
        free_capacity: Optional[Dict[str, Dict[str, float]]],
        with_alloc: bool = True,
        problem=None,
    ):
        """One batch solve against a free-capacity snapshot, in process or,
        with ``solver_sidecar`` set (and not backing off), through the
        sidecar. Returns (PackingResult, PackingProblem). ``problem``: an
        encode built already (the delta path); the from-scratch encode is
        then skipped and ``free_capacity`` only feeds the sidecar's
        request."""
        self._solve_reused = False  # a real solve runs
        if problem is None:
            prof = PROFILER.phase("encode") if PROFILER.enabled else None
            try:
                with TRACER.span("scheduler.encode", gangs=len(gang_specs), nodes=len(nodes)):
                    problem = build_problem(
                        nodes,
                        gang_specs,
                        self.topology,
                        free_capacity=free_capacity,
                        pad_groups=self._pad_groups.grow(gang_specs),
                    )
            finally:
                if prof is not None:
                    prof.end()
            if JOURNEYS.enabled:
                self._journey_encode_end = JOURNEYS.t()
        prof = PROFILER.phase("solve") if PROFILER.enabled else None
        try:
            if self.solver_sidecar is None or time.monotonic() < self._sidecar_skip_until:
                with TRACER.span("scheduler.solve", gangs=len(gang_specs), where="in-process"):
                    result = solve_waves(
                        problem,
                        chunk_size=self.chunk_size,
                        max_waves=self.max_waves,
                        with_alloc=with_alloc,
                        device=self.device,
                    )
                return result, problem
            with TRACER.span("scheduler.solve", gangs=len(gang_specs), where="sidecar"):
                return self._solve_remote(problem, nodes, gang_specs, free_capacity, with_alloc)
        finally:
            if prof is not None:
                prof.end()

    def _solve_remote(self, problem, nodes, gang_specs, free_capacity, with_alloc: bool):
        """The batch through the sidecar, mapped back onto ``problem``'s
        index space. The local encode still runs on this path: its name,
        level and group maps and the problem itself are what binding, trial
        usage and recovery pins read, and it is host numpy only."""
        import logging

        import grpc

        from grove_tpu_torch.cluster.grpcsolver import SolverClient, build_request
        from grove_tpu_torch.sim.cluster import Node
        from grove_tpu_torch.solver.types import PackingResult

        snapshot = [
            Node(
                name=n.name,
                capacity=dict(free_capacity.get(n.name, n.capacity)),
                labels=dict(n.labels),
            )
            for n in nodes
        ]
        request = build_request(snapshot, gang_specs, self.topology)
        request.options.chunk_size = self.chunk_size
        request.options.max_waves = self.max_waves
        request.options.stats_only = not with_alloc
        if self._sidecar_client is None:
            self._sidecar_client = SolverClient(self.solver_sidecar)
        try:
            response = self._sidecar_client.solve(request, timeout=self.sidecar_timeout)
        except grpc.RpcError as e:
            # a crashed, restarting or slow sidecar must never stall
            # admission: solve this batch in process, on the round's device,
            # and drop the client so a later round reattaches
            self._sidecar_client = None
            self.sidecar_fallbacks += 1
            code = e.code()
            log = logging.getLogger("grove_tpu_torch.solver")
            if code in (
                grpc.StatusCode.DEADLINE_EXCEEDED,
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                grpc.StatusCode.INVALID_ARGUMENT,
            ):
                # a per-request failure: the identical retry is doomed
                self._sidecar_skip_until = time.monotonic() + self.sidecar_backoff_s
                log.error(
                    "solver sidecar %s rejected the request (%s); solving in process"
                    " and skipping the sidecar for %.0fs (fallback #%d)",
                    self.solver_sidecar,
                    code,
                    self.sidecar_backoff_s,
                    self.sidecar_fallbacks,
                )
            else:
                log.warning(
                    "solver sidecar %s unavailable (%s); solved in process"
                    " (fallback #%d), will reattach",
                    self.solver_sidecar,
                    code,
                    self.sidecar_fallbacks,
                )
            result = solve_waves(
                problem,
                chunk_size=self.chunk_size,
                max_waves=self.max_waves,
                with_alloc=with_alloc,
                device=self.device,
            )
            return result, problem

        g = problem.num_gangs
        p_max = problem.max_groups
        n_nodes = problem.num_nodes
        node_index = {name: i for i, name in enumerate(problem.node_names)}
        admitted = np.zeros((g,), dtype=bool)
        score = np.zeros((g,), dtype=np.float32)
        chosen_level = np.full((g,), -1, dtype=np.int32)
        placed = np.zeros((g, p_max), dtype=np.int32)
        alloc = np.zeros((g, p_max, n_nodes), dtype=np.int32)
        level_index = {key: i for i, key in enumerate(problem.level_keys)}
        for gi, placement in enumerate(response.placements[:g]):
            admitted[gi] = placement.admitted
            score[gi] = placement.placement_score
            chosen_level[gi] = level_index.get(placement.chosen_level_key, -1)
            group_index = {name: pi for pi, name in enumerate(problem.group_names[gi])}
            for asg in placement.assignments:
                pi = group_index.get(asg.group)
                ni = node_index.get(asg.node)
                if pi is None or ni is None:
                    continue
                alloc[gi, pi, ni] += asg.count
                placed[gi, pi] += asg.count
        result = PackingResult(
            admitted=admitted,
            placed=placed,
            score=score,
            chosen_level=chosen_level,
            alloc=alloc,
            free_after=problem.capacity,  # not read on this path
            solve_seconds=response.solve_seconds,
        )
        return result, problem

    # -- main loop -------------------------------------------------------

    def schedule_pending(self, namespace: Optional[str] = None) -> int:
        """Schedule pending work. namespace=None covers every namespace with
        pending pods in one priority-ordered global solve (nodes are shared
        cluster-wide)."""
        if self.admission_fenced:
            # partition fence: a region cut off from the federation admits no
            # new gang while its lease is expired; running pods are untouched,
            # and no PodGang flips to Scheduled in two regions across a
            # partition and heal (the router's invariant F3)
            return 0
        # wall attribution: everything below lands under controller
        # "scheduler"; this phase's self time is the ordering, quota,
        # preemption and reclaim glue between its child phases
        prof = (
            PROFILER.phase("schedule", controller="scheduler")
            if PROFILER.enabled
            else None
        )
        try:
            with TRACER.span("scheduler.schedule") as span:
                bound = self._schedule_pending(namespace)
                span.set("bound", bound)
                return bound
        finally:
            if prof is not None:
                prof.end()

    def _schedule_pending(self, namespace: Optional[str] = None) -> int:
        if namespace is None:
            # every namespace with pending pods or gangs: phase and health
            # upkeep keeps running after everything is scheduled
            namespaces = sorted(
                {p.metadata.namespace for p in self._pending_pods(None)}
                | {g.metadata.namespace for g in self.store.scan("PodGang")}
            ) or ["default"]
        else:
            namespaces = [namespace]
        if namespace is None and getattr(self.store, "num_shards", 1) > 1:
            # a full round's pending namespaces per keyspace shard; shards
            # that drained since the last full round are zeroed
            by_shard: Dict[int, int] = {}
            for ns in namespaces:
                idx = self.store.shard_index(ns)
                by_shard[idx] = by_shard.get(idx, 0) + 1
            previous, self._pending_ns_shards = self._pending_ns_shards, set(by_shard)
            for idx in sorted(previous - set(by_shard)):
                METRICS.set(f"pending_namespaces@{idx}", 0)
            for idx, count in sorted(by_shard.items()):
                METRICS.set(f"pending_namespaces@{idx}", count)
        self.cluster._gc_bindings()
        if self.delta is not None:
            # before the pending scan: a topology change (cordon, flap,
            # capacity) must clear the spec cache before any spec is served
            # from it (pins and survivor seeds resolve against the nodes)
            self.delta.refresh([n for n in self.cluster.nodes if n.schedulable])
        sticky_bound = 0
        gang_specs: List[dict] = []
        gang_pods: Dict[str, Dict[str, List]] = {}
        loose_pods: List = []  # (namespace, pod)
        with TRACER.span("scheduler.pending-scan", namespaces=len(namespaces)):
            for ns in namespaces:
                # the scan is the round's namespace-partitioned work: its
                # rows are attributed per keyspace shard
                prof = (
                    PROFILER.phase("pending-scan", shard=self.store.shard_index(ns))
                    if PROFILER.enabled and getattr(self.store, "shard_index", None) is not None
                    else None
                )
                try:
                    self.update_gang_phases(ns)
                    self.update_gang_health(ns)
                    pending = self._pending_pods(ns)
                    if not pending:
                        continue
                    sticky, pending = self._bind_with_reused_reservations(ns, pending)
                    sticky_bound += sticky
                    specs, pods, loose = self._encode_pending(ns, pending)
                    gang_specs.extend(specs)
                    gang_pods.update(pods)
                    loose_pods.extend((ns, p) for p in loose)
                    if JOURNEYS.enabled:
                        for spec in specs:
                            JOURNEYS.note_seen(ns, spec["gang_name"])
                finally:
                    if prof is not None:
                        prof.end()

        # global solve order: the fair-share pass when Queue CRs exist,
        # else the flat (-priority, name) sort
        gang_specs, held = self._order_with_quota(gang_specs)
        for spec, reason in held:
            EVENTS.record(
                ("PodGang", spec["namespace"], spec["gang_name"]),
                TYPE_WARNING,
                REASON_QUEUE_PENDING,
                f"{DETAIL_QUOTA_CEILING}: {reason}",
            )

        bound = 0
        if gang_specs:
            # cordoned and unhealthy nodes never reach the solver
            nodes = [n for n in self.cluster.nodes if n.schedulable]
            if nodes:
                jz = JOURNEYS.enabled
                if jz:
                    t_enc0 = JOURNEYS.t()
                    self._journey_encode_end = None
                if self.delta is not None:
                    result, problem = self._solve_batch_delta(nodes, gang_specs)
                else:
                    free = self.cluster.node_free_all(nodes)
                    result, problem = self._solve_batch(nodes, gang_specs, free)
                if jz:
                    # the round's stamps: every gang of the batch saw the
                    # same encode and solve walls
                    t_solve1 = JOURNEYS.t()
                    JOURNEYS.note_round(t_enc0, self._journey_encode_end or t_enc0, t_solve1)
                    for spec in gang_specs:
                        JOURNEYS.note_encoded(spec["namespace"], spec["gang_name"])
                if self.delta is not None and self.delta_selfcheck:
                    self._delta_ab_check(nodes, gang_specs, problem, result)
                if not self._solve_reused:
                    METRICS.observe("gang_solve_seconds", result.solve_seconds)
                preempted, preempt_free = self._maybe_preempt(gang_specs, result)
                if self.quota.active():
                    with TRACER.span("quota.reclaim") as rspan:
                        reclaimed = self._maybe_reclaim(
                            gang_specs, result, preempted, preempt_free
                        )
                        rspan.set("victims", len(reclaimed))
                    preempted |= reclaimed
                assignments = result.assignments(problem)
                # the deferral detail every GangDeferred event cites
                defer_details = {}
                if not result.admitted[: len(gang_specs)].all():
                    defer_details = classify_rejections(problem, result, gang_specs)
                to_mark = []
                prof = PROFILER.phase("commit") if PROFILER.enabled else None
                try:
                    self._commit_admitted(
                        gang_specs, result, assignments, gang_pods, preempted, to_mark,
                        defer_details,
                    )
                    bound += self._last_commit_bound
                finally:
                    if prof is not None:
                        prof.end()
                with TRACER.span("scheduler.status-write", gangs=len(to_mark)):
                    for ns, gang_name, score in to_mark:
                        self._mark_scheduled(ns, gang_name, score)

        # pods not in any gang: first fit
        for _ns, pod in loose_pods:
            for node in self.cluster.nodes:
                if node.schedulable and self.cluster.fits(node, pod):
                    self.cluster.bind(pod, node.name)
                    bound += 1
                    break
        return bound + sticky_bound

    def _commit_admitted(
        self, gang_specs, result, assignments, gang_pods, preempted, to_mark,
        defer_details=None,
    ) -> None:
        """Bind every admitted gang's pods and queue its status write; the
        bound-pod count lands in ``self._last_commit_bound``."""
        bound = 0
        with TRACER.span("scheduler.commit", gangs=len(gang_specs)) as commit_span:
            for gi, spec in enumerate(gang_specs):
                ns = spec["namespace"]
                if not result.admitted[gi]:
                    if (ns, spec["gang_name"]) not in preempted:
                        slug, text = (defer_details or {}).get(
                            gi,
                            (None, "insufficient capacity or unsatisfiable topology"),
                        )
                        EVENTS.record(
                            ("PodGang", ns, spec["gang_name"]),
                            TYPE_WARNING,
                            REASON_GANG_DEFERRED,
                            f"not admitted this round ({slug + ': ' if slug else ''}{text})",
                        )
                    continue
                if (ns, spec["gang_name"]) in preempted:
                    # a victim's stale admission must not overwrite its
                    # Preempted status (its pods are gone)
                    continue
                for pclq_fqn, node_names in assignments[spec["name"]].items():
                    pods = gang_pods[spec["name"]].get(pclq_fqn, [])
                    for pod, node_name in zip(pods, node_names):
                        self.cluster.bind(pod, node_name)
                        EVENTS.record(
                            ("Pod", ns, pod.metadata.name),
                            TYPE_NORMAL,
                            REASON_POD_BOUND,
                            f"bound to {node_name}",
                        )
                        bound += 1
                # a recovery solve covers only the missing pods: its score
                # says nothing about the whole gang, keep the original
                partial = any(g["partial"] for g in spec["groups"])
                EVENTS.record(
                    ("PodGang", ns, spec["gang_name"]),
                    TYPE_NORMAL,
                    REASON_GANG_ADMITTED,
                    f"placement score {float(result.score[gi]):.4f}",
                )
                if JOURNEYS.enabled:
                    JOURNEYS.note_commit(ns, spec["gang_name"])
                to_mark.append(
                    (ns, spec["gang_name"], None if partial else float(result.score[gi]))
                )
            commit_span.set("bound", bound)
        self._last_commit_bound = bound

    def _bind_with_reused_reservations(self, namespace: str, pending: List):
        """PodGang.reuseReservationRef: a recreated pod of a scheduled gang
        that carries the hint goes back to its previous node when that node
        still fits it."""
        remaining = []
        bound = 0
        nodes_by_name = {n.name: n for n in self.cluster.nodes}
        gang_cache: Dict[str, object] = {}
        for pod in pending:
            prev = self._reuse_bind_target(
                namespace, pod, nodes_by_name, gang_cache, self.cluster.fits
            )
            if prev is not None:
                self.cluster.bind(pod, prev)
                EVENTS.record(
                    ("Pod", namespace, pod.metadata.name),
                    TYPE_NORMAL,
                    REASON_POD_BOUND,
                    f"bound to {prev} (reused reservation)",
                )
                bound += 1
            else:
                remaining.append(pod)
        return bound, remaining

    def _reuse_bind_target(self, namespace: str, pod, nodes_by_name, gang_cache, fits):
        """The node a pending pod would be sticky-rebound to, or None. The
        whole rule lives here, so the binding loop and the explain engine's
        read-only replica (``solver/introspect.py``) judge reuse alike;
        ``fits`` is the capacity check (``cluster.fits`` live, a snapshot
        check in the replica)."""
        gang_name = pod.metadata.labels.get(namegen.LABEL_PODGANG)
        if gang_name and gang_name not in gang_cache:
            gang_cache[gang_name] = self.store.get(
                "PodGang", namespace, gang_name, readonly=True
            )
        gang = gang_cache.get(gang_name) if gang_name else None
        prev = self.cluster.last_node.get((namespace, pod.metadata.name))
        cond = (
            get_condition(gang.status.conditions, COND_PODGANG_SCHEDULED)
            if gang is not None
            else None
        )
        if (
            gang is not None
            and gang.spec.reuse_reservation_ref is not None
            and cond is not None
            and cond.is_true()
            and prev in nodes_by_name
            and nodes_by_name[prev].schedulable
            and fits(nodes_by_name[prev], pod)
            and self._reuse_respects_pack_constraint(
                namespace, gang, nodes_by_name, nodes_by_name[prev]
            )
        ):
            return prev
        return None

    def _reuse_respects_pack_constraint(self, namespace: str, gang, nodes_by_name, candidate_node) -> bool:
        """A reused reservation must share the required-level domain with
        the gang's bound pods (and some must be bound)."""
        tc = gang.spec.topology_constraint
        required = (
            tc.pack_constraint.required
            if tc is not None and tc.pack_constraint is not None
            else None
        )
        if required is None:
            return True
        for group in gang.spec.pod_groups:
            for ref in group.pod_references:
                bound_node_name = self.cluster.bindings.get((namespace, ref.name))
                node = nodes_by_name.get(bound_node_name)
                if node is not None:
                    return node.labels.get(required) == candidate_node.labels.get(required)
        return False

    # -- quota ordering & status -----------------------------------------

    def _order_with_quota(self, gang_specs: List[dict]):
        """Fair-share solve order when Queue CRs exist; the flat
        (-priority, name) sort otherwise. Returns (ordered_specs, held)."""
        if not self.quota.active():
            return sorted(gang_specs, key=lambda s: (-s["priority"], s["name"])), []
        t0 = time.perf_counter()
        with TRACER.span("quota.order", gangs=len(gang_specs)) as span:
            ordered, held = self.quota.order_specs(gang_specs)
            span.set("held", len(held))
            span.set("queues", len(self.quota.last_rows))
        METRICS.observe("quota_order_seconds", time.perf_counter() - t0)
        self._write_queue_status()
        return ordered, held

    def _write_queue_status(self) -> None:
        """Per-queue status after an ordering pass (written on change)."""
        rows = {row["name"]: row for row in self.quota.last_rows}
        admitted: Dict[str, int] = {}
        for gang in self.store.scan("PodGang"):
            cond = get_condition(gang.status.conditions, COND_PODGANG_SCHEDULED)
            if cond is not None and cond.is_true():
                queue = gang.metadata.labels.get(namegen.LABEL_QUEUE) or self.quota.default_queue
                admitted[queue] = admitted.get(queue, 0) + 1
        for name, row in rows.items():
            METRICS.set(f"queue_dominant_share/{name}", row["dominant_share"])
            METRICS.set(f"queue_pending_gangs/{name}", row["pending"])
            METRICS.set(f"queue_admitted_gangs/{name}", admitted.get(name, 0))
            cr = row["cr"]
            if cr is None:
                continue  # implicit queue: no CR to carry status
            st = QueueStatus(
                usage={r: round(v, 9) for r, v in row["usage"].items()},
                dominant_share=round(row["dominant_share"], 6),
                admitted_gangs=admitted.get(name, 0),
                pending_gangs=row["pending"],
                conditions=list(cr.status.conditions),
            )
            if (
                st.usage == cr.status.usage
                and st.dominant_share == cr.status.dominant_share
                and st.admitted_gangs == cr.status.admitted_gangs
                and st.pending_gangs == cr.status.pending_gangs
            ):
                continue
            self._commit_status_tolerant(cr, st)

    # -- helpers ---------------------------------------------------------

    def _update_status_tolerant(self, obj) -> bool:
        """Status write that counts a resourceVersion conflict and moves on
        (the next round re-derives the same status)."""
        try:
            self.store.update_status(obj)
            return True
        except GroveError as e:
            if e.code != ERR_CONFLICT:
                raise
            METRICS.inc("gang_status_conflicts_total")
            return False

    def _commit_status_tolerant(self, view, status) -> bool:
        """Copy-on-write status commit against a readonly ``view``,
        tolerating conflicts the same way."""
        try:
            return commit_status(self.store, view, status) is not None
        except GroveError as e:
            if e.code != ERR_CONFLICT:
                raise
            METRICS.inc("gang_status_conflicts_total")
            return False

    def _pending_pods(self, namespace: Optional[str]) -> List:
        # a pending pod is never Ready: the not-Ready working set holds them
        return [
            p
            for p in self.cluster._not_ready_pods(namespace)
            if not p.spec.scheduling_gates and not is_scheduled(p) and not is_terminating(p)
        ]

    def _overlap_token(self, namespace: str, unsched: frozenset) -> tuple:
        """Staleness token over every input ``_build_gang_spec`` reads: the
        namespace shard's emitted-event count (any commit or hard delete on
        the shard moves it), the binding table's rebuild epoch, the
        monitor's hold epoch and the cordoned node names. Equal tokens mean
        a spec built then equals one built now."""
        held = self.monitor.holds_epoch if self.monitor is not None else -1
        return (
            self.store.shard_emitted(self.store.shard_index(namespace)),
            self.cluster.bindings_epoch,
            held,
            unsched,
        )

    def speculate_encode(self) -> int:
        """Build pending gangs' specs for the next round into the overlap
        cache (reads only: nothing commits, emits or touches the delta
        state). Skips held gangs and gangs the delta cache covers. Returns
        the specs built (at most ``overlap_budget``)."""
        if not isinstance(self.store, Store) or not isinstance(self.cluster, SimCluster):
            return 0
        built = 0
        unsched = frozenset(self.cluster.unschedulable_names())
        pending_by_ns: Dict[str, List] = defaultdict(list)
        pending_gangs = set()
        for p in self._pending_pods(None):
            pending_by_ns[p.metadata.namespace].append(p)
            gname = p.metadata.labels.get(namegen.LABEL_PODGANG)
            if gname:
                pending_gangs.add((p.metadata.namespace, gname))
        if self._overlap_cache:
            # a gang that left the pending set is never consulted again
            for key in [k for k in self._overlap_cache if k not in pending_gangs]:
                del self._overlap_cache[key]
        for ns in sorted(pending_by_ns):
            token = self._overlap_token(ns, unsched)
            by_gang: Dict[str, List] = defaultdict(list)
            for pod in pending_by_ns[ns]:
                gang_name = pod.metadata.labels.get(namegen.LABEL_PODGANG)
                if gang_name:
                    by_gang[gang_name].append(pod)
            for gang_name, pods in sorted(by_gang.items()):
                if self.monitor is not None and self.monitor.gang_held(ns, gang_name):
                    continue
                if self.delta is not None and self.delta.has_clean_spec(ns, gang_name):
                    continue  # the warm-start cache wins at consumption
                key = (ns, gang_name)
                names = tuple(sorted(p.metadata.name for p in pods))
                entry = self._overlap_cache.get(key)
                if entry is not None and entry[0] == token and entry[1] == names:
                    continue  # already speculated against this state
                result = self._build_gang_spec(ns, gang_name, pods)
                if result is None:
                    self._overlap_cache.pop(key, None)
                    continue
                spec, by_pclq = result
                self._overlap_cache[key] = (token, names, spec, dict(by_pclq))
                built += 1
                if built >= self.overlap_budget:
                    return built
        return built

    def _encode_pending(self, namespace: str, pending: List):
        by_gang: Dict[str, List] = defaultdict(list)
        loose = []
        for pod in pending:
            gang_name = pod.metadata.labels.get(namegen.LABEL_PODGANG)
            if gang_name:
                by_gang[gang_name].append(pod)
            else:
                loose.append(pod)
        # the cordon signature, read at most once (only with speculated specs)
        unsched = None
        gang_specs: List[dict] = []
        gang_pods: Dict[str, Dict[str, List]] = {}
        for gang_name, pods in sorted(by_gang.items()):
            if self.monitor is not None and self.monitor.gang_held(namespace, gang_name):
                # a requeued gang in rate-limited backoff: its pods stay
                # pending (gang pods, not loose) until the monitor releases
                # it into a later round
                continue
            if self.delta is not None:
                # warm start: a gang with no relevant pod or PodGang delta
                # since its spec was built, and the same pending pod set,
                # reuses the spec; inputs outside the watched events
                # (cordons, node changes) clear the whole cache through the
                # topology signature in DeltaSolveState.refresh
                hit = self.delta.cached_spec(namespace, gang_name, pods)
                if hit is not None:
                    spec, pods_by_pclq = hit
                    gang_specs.append(spec)
                    gang_pods[spec["name"]] = dict(pods_by_pclq)
                    continue
            if self._overlap_cache:
                # a speculated spec stands while its token matches (a hit
                # keeps the entry); a mismatch evicts it and rebuilds below
                entry = self._overlap_cache.get((namespace, gang_name))
                if entry is not None:
                    if unsched is None:
                        unsched = frozenset(self.cluster.unschedulable_names())
                    names = tuple(sorted(p.metadata.name for p in pods))
                    if entry[0] == self._overlap_token(namespace, unsched) and entry[1] == names:
                        METRICS.inc("cp_overlap_hits_total")
                        spec, by_pclq = entry[2], entry[3]
                        gang_specs.append(spec)
                        gang_pods[spec["name"]] = dict(by_pclq)
                        if self.delta is not None:
                            self.delta.store_spec(namespace, gang_name, pods, spec, dict(by_pclq))
                        continue
                    METRICS.inc("cp_overlap_stale_total")
                    self._overlap_cache.pop((namespace, gang_name), None)
            built = self._build_gang_spec(namespace, gang_name, pods)
            if built is None:
                loose.extend(pods)
                continue
            spec, by_pclq = built
            gang_specs.append(spec)
            gang_pods[f"{namespace}/{gang_name}"] = dict(by_pclq)
            if self.delta is not None:
                self.delta.store_spec(namespace, gang_name, pods, spec, dict(by_pclq))
        return gang_specs, gang_pods, loose

    def _build_gang_spec(self, namespace: str, gang_name: str, pods: List):
        """One pending gang's solver spec from its CR and pending pods.
        Returns ``(spec, pods_by_pclq)``, or None when the PodGang CR is
        missing (the pods are loose)."""
        gang_cr = self.store.get("PodGang", namespace, gang_name, readonly=True)
        if gang_cr is None:
            return None
        groups_cr = {g.name: g for g in gang_cr.spec.pod_groups}
        by_pclq: Dict[str, List] = defaultdict(list)
        for pod in pods:
            by_pclq[pod.metadata.labels.get(namegen.LABEL_PODCLIQUE, "")].append(pod)
        # PCSG-tier pack groups: a config covering every pending group folds
        # into the gang-level required key; one covering a subset confines
        # each member group to one domain at that level
        pending_group_names = set(by_pclq)
        collective_req = None
        group_cfg_req = {}
        for cfg in gang_cr.spec.topology_constraint_group_configs:
            tc = cfg.topology_constraint
            if tc is None or tc.pack_constraint is None:
                continue
            cfg_key = tc.pack_constraint.required
            if set(cfg.pod_group_names) >= pending_group_names:
                collective_req = self._narrower_key(collective_req, cfg_key)
            else:
                for member in cfg.pod_group_names:
                    group_cfg_req[member] = self._narrower_key(group_cfg_req.get(member), cfg_key)

        groups = []
        for pclq_fqn, members in sorted(by_pclq.items()):
            members.sort(key=lambda p: p.metadata.name)
            group_cr = groups_cr.get(pclq_fqn)
            min_replicas = group_cr.min_replicas if group_cr else len(members)
            already = self._scheduled_count(namespace, pclq_fqn)
            own_req = None
            if group_cr is not None and group_cr.topology_constraint is not None:
                pc = group_cr.topology_constraint.pack_constraint
                own_req = pc.required if pc is not None else None
            group_required = self._narrower_key(own_req, group_cfg_req.get(pclq_fqn))
            # recovery pin: surviving pods of a constrained group anchor the
            # replacements to their domain
            pinned_node = None
            if group_required is not None and already > 0:
                pinned_node = self._any_bound_node(namespace, pclq_fqn)
            groups.append(
                {
                    "name": pclq_fqn,
                    "demand": members[0].spec.total_requests(),
                    "count": len(members),
                    # floor reduced by pods already scheduled (recovery)
                    "min_count": max(0, min_replicas - already),
                    "partial": already > 0,
                    "required_key": group_required,
                    "pinned_node": pinned_node,
                }
            )
        required_key = preferred_key = None
        spread_key = None
        spread_min = 2
        spread_required = False
        tc = gang_cr.spec.topology_constraint
        if tc is not None and tc.pack_constraint is not None:
            required_key = tc.pack_constraint.required
            preferred_key = tc.pack_constraint.preferred
        spread_survivor_nodes: List[str] = []
        if tc is not None and tc.spread_constraint is not None:
            sc = tc.spread_constraint
            spread_key = sc.topology_key
            spread_min = sc.min_domains
            spread_required = sc.when_unsatisfiable != SPREAD_SCHEDULE_ANYWAY
            # spread recovery: survivors' nodes seed the balanced fill
            if any(g["partial"] for g in groups):
                for grp in groups:
                    spread_survivor_nodes.extend(self._bound_nodes(namespace, grp["name"]))
        required_key = self._narrower_key(required_key, collective_req)
        # gang-level recovery pin: a required pack with surviving pods
        # anchors the replacements to the survivors' domain
        gang_pinned_node = None
        if required_key is not None and any(g["partial"] for g in groups):
            cordoned = self.cluster.unschedulable_names()
            for grp in groups:
                node = self._any_bound_node(namespace, grp["name"])
                if node is None:
                    continue
                if node not in cordoned:
                    gang_pinned_node = node
                    break
                gang_pinned_node = gang_pinned_node or node
        spec = {
            # globally unique solver key; the bare CR name stays in gang_name
            "name": f"{namespace}/{gang_name}",
            "gang_name": gang_name,
            "namespace": namespace,
            "groups": groups,
            "required_key": required_key,
            "preferred_key": preferred_key,
            "spread_key": spread_key,
            "spread_min_domains": spread_min,
            "spread_required": spread_required,
            "spread_survivor_nodes": spread_survivor_nodes,
            "gang_pinned_node": gang_pinned_node,
            "priority": self.priority_map.get(gang_cr.spec.priority_class_name, 0),
            # tenant queue: unlabeled gangs land in the default queue
            "queue": gang_cr.metadata.labels.get(namegen.LABEL_QUEUE)
            or self.quota.default_queue,
        }
        return spec, dict(by_pclq)

    def _narrower_key(self, a: Optional[str], b: Optional[str]) -> Optional[str]:
        """Narrower (higher level index) of two topology keys."""
        order = {lvl.key: i for i, lvl in enumerate(self.topology.spec.levels)}
        if a is None:
            return b
        if b is None:
            return a
        return a if order.get(a, -1) >= order.get(b, -1) else b

    def _any_bound_node(self, namespace: str, pclq_fqn: str) -> Optional[str]:
        """A node hosting a bound pod of the clique, preferring schedulable
        nodes (a pin on an unschedulable node would be dropped)."""
        cordoned = self.cluster.unschedulable_names()
        fallback = None
        for p in self.store.scan("Pod", namespace, {namegen.LABEL_PODCLIQUE: pclq_fqn}):
            node = self.cluster.bindings.get((namespace, p.metadata.name))
            if node is None:
                continue
            if node not in cordoned:
                return node
            fallback = fallback or node
        return fallback

    def _bound_nodes(self, namespace: str, pclq_fqn: str) -> List[str]:
        """Every node hosting a bound pod of the clique (with multiplicity)."""
        out: List[str] = []
        for p in self.store.scan("Pod", namespace, {namegen.LABEL_PODCLIQUE: pclq_fqn}):
            node = self.cluster.bindings.get((namespace, p.metadata.name))
            if node is not None:
                out.append(node)
        return out

    def _scheduled_count(self, namespace: str, pclq_fqn: str) -> int:
        return sum(
            1
            for p in self.store.scan("Pod", namespace, {namegen.LABEL_PODCLIQUE: pclq_fqn})
            if is_scheduled(p) and not is_terminating(p)
        )

    def _mark_scheduled(self, namespace: str, gang_name: str, score: Optional[float]) -> None:
        # retried with a fresh read on conflict: the pods are already bound
        for _ in range(4):
            gang = self.store.get("PodGang", namespace, gang_name, readonly=True)
            if gang is None:
                return
            st = clone_status(gang.status)
            if st.phase == PHASE_PENDING:
                st.phase = PHASE_STARTING
            if score is not None:
                st.placement_score = score
            set_condition(
                st.conditions,
                Condition(
                    type=COND_PODGANG_SCHEDULED,
                    status="True",
                    reason="AllPodGroupsPlaced",
                    message=f"placement score {st.placement_score}",
                ),
                self.store.clock.now(),
            )
            # a (re)scheduled gang is no longer a disruption target
            if (
                dt := get_condition(st.conditions, COND_PODGANG_DISRUPTION_TARGET)
            ) is not None and dt.is_true():
                set_condition(
                    st.conditions,
                    Condition(
                        type=COND_PODGANG_DISRUPTION_TARGET,
                        status="False",
                        reason="Rescheduled",
                    ),
                    self.store.clock.now(),
                )
            if self._commit_status_tolerant(gang, st):
                if JOURNEYS.enabled:
                    # Scheduled=True is committed: the journey completes (a
                    # re-mark of a completed gang is a no-op)
                    JOURNEYS.note_scheduled(namespace, gang_name)
                return

    # -- preemption ------------------------------------------------------

    def _maybe_preempt(self, gang_specs, result):
        """Higher-priority pending gangs the solve could not admit may evict
        strictly lower-priority scheduled gangs of any namespace, highest
        priority first. An eviction proceeds only when a trial solve of the
        preemptor against the freed capacity admits it, and the victim set
        is pruned to an inclusion-minimal one. Returns (victim keys,
        base_free): base_free is the shared capacity snapshot with every
        preemptor's planned placement taken off, handed to quota reclaim
        (None when no preemption round ran)."""
        rejected = sorted(
            (
                spec
                for i, spec in enumerate(gang_specs)
                if not result.admitted[i] and spec["priority"] > 0
            ),
            key=lambda s: (-s["priority"], s["name"]),
        )
        if not rejected:
            return set(), None
        nodes = [n for n in self.cluster.nodes if n.schedulable]
        if not nodes:
            return set(), None
        # resolve the broker once a round: active() scans PodCliqueSets
        # while un-armed, and would_allow runs per candidate victim
        broker = self._active_broker()
        # one free-capacity snapshot for every preemptor (evictions below
        # must not double-spend capacity earmarked for an earlier one)
        base_free = self.cluster.node_free_each(nodes)
        all_victim_keys: set = set()
        for preemptor in rejected:
            victims_chosen, free_delta = self._select_preemption_victims(
                preemptor, nodes, base_free, exclude=all_victim_keys, broker=broker
            )
            if victims_chosen and broker is not None and not broker.grant(victims_chosen, "preemption"):
                # the budget or the breaker denied the victim set: nothing
                # is evicted or folded into the snapshot, the preemptor
                # stays pending for a later round
                continue
            for gang in victims_chosen:
                self._evict_victim(gang, preemptor)
                all_victim_keys.add((gang.metadata.namespace, gang.metadata.name))
            for node_name, caps in free_delta.items():
                acc = base_free.setdefault(node_name, {})
                for r, q in caps.items():
                    acc[r] = acc.get(r, 0.0) + q
        return all_victim_keys, base_free

    @staticmethod
    def _placement_usage(result, problem, preemptor: dict) -> Dict:
        """Per-node resources the preemptor's trial placement consumes, in
        original units (negative = consumed)."""
        demand_by_group = {g["name"]: g["demand"] for g in preemptor["groups"]}
        usage: Dict[str, Dict[str, float]] = {}
        alloc = result.alloc[0]  # [P, N]
        for p, gname in enumerate(problem.group_names[0]):
            dem = demand_by_group.get(gname, {})
            for n in np.nonzero(alloc[p])[0]:
                k = int(alloc[p][n])
                caps = usage.setdefault(problem.node_names[int(n)], {})
                for r, q in dem.items():
                    caps[r] = caps.get(r, 0.0) - q * k
        return usage

    def _active_broker(self):
        """The disruption broker when it is active (budgets exist or a drain
        armed it), else None: callers resolve it once a round, so the inert
        path costs one scan, not one per candidate victim."""
        if self.broker is not None and self.broker.active():
            return self.broker
        return None

    def _select_preemption_victims(
        self, preemptor: dict, nodes: List, base_free: Dict, exclude: set, broker=None
    ):
        """An inclusion-minimal set of scheduled lower-priority gangs whose
        eviction makes the preemptor placeable; empty when none helps.
        A gang the ``broker`` would not allow to go never enters the
        trials. Returns (victims, free_delta)."""
        # a gang that fits the current free capacity alone places next
        # round: never evict for it (but reserve its planned placement)
        solo, solo_problem = self._solve_batch(nodes, [preemptor], base_free)
        if solo.admitted[0]:
            return [], self._placement_usage(solo, solo_problem, preemptor)

        victims = []
        for gang in self.store.list("PodGang"):  # every namespace
            if (gang.metadata.namespace, gang.metadata.name) in exclude:
                continue
            cond = get_condition(gang.status.conditions, COND_PODGANG_SCHEDULED)
            if cond is None or not cond.is_true():
                continue
            victim_priority = self.priority_map.get(gang.spec.priority_class_name, 0)
            if victim_priority >= preemptor["priority"]:
                continue
            if broker is not None and not broker.would_allow(gang):
                # its set's disruptionBudget (or the storm breaker) would
                # deny the eviction: a doomed victim set is never selected
                continue
            victims.append((victim_priority, gang))
        if not victims:
            return [], {}
        victims.sort(key=lambda v: (v[0], v[1].metadata.namespace, v[1].metadata.name))
        return self._trial_victim_selection(preemptor, nodes, base_free, [g for _, g in victims])

    def _trial_victim_selection(self, preemptor: dict, nodes: List, base_free: Dict, ordered_victims: List):
        """Trial-solve machinery shared by preemption and quota reclaim:
        take victims in preference order until their freed capacity covers
        the preemptor's floor demand, check with a trial solve, prune to an
        inclusion-minimal set (the latest taken dropped first), and return
        (victims, free_delta = freed capacity - the planned placement)."""
        demand_total: Dict[str, float] = {}
        for group in preemptor["groups"]:
            for r, q in group["demand"].items():
                demand_total[r] = demand_total.get(r, 0.0) + q * group["min_count"]

        def gang_freed_per_node(gang) -> Dict[str, Dict[str, float]]:
            """Per-node resources evicting this gang releases (bound pods)."""
            per_node: Dict[str, Dict[str, float]] = {}
            for group in gang.spec.pod_groups:
                for ref in group.pod_references:
                    node_name = self.cluster.bindings.get((ref.namespace, ref.name))
                    if node_name is None:
                        continue
                    pod = self.store.get("Pod", ref.namespace, ref.name, readonly=True)
                    if pod is None:
                        continue
                    caps = per_node.setdefault(node_name, {})
                    for r, q in pod.spec.total_requests().items():
                        caps[r] = caps.get(r, 0.0) + q
            return per_node

        freed: Dict[str, float] = {}
        chosen: List = []
        chosen_freed: List[Dict[str, Dict[str, float]]] = []
        for gang in ordered_victims:
            per_node = gang_freed_per_node(gang)
            if not per_node:
                continue  # nothing bound: eviction frees nothing
            chosen.append(gang)
            chosen_freed.append(per_node)
            for caps in per_node.values():
                for r, q in caps.items():
                    freed[r] = freed.get(r, 0.0) + q
            if all(freed.get(r, 0.0) >= q for r, q in demand_total.items()):
                break
        else:
            return [], {}  # evicting everything lower still would not fit

        def run_trial(keep: List[int], with_alloc: bool = False):
            trial_free = {}
            add: Dict[str, Dict[str, float]] = {}
            for i in keep:
                for node_name, caps in chosen_freed[i].items():
                    acc = add.setdefault(node_name, {})
                    for r, q in caps.items():
                        acc[r] = acc.get(r, 0.0) + q
            for node in nodes:
                caps = dict(base_free[node.name])
                for r, q in add.get(node.name, {}).items():
                    caps[r] = caps.get(r, 0.0) + q
                trial_free[node.name] = caps
            return self._solve_batch(nodes, [preemptor], trial_free, with_alloc=with_alloc)

        keep = list(range(len(chosen)))
        result, _ = run_trial(keep)
        if not result.admitted[0]:
            return [], {}  # eviction would not make the preemptor placeable

        # prune: drop the most valuable (latest taken) victims first
        for i in reversed(range(len(chosen))):
            reduced = [j for j in keep if j != i]
            if reduced:
                result, _ = run_trial(reduced)
                if result.admitted[0]:
                    keep = reduced

        final, final_problem = run_trial(keep, with_alloc=True)
        delta: Dict[str, Dict[str, float]] = {}
        if final.admitted[0]:
            delta = self._placement_usage(final, final_problem, preemptor)
        for i in keep:
            for node_name, caps in chosen_freed[i].items():
                acc = delta.setdefault(node_name, {})
                for r, q in caps.items():
                    acc[r] = acc.get(r, 0.0) + q
        return [chosen[i] for i in keep], delta

    # -- quota reclaim ---------------------------------------------------

    def _gang_requests_total(self, gang) -> Dict[str, float]:
        """Cluster-total resources the gang's bound pods hold."""
        out: Dict[str, float] = {}
        for group in gang.spec.pod_groups:
            for ref in group.pod_references:
                if self.cluster.bindings.get((ref.namespace, ref.name)) is None:
                    continue
                pod = self.store.get("Pod", ref.namespace, ref.name, readonly=True)
                if pod is None:
                    continue
                for r, v in pod.spec.total_requests().items():
                    out[r] = out.get(r, 0.0) + v
        return out

    def _reclaim_pool(self, crs: Dict, exclude: set) -> List:
        """The round's potential reclaim victims from one scan: every
        scheduled gang with bound capacity, with its queue, the queue's
        deserved shares, the freed totals and its priority."""
        pool = []
        for gang in self.store.scan("PodGang"):
            key = (gang.metadata.namespace, gang.metadata.name)
            if key in exclude:
                continue
            cond = get_condition(gang.status.conditions, COND_PODGANG_SCHEDULED)
            if cond is None or not cond.is_true():
                continue
            queue = gang.metadata.labels.get(namegen.LABEL_QUEUE) or self.quota.default_queue
            freed = self._gang_requests_total(gang)
            if not freed:
                continue  # nothing bound: eviction frees nothing
            cr = crs.get(queue)
            deserved = dict(cr.spec.deserved) if cr is not None else {}
            priority = self.priority_map.get(gang.spec.priority_class_name, 0)
            pool.append((gang, queue, deserved, freed, priority))
        return pool

    @staticmethod
    def _reclaim_candidates(pool: List, claimant: dict, usage_sim: Dict, exclude: set) -> List:
        """Victim candidates for one claimant, in eviction-preference order:
        scheduled gangs of other queues above their deserved share whose
        eviction keeps their queue at or above it (zero-deserved queues are
        always reclaimable), checked against a running usage sim. Returns
        [(gang, freed_totals)]."""
        scored = []
        for gang, queue, deserved, freed, priority in pool:
            if (gang.metadata.namespace, gang.metadata.name) in exclude:
                continue
            if queue == claimant["queue"]:
                continue
            share = dominant_share_of(usage_sim.get(queue, {}), deserved)
            if deserved and share <= 1.0 + 1e-6:
                continue  # at or below deserved: protected
            if not deserved and share <= 0.0:
                continue  # zero-deserved queue with no usage
            scored.append((share, priority, queue, deserved, freed, gang))
        # most-over-deserved queue first; within it lowest priority, name
        scored.sort(key=lambda t: (-t[0], t[1], t[5].metadata.namespace, t[5].metadata.name))
        out = []
        sim = {q: dict(v) for q, v in usage_sim.items()}
        for share, _prio, queue, deserved, freed, gang in scored:
            row = sim.get(queue, {})
            after = {r: row.get(r, 0.0) - freed.get(r, 0.0) for r in row}
            if deserved and dominant_share_of(after, deserved) < 1.0 - 1e-6:
                continue  # would drag the victim queue below deserved
            out.append((gang, freed))
            sim[queue] = after
        return out

    def _maybe_reclaim(
        self,
        gang_specs: List[dict],
        result,
        already_evicted: set,
        preempt_free: Optional[Dict] = None,
    ) -> set:
        """Cross-queue quota reclaim: a pending gang whose queue is below its
        deserved share may evict gangs of queues above theirs (priority
        plays no part across queues). Reuses the preemption trial solves;
        victim queues never drop below their deserved share, and each
        claimant's planned placement comes off the shared snapshot. Returns
        victim (namespace, name) keys."""
        crs = self.quota.queue_crs()
        if not crs:
            return set()
        usage_sim = {q: dict(v) for q, v in self.quota.accountant.snapshot().items()}
        claimants = []
        for i, spec in enumerate(gang_specs):
            if result.admitted[i]:
                continue
            if (spec["namespace"], spec["gang_name"]) in already_evicted:
                continue
            cr = crs.get(spec["queue"])
            if cr is None or not cr.spec.deserved:
                continue  # no entitlement: nothing to reclaim toward
            claimants.append(spec)
        if not claimants:
            return set()
        nodes = [n for n in self.cluster.nodes if n.schedulable]
        if not nodes:
            return set()
        # start from the preemption round's snapshot when one ran: its
        # preemptors' planned placements are already taken off there
        base_free = preempt_free or self.cluster.node_free_each(nodes)
        pool = self._reclaim_pool(crs, already_evicted)
        # one broker resolution a round (see _maybe_preempt)
        broker = self._active_broker()

        def claimant_key(spec):
            share = dominant_share_of(
                usage_sim.get(spec["queue"], {}), dict(crs[spec["queue"]].spec.deserved)
            )
            return (share, -spec["priority"], spec["name"])

        evicted: set = set()
        for claimant in sorted(claimants, key=claimant_key):
            deserved = dict(crs[claimant["queue"]].spec.deserved)
            share = dominant_share_of(usage_sim.get(claimant["queue"], {}), deserved)
            if share >= 1.0 - 1e-6:
                continue  # queue reached deserved (an earlier claimant did it)
            candidates = self._reclaim_candidates(pool, claimant, usage_sim, evicted)
            if broker is not None and candidates:
                # budget-protected gangs are not reclaim fodder: filtered
                # before the trials
                candidates = [(g, f) for g, f in candidates if broker.would_allow(g)]
            # a gang that fits the current free capacity places next round
            # on its own: never evict for it (but take off its placement)
            solo, solo_problem = self._solve_batch(nodes, [claimant], base_free)
            if solo.admitted[0]:
                delta = self._placement_usage(solo, solo_problem, claimant)
                victims = []
            elif candidates:
                victims, delta = self._trial_victim_selection(
                    claimant, nodes, base_free, [g for g, _ in candidates]
                )
            else:
                continue
            if victims and broker is not None and not broker.grant(victims, "quota-reclaim"):
                # denied between the filter and the trial (budgets recount
                # live state): evict nothing, fold nothing
                continue
            freed_by_key = {
                (g.metadata.namespace, g.metadata.name): freed for g, freed in candidates
            }
            for gang in victims:
                key = (gang.metadata.namespace, gang.metadata.name)
                self._evict_victim(
                    gang,
                    claimant,
                    disruption_reason="QuotaReclaimed",
                    sched_reason="Reclaimed",
                    event_reason=REASON_QUOTA_RECLAIM,
                    message=(
                        f"reclaimed for {claimant['name']} "
                        f"(queue {claimant['queue']} below deserved share)"
                    ),
                    metric="quota_reclaims_total",
                )
                evicted.add(key)
                # the victim's capacity leaves the usage sim
                queue = gang.metadata.labels.get(namegen.LABEL_QUEUE) or self.quota.default_queue
                row = usage_sim.setdefault(queue, {})
                for r, v in freed_by_key.get(key, {}).items():
                    row[r] = row.get(r, 0.0) - v
            if victims or solo.admitted[0]:
                # charge the claimant so a sibling does not over-reclaim
                row = usage_sim.setdefault(claimant["queue"], {})
                for r, v in spec_demand(claimant).items():
                    row[r] = row.get(r, 0.0) + v
            for node_name, caps in delta.items():
                acc = base_free.setdefault(node_name, {})
                for r, q in caps.items():
                    acc[r] = acc.get(r, 0.0) + q
        return evicted

    def _evict_victim(
        self,
        gang,
        preemptor: dict,
        *,
        disruption_reason: str = "PreemptedByHigherPriority",
        sched_reason: str = "Preempted",
        event_reason: str = REASON_PREEMPTED,
        message: Optional[str] = None,
        metric: str = "gang_preemptions_total",
    ) -> None:
        """Evict a scheduled gang (priority preemption by default, quota
        reclaim with its own reasons): status first, then its pods; the
        event lands in the victim's namespace."""
        ns, name = gang.metadata.namespace, gang.metadata.name
        message = message or f"preempted by {preemptor['name']}"
        for _ in range(4):
            fresh = self.store.get("PodGang", ns, name)
            if fresh is None:
                return
            now = self.store.clock.now()
            set_condition(
                fresh.status.conditions,
                Condition(
                    type=COND_PODGANG_DISRUPTION_TARGET,
                    status="True",
                    reason=disruption_reason,
                    message=message,
                ),
                now,
            )
            set_condition(
                fresh.status.conditions,
                Condition(
                    type=COND_PODGANG_SCHEDULED,
                    status="False",
                    reason=sched_reason,
                    message=message,
                ),
                now,
            )
            fresh.status.phase = PHASE_PENDING
            fresh.status.placement_score = None
            if self._update_status_tolerant(fresh):
                break
        for group in gang.spec.pod_groups:
            for ref in group.pod_references:
                try:
                    self.store.delete("Pod", ref.namespace, ref.name)
                except GroveError as e:
                    if e.code != ERR_NOT_FOUND:
                        raise
        EVENTS.record(
            ("PodGang", ns, name),
            TYPE_WARNING,
            event_reason,
            f"preempted by higher-priority gang {preemptor['name']}"
            if event_reason == REASON_PREEMPTED
            else message,
        )
        METRICS.inc(metric)

    def update_gang_health(self, namespace: str = "default") -> None:
        """Unhealthy condition: a constituent PodClique breaching
        MinAvailable marks the gang (written only on change)."""
        for gang in self.store.scan("PodGang", namespace):
            breached = False
            for group in gang.spec.pod_groups:
                pclq = self.store.get("PodClique", namespace, group.name, readonly=True)
                if pclq is None:
                    continue
                cond = get_condition(pclq.status.conditions, COND_MIN_AVAILABLE_BREACHED)
                if cond is not None and cond.is_true():
                    breached = True
                    break
            want_status = "True" if breached else "False"
            want_reason = (
                "ConstituentBreachedMinAvailable" if breached else "AllConstituentsHealthy"
            )
            existing = get_condition(gang.status.conditions, COND_PODGANG_UNHEALTHY)
            if (
                existing is not None
                and existing.status == want_status
                and existing.reason == want_reason
            ):
                continue
            st = clone_status(gang.status)
            set_condition(
                st.conditions,
                Condition(type=COND_PODGANG_UNHEALTHY, status=want_status, reason=want_reason),
                self.store.clock.now(),
            )
            self._commit_status_tolerant(gang, st)

    def update_gang_phases(self, namespace: str = "default") -> None:
        """Starting -> Running (+ Ready condition) once every pod of the
        gang is Ready; and a Pending gang whose pods are all bound gets its
        Scheduled state re-derived (its status write was lost)."""
        for gang in self.store.scan("PodGang", namespace):
            if gang.status.phase == PHASE_PENDING and gang.spec.pod_groups:
                # stop at the first unbound pod
                all_bound = False
                total = 0
                for group in gang.spec.pod_groups:
                    all_bound = True
                    for ref in group.pod_references:
                        total += 1
                        p = self.store.get("Pod", ref.namespace, ref.name, readonly=True)
                        if p is None or not is_scheduled(p) or is_terminating(p):
                            all_bound = False
                            break
                    if not all_bound:
                        break
                if total and all_bound:
                    self._mark_scheduled(namespace, gang.metadata.name, None)
                continue
            if gang.status.phase != PHASE_STARTING:
                continue
            all_ready = True
            total = 0
            for group in gang.spec.pod_groups:
                if not all_ready:
                    break
                for ref in group.pod_references:
                    total += 1
                    pod = self.store.get("Pod", ref.namespace, ref.name, readonly=True)
                    if pod is None or not is_ready(pod):
                        all_ready = False
                        break
            if total and all_ready:
                st = clone_status(gang.status)
                st.phase = PHASE_RUNNING
                set_condition(
                    st.conditions,
                    Condition(
                        type="Ready",
                        status="True",
                        reason="AllPodGroupsReady",
                        message="all constituent pods are ready",
                    ),
                    self.store.clock.now(),
                )
                self._commit_status_tolerant(gang, st)
