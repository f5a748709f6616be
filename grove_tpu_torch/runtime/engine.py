"""Controller engine: watch → map → keyed work queue → reconcile.

Counterpart of ``grove_tpu/runtime/engine.py``: the single-threaded,
virtual-time stand-in for the controller-runtime manager. Determinism is a
feature: every world replays identically. The races the reference absorbs
with its expectations store come from the store's cache lag, not threads.

A Controller owns:
- a primary kind (reconciled on its own events);
- watch mappings: (watched kind, map_fn(event) -> [primary keys]) with an
  optional predicate, controller-runtime's EnqueueRequestsFromMapFunc plus
  WithPredicates.

Reconcile functions return a ReconcileStepResult: "requeue" gets
exponential backoff, "requeue_after" a fixed delay.

Over a keyspace-sharded store (``Store(num_shards=S)``) the engine keeps one
event backlog per shard, routed on ``WatchEvent.shard`` and drained in a
deterministic round-robin, gives every controller a shard-bucketed work
queue, publishes each backlog's depth as ``engine_shard_backlog@K`` and
stamps the tracer's shard context around each reconcile.

``enable_workers(n)`` (or ``GROVE_TPU_CP_WORKERS=n``) arms the parallel
drain on a sharded store: per-shard reconcile groups on worker threads
(``runtime/workers.ParallelDrain``) or, with ``backend="process"`` (or
``GROVE_TPU_CP_BACKEND=process``), on forked worker processes over the
wire codec (``runtime/procworkers.ProcessDrain``). Both run the one round
loop below with their own batch executor, so a round pops and completes
exactly as the serial drain's; routing asserts a single drainer. On an
unsharded store arming is a no-op. ``overlap_hook`` (the scheduler's
``speculate_encode``) is called only by the process drain, between a
round's dispatch and its replies; ``round_hook`` marks each routing for
the process drain's cache watermark.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from grove_tpu_torch.observability.flightrec import FLIGHTREC
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.profile import (
    NO_SHARD,
    PHASE_DEQUEUE,
    PHASE_DRAIN,
    PROFILER,
)
from grove_tpu_torch.observability.tracing import TRACER
from grove_tpu_torch.runtime.clock import Clock
from grove_tpu_torch.runtime.errors import GroveError
from grove_tpu_torch.runtime.flow import ReconcileStepResult
from grove_tpu_torch.runtime.store import Store, WatchEvent
from grove_tpu_torch.runtime.workqueue import Key, WorkQueue

MapFn = Callable[[WatchEvent], List[Tuple[str, str]]]  # -> [(namespace, name)]
PredicateFn = Callable[[WatchEvent], bool]
ReconcileFn = Callable[[Key], ReconcileStepResult]


@dataclass
class Controller:
    name: str
    kind: str
    reconcile: ReconcileFn
    # watch entries: (kind, map_fn) or (kind, map_fn, predicate); an event
    # the predicate rejects never reaches the map fn
    watches: List[tuple] = field(default_factory=list)
    # predicate on the primary kind's own events (e.g. generation changed,
    # so self-inflicted status writes do not re-enqueue the owner)
    primary_predicate: Optional[PredicateFn] = None
    queue: WorkQueue = field(default_factory=WorkQueue)
    # keys processed per round in the reference's threaded drain; the
    # serial drain batches every ready key of a round
    concurrent_syncs: int = 1
    # called once per drain round with the controller's coalesced ready
    # keys before any of them reconciles (per-batch memo builds)
    batch_hook: Optional[Callable[[List[Key]], None]] = None


class Engine:
    def __init__(self, store: Store, clock: Optional[Clock] = None) -> None:
        self.store = store
        self.clock = clock or store.clock
        self.controllers: List[Controller] = []
        # one event backlog per store shard, drained round-robin so one busy
        # shard cannot hold back the others; one backlog when unsharded
        self.num_shards = max(1, getattr(store, "num_shards", 1))
        self._backlogs = [deque() for _ in range(self.num_shards)]
        self._event_backlog = self._backlogs[0]
        self._backlog_rotation = 0
        self.held_kinds: set = set()
        # single-drainer contract: the backlog and work-queue rotation
        # pointers assume one routing thread (the serial drainer, or the
        # parallel drain's coordinator); a second one fails loudly
        self._router_lock = threading.Lock()
        self.workers = None
        # set by the harness; only a process drain calls it (between a
        # round's dispatch and its replies), so the serial drain never does
        self.overlap_hook = None
        # the process drain's round-boundary callback (its cache watermark)
        self.round_hook = None
        # per-kind routing table, built lazily after registration
        self._dispatch = None
        self._shard_index = getattr(store, "shard_index", None)
        if self.num_shards == 1:
            store.subscribe(self._event_backlog.append)
        else:
            store.subscribe(self._enqueue_sharded)
        from grove_tpu_torch.runtime.workers import workers_from_env

        env_workers = workers_from_env()
        if env_workers > 1:
            self.enable_workers(env_workers)

    def enable_workers(self, workers: int, backend: str = None) -> bool:
        """Arm the parallel drain: ``drain()`` then splits each round's
        batches over per-shard worker groups. ``backend`` is "thread" (the
        default) or "process"; unset reads ``GROVE_TPU_CP_BACKEND``. A
        no-op (False) on an unsharded store: the serial drain is the
        one-worker case."""
        if workers <= 1 or self.workers is not None:
            return self.workers is not None
        if self.num_shards <= 1:
            return False
        if backend is None:
            from grove_tpu_torch.runtime.procworkers import backend_from_env

            backend = backend_from_env()
        self.store.arm_deferred_fanout()
        if backend == "process":
            from grove_tpu_torch.runtime.procworkers import ProcessDrain

            self.workers = ProcessDrain(self, workers)
        else:
            from grove_tpu_torch.runtime.workers import ParallelDrain

            self.workers = ParallelDrain(self, workers)
        return True

    def _enqueue_sharded(self, ev: WatchEvent) -> None:
        self._backlogs[ev.shard].append(ev)

    def register(self, controller: Controller) -> None:
        if self.num_shards > 1 and controller.queue.num_shards == 1:
            # a shard-bucketed ready set with the same backoff curve;
            # registration precedes any traffic, so nothing carries over
            controller.queue = WorkQueue(
                base_backoff=controller.queue.base_backoff,
                max_backoff=controller.queue.max_backoff,
                num_shards=self.num_shards,
            )
        self.controllers.append(controller)
        self._dispatch = None  # rebuilt on next routing

    def _build_dispatch(self):
        """kind -> [(ctrl, map_fn, predicate, metric_name)] in registration
        order (primary entry first per controller, map_fn=None)."""
        dispatch: dict = {}
        for ctrl in self.controllers:
            dispatch.setdefault(ctrl.kind, []).append(
                (ctrl, None, None, f"events_enqueued/{ctrl.name}/self")
            )
            for watch in ctrl.watches:
                watched_kind, map_fn = watch[0], watch[1]
                pred = watch[2] if len(watch) > 2 else None
                dispatch.setdefault(watched_kind, []).append(
                    (ctrl, map_fn, pred, f"events_enqueued/{ctrl.name}/{watched_kind}")
                )
        self._dispatch = dispatch
        return dispatch

    # -- event delivery --------------------------------------------------

    def hold_events(self, kind: str) -> None:
        """Delay delivery of a kind's watch events (that kind's informer
        falls behind): tests use it to surface staleness races."""
        self.held_kinds.add(kind)

    def release_events(self, kind: str) -> None:
        self.held_kinds.discard(kind)

    def discard_pending_events(self) -> int:
        """Drop undelivered watch events (a standby that never drains)."""
        n = 0
        for backlog in self._backlogs:
            n += len(backlog)
            backlog.clear()
        return n

    def requeue_all(self) -> None:
        """Enqueue every live object of every controller's kind (the resync
        a fresh leader runs)."""
        for ctrl in self.controllers:
            for obj in self.store.scan(ctrl.kind):
                ctrl.queue.add((ctrl.kind, obj.metadata.namespace, obj.metadata.name))

    def _route_events(self) -> None:
        if not self._router_lock.acquire(blocking=False):
            raise RuntimeError(
                "concurrent event routing: the engine's rotation pointers assume a"
                " single drainer; route and drain only from the coordinator"
            )
        prof = PROFILER.phase(PHASE_DEQUEUE, controller="engine") if PROFILER.enabled else None
        try:
            self._route_events_inner()
        finally:
            if prof is not None:
                prof.end()
            self._router_lock.release()

    def _next_event(self) -> Optional[WatchEvent]:
        """The next backlog event: a plain popleft when unsharded, else a
        deterministic round-robin over the shards' backlogs (the rotation
        moves past each shard served)."""
        if self.num_shards == 1:
            backlog = self._event_backlog
            return backlog.popleft() if backlog else None
        for off in range(self.num_shards):
            idx = (self._backlog_rotation + off) % self.num_shards
            backlog = self._backlogs[idx]
            if backlog:
                self._backlog_rotation = (idx + 1) % self.num_shards
                return backlog.popleft()
        return None

    def _route_events_inner(self) -> None:
        # pop one at a time: reconciles emit new events while we iterate
        remaining: List[WatchEvent] = []
        while True:
            ev = self._next_event()
            if ev is None:
                break
            if ev.kind in self.held_kinds:
                remaining.append(ev)
                continue
            # a kind's cache advances exactly when its events are delivered;
            # held kinds stay stale
            if self.store.cache_lag:
                self.store.apply_event_to_cache(ev)
            dispatch = self._dispatch
            if dispatch is None:
                dispatch = self._build_dispatch()
            for ctrl, map_fn, pred, metric in dispatch.get(ev.kind, ()):
                if map_fn is None:
                    if ctrl.primary_predicate is None or ctrl.primary_predicate(ev):
                        METRICS.inc(metric)
                        ctrl.queue.add((ctrl.kind, ev.obj.metadata.namespace, ev.obj.metadata.name))
                    continue
                if pred is not None and not pred(ev):
                    continue
                hits = map_fn(ev)
                if hits:
                    METRICS.inc(metric, len(hits))
                for ns, name in hits:
                    ctrl.queue.add((ctrl.kind, ns, name))
        for ev in remaining:
            # held events return to their shard's backlog
            self._backlogs[ev.shard if self.num_shards > 1 else 0].append(ev)

    # -- run loop --------------------------------------------------------

    def _complete(self, ctrl: Controller, key, result, error, now) -> None:
        """Work-queue bookkeeping for a finished reconcile."""
        if error is not None:
            METRICS.inc(f"reconcile_panics_total/{ctrl.name}")
            if FLIGHTREC.enabled:
                FLIGHTREC.note_error(ctrl.name, key, error)
                if isinstance(error, GroveError):
                    FLIGHTREC.trigger(
                        "reconcile-grove-error",
                        f"{ctrl.name} {key[1]}/{key[2]}: {error}",
                    )
            ctrl.queue.add_rate_limited(key, now)
            return
        if result.result == "requeue":
            METRICS.inc(f"reconcile_errors_total/{ctrl.name}")
            ctrl.queue.add_rate_limited(key, now)
        elif result.result == "requeue_after":
            ctrl.queue.forget(key)
            ctrl.queue.add_after(key, result.requeue_after or 0.0, now)
        else:
            ctrl.queue.forget(key)

    def drain(self, max_rounds: int = 10_000) -> int:
        """Process until no controller has a ready item at the current time.
        Returns the number of reconciles executed. With workers armed the
        rounds run through the parallel executor."""
        if self.workers is not None:
            if not PROFILER.enabled:
                return self.workers.drain(max_rounds)
            with PROFILER.phase(PHASE_DRAIN, controller="engine"):
                return self.workers.drain(max_rounds)
        if not PROFILER.enabled:
            return self._drain_rounds(max_rounds)
        with PROFILER.phase(PHASE_DRAIN, controller="engine"):
            return self._drain_rounds(max_rounds)

    def _execute_batch(self, ctrl: Controller, batch: List[Key], now) -> None:
        """Reconcile each popped key in pop order."""
        for key in batch:
            result = error = None
            try:
                result = self._timed(ctrl, key)
            except Exception as e:
                error = e
            self._complete(ctrl, key, result, error, now)

    def _drain_rounds(self, max_rounds: int, execute_batch=None) -> int:
        """The round loop of the serial and the parallel drains (which pass
        their own ``execute_batch``): route, pop each controller's whole
        ready set in deterministic order, execute, publish gauges,
        quiesce."""
        if execute_batch is None:
            execute_batch = self._execute_batch
        executed = 0
        now = self.clock.now()
        for _ in range(max_rounds):
            self._route_events()
            if self.round_hook is not None:
                # routing is the round's cache-advance boundary
                self.round_hook()
            progressed = False
            for ctrl in self.controllers:
                # batched: the whole ready set up front (events these
                # reconciles emit route at the next round), so sibling
                # updates coalesce into one owner requeue
                batch: List[Key] = []
                while True:
                    key = ctrl.queue.pop(now)
                    if key is None:
                        break
                    batch.append(key)
                if not batch:
                    continue
                progressed = True
                executed += len(batch)
                METRICS.inc(f"reconcile_total/{ctrl.name}", len(batch))
                span = None
                if TRACER.enabled:
                    attrs = {"controller": ctrl.name, "keys": len(batch)}
                    if self.workers is not None:
                        attrs["workers"] = self.workers.workers
                    span = TRACER.span("reconcile.batch", **attrs)
                if ctrl.batch_hook is not None:
                    # built on the coordinator before any worker reads it
                    ctrl.batch_hook(batch)
                try:
                    execute_batch(ctrl, batch, now)
                finally:
                    if span is not None:
                        span.end()
            for ctrl in self.controllers:
                METRICS.set(f"workqueue_depth/{ctrl.name}", len(ctrl.queue))
            self._set_backlog_gauges()
            if not progressed:
                # new events may have landed during the last round
                self._route_events()
                if all(c.queue.empty(now) for c in self.controllers):
                    return executed
        raise RuntimeError(
            f"engine did not quiesce within {max_rounds} rounds (reconcile livelock?)"
        )

    def _set_backlog_gauges(self) -> None:
        """Each shard's backlog depth, once per drain round (sharded only)."""
        if self.num_shards > 1:
            for idx, backlog in enumerate(self._backlogs):
                METRICS.set(f"engine_shard_backlog@{idx}", len(backlog))

    def _timed(self, ctrl: Controller, key):
        t0 = time.perf_counter()
        span = None
        if TRACER.enabled:
            # every span opened inside the reconcile carries its shard
            TRACER.set_shard(self._shard_of_key(key))
            span = TRACER.span("engine.reconcile", controller=ctrl.name, key=f"{key[1]}/{key[2]}")
        prof = PROFILER.reconcile(ctrl.name, self._shard_of_key(key)) if PROFILER.enabled else None
        outcome = "error"
        try:
            result = ctrl.reconcile(key)
            outcome = result.result if result is not None else "done"
            return result
        finally:
            if prof is not None:
                prof.end()
            if span is not None:
                span.set("outcome", outcome)
                span.end()
                TRACER.set_shard(None)
            METRICS.observe(f"reconcile_seconds/{ctrl.name}", time.perf_counter() - t0)

    def _shard_of_key(self, key) -> int:
        if self._shard_index is None:
            return NO_SHARD
        return self._shard_index(key[1])

    def close(self) -> None:
        """Release the parallel drain's executor (its threads, or its live
        worker generation) and disarm it."""
        if self.workers is not None:
            self.workers.close()
            self.workers = None

    def advance(self, seconds: float) -> None:
        self.clock.advance(seconds)  # type: ignore[attr-defined]

    def advance_and_drain(self, seconds: float) -> int:
        """Advance virtual time, then drain (fires due requeue_after
        items)."""
        self.advance(seconds)
        return self.drain()

    def next_wakeup(self) -> Optional[float]:
        """Earliest scheduled requeue across controllers (None if idle)."""
        times = [t for c in self.controllers if (t := c.queue.next_delayed_at()) is not None]
        return min(times) if times else None

    def run_until_idle(self, max_virtual_seconds: float = 3600.0) -> int:
        """Drain, then keep advancing virtual time to the next scheduled
        requeue until nothing is pending or the budget is spent."""
        total = self.drain()
        budget_end = self.clock.now() + max_virtual_seconds
        while True:
            wake = self.next_wakeup()
            if wake is None or wake > budget_end:
                return total
            if wake > self.clock.now():
                self.advance(wake - self.clock.now())
            total += self.drain()
