"""Concurrent control-plane executor: per-shard reconcile workers.

Counterpart of ``grove_tpu/runtime/workers.py``. Keyspace sharding gives
per-shard locks, backlogs and WAL streams; this module makes the S store
shards the ownership boundaries of N concurrent reconcile workers.

Ownership boundaries
--------------------

``worker_of(shard) = shard % workers``. Worker 0 IS the coordinator
thread — cluster-scoped shard 0 therefore always reconciles on the
coordination plane, which also runs everything that must stay
single-threaded: event routing, workqueue pops, completion bookkeeping,
the scheduler/solver, component ticks and WAL pumps. A worker owns, for
each of its shards: the shard's event backlog (drained only via the
coordinator's deterministic round-robin — see below), the shard's
workqueue buckets' keys, the reconcile bodies for those keys, and the
shard's WAL stream (fed from the per-shard watch fan-out by the
worker's own commits; flushed by the coordinator's pump at tick
boundaries).

Determinism (the serial-twin contract, sim/parallel.py)
-------------------------------------------------------

The parallel drain reproduces the serial drain's schedule EXACTLY,
shard by shard:

1. Event routing and workqueue pops run ONLY on the coordinator, using
   the same rotation pointers as the serial drain — so each round's
   batch (per controller) is byte-identical to what the serial drain
   would pop. ``Engine._route_events`` asserts single-drainer ownership
   (the rotation pointer assumes one drainer; that is now a checked
   contract, not an accident).
2. The batch is partitioned by owning shard, order-preserving, and each
   worker executes its sub-sequence in order. Within a shard, the
   reconcile order therefore equals the serial drain's per-shard
   projection; reconciles of ONE shard only write to that shard (plus
   best-effort Event objects — see the audit in docs/control-plane.md
   §5), so each shard's commit order, rv sequence, watch stream and WAL
   record stream are identical to the serial run's.
3. Order-sensitive CROSS-shard consumers (the delta-solve state and the
   quota accountant, registered via ``subscribe_system_per_shard``) are
   not fed live from worker threads: the store captures their
   deliveries per reconcile (``Store.arm_deferred_fanout``), and the
   coordinator replays the per-reconcile groups in batch order — which
   is exactly the serial drain's global delivery order (each serial
   reconcile's commits form a contiguous group in pop order).
4. Completion bookkeeping (requeue/backoff/forget) runs on the
   coordinator in batch order with the round's frozen ``now`` — the
   serial semantics verbatim.

``sim/parallel.py`` pins the contract end-to-end: the same event
schedule through the serial drain and the worker drain must produce
identical admissions, reconcile counts, store content and per-shard WAL
acked prefixes (``parallel_ab``).

Threads vs processes
--------------------

Workers are threads. On free-threaded builds (and for the C-heavy
slices of the reconcile path — pickling, fsync, numpy — even under the
GIL) they overlap for real; on GIL builds the drain stays correct and
deterministic with bounded overhead, which is what the worker-count
sweep (``sim/parallel.worker_sweep``) reports. The worker-PROCESS
backend (runtime/procworkers.py, GROVE_TPU_CP_BACKEND=process) shares
this module's ownership map and coordination points and crosses its
boundary only through the wire codec — the thread executor here is the
semantic contract both backends meet, pinned by the serial-twin A/B at
both backend settings.

Worker-pool internals are private to runtime/: per-shard state may only be touched from its
owning worker context or at the documented coordination points.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.tracing import TRACER


def workers_from_env() -> int:
    """The opt-in knob: GROVE_TPU_CP_WORKERS=N (0/1/unset = serial)."""
    try:
        return int(os.environ.get("GROVE_TPU_CP_WORKERS", "1") or 1)
    except ValueError:
        return 1


class ParallelDrain:
    """Worker-thread drain for one Engine (docs/control-plane.md §5).

    Built by ``Engine.enable_workers(n)``; owns the worker pool and the
    shard → worker map. The engine's ``drain()`` delegates here when
    armed. Lifetime: the pool is engine-lifetime (``close()`` releases
    it with ``Engine.close()``)."""

    backend = "thread"

    def __init__(self, engine, workers: int) -> None:
        self.engine = engine
        # clamp to the shard count: `worker_of = shard % W` can never
        # route work to workers beyond S, so extra threads would sit
        # idle forever while gauges/sweep rows report a fiction
        self.workers = max(2, min(int(workers), engine.num_shards))
        # worker 0 is the coordinator thread itself; the pool holds the
        # other W-1 workers
        self._pool = ThreadPoolExecutor(
            max_workers=self.workers - 1, thread_name_prefix="cp-worker"
        )
        # lifetime counters (the scale report's "parallel" block)
        self.reconciles_by_worker = [0] * self.workers
        self._worker_busy_s = [0.0] * self.workers
        METRICS.set("cp_workers", self.workers)
        METRICS.set("cp_backend_process", 0)

    # -- ownership map ---------------------------------------------------

    def worker_of(self, shard: int) -> int:
        """Owning worker of a keyspace shard. Shard 0 (cluster-scoped
        keys) maps to worker 0 — the coordination plane."""
        if shard < 0:
            return 0
        return shard % self.workers

    def busy_snapshot(self) -> List[float]:
        """Copy of the per-worker busy-second accumulators — callers that
        measure a WINDOW (the glassbox converge, whose attribution
        cross-check covers converge only) snapshot before and diff after,
        instead of dividing lifetime busy by a window wall."""
        return list(self._worker_busy_s)

    def utilization(
        self, wall_seconds: float, since: List[float] = None
    ) -> List[float]:
        """Per-worker busy share of a measured wall (the
        per-worker utilization rows; >1.0 impossible per worker, but the
        SUM exceeding 1.0 is exactly the parallelism win). ``since``:
        a `busy_snapshot()` taken at the window start."""
        if wall_seconds <= 0:
            return [0.0] * self.workers
        base = since or [0.0] * self.workers
        return [
            round((b - b0) / wall_seconds, 4)
            for b, b0 in zip(self._worker_busy_s, base)
        ]

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    # -- drive -----------------------------------------------------------

    def drain(self, max_rounds: int) -> int:
        """The parallel drain IS the engine's shared round loop
        (``Engine._drain_rounds``: route → pop in deterministic order →
        execute → gauges → quiesce) with this executor substituted for
        the serial per-key loop — one loop implementation, so the serial
        and parallel drains cannot structurally drift."""
        return self.engine._drain_rounds(
            max_rounds, execute_batch=self._run_batch
        )

    def _run_batch(self, ctrl, batch: List, now: float) -> None:
        """One controller's round batch: partition by owning worker
        (order-preserving), execute groups concurrently, then do the
        completion bookkeeping and the deferred-consumer replay on the
        coordinator in batch order — the serial drain's order."""
        eng = self.engine
        groups: Dict[int, List] = {}
        for key in batch:
            w = self.worker_of(eng._shard_of_key(key))
            groups.setdefault(w, []).append(key)
        futures = {
            w: self._pool.submit(self._run_group, ctrl, keys, w)
            for w, keys in groups.items()
            if w != 0
        }
        outcomes: Dict[tuple, tuple] = {}
        if 0 in groups:
            # the coordinator IS worker 0 (shard 0's coordination plane)
            outcomes.update(self._run_group(ctrl, groups[0], 0))
        for fut in futures.values():
            outcomes.update(fut.result())
        # coordination point: bookkeeping + replay in serial batch order
        deferred = []
        for key in batch:
            result, error, captured = outcomes[key]
            eng._complete(ctrl, key, result, error, now)
            if captured:
                deferred.extend(captured)
        for fn, ev in deferred:
            fn(ev)

    def _run_group(self, ctrl, keys: List, worker: int) -> Dict[tuple, tuple]:
        """One worker's sub-sequence of the batch, in batch order.
        Returns key -> (result, error, captured deferred deliveries)."""
        import time as _time

        eng = self.engine
        store = eng.store
        t0 = _time.perf_counter()
        if TRACER.enabled:
            TRACER.set_worker(worker)
        out: Dict[tuple, tuple] = {}
        try:
            for key in keys:
                buf = store.begin_deferred_capture()
                result = error = None
                try:
                    result = eng._timed(ctrl, key)
                except Exception as e:  # RecoverPanic parity with _complete
                    error = e
                finally:
                    captured = store.end_deferred_capture(buf)
                out[key] = (result, error, captured)
        finally:
            if TRACER.enabled:
                TRACER.set_worker(None)
            busy = _time.perf_counter() - t0
            self._worker_busy_s[worker] += busy
            self.reconciles_by_worker[worker] += len(keys)
            METRICS.inc(f"cp_worker_reconciles@{worker}", len(keys))
        return out

    # -- reporting -------------------------------------------------------

    def stats(self) -> dict:
        """Lifetime counters (the "parallel" block)."""
        return {
            "backend": self.backend,
            "workers": self.workers,
            "reconciles_by_worker": list(self.reconciles_by_worker),
            "busy_seconds_by_worker": [
                round(b, 3) for b in self._worker_busy_s
            ],
        }
