"""The port's thread drain (``runtime/workers.py``) against the JAX
package's, on the CPU.

Each case runs ``tests/test_workers.py``'s scenario (same shapes and seeds)
through both packages (``tests/torch_cp_sides.py``) and compares what it
reads: the serial-twin A/B reports less busy times (``problems`` empty in
both), the WAL acked prefixes, the crash audits and durable states, each
shard's reconcile order, the deferred consumers' delivery order, the
pending-namespace gauges, the Event sequence under threads and the worker
sweep's rows less times.
"""

import threading

import pytest

from tests.torch_cp_sides import both, cp_side, fresh

SWEEP_TIMES = ("wall_seconds", "control_plane_seconds", "us_per_reconcile", "speedup",
               "utilization")


def _ab(rep: dict) -> dict:
    rep = dict(rep)
    rep["worker_stats"] = {k: v for k, v in rep["worker_stats"].items()
                           if k != "busy_seconds_by_worker"}
    return rep


class TestSerialTwin:
    @pytest.mark.parametrize("workers,seed", [(2, 1234), (4, 7), (8, 2026)])
    def test_storm_equivalence(self, workers, seed):
        def run(side):
            rep = _ab(side.parallel.parallel_ab(
                n_sets=12, n_nodes=16, num_shards=5, workers=workers, seed=seed, storm_rounds=1,
                **side.kw))
            # the harness arms the overlap pump; only the process drain calls it
            c = side.METRICS.counters
            assert c.get("cp_overlap_hits_total", 0) + c.get("cp_overlap_stale_total", 0) == 0
            return rep

        jax, port = both(run)
        assert port == jax
        assert port["identical"] and port["problems"] == []
        assert port["boundaries_compared"] == 2
        assert all(s == p for s, p in port["reconciles"])
        assert len([n for n in port["worker_stats"]["reconciles_by_worker"] if n > 0]) >= 2

    def test_wal_acked_prefixes_identical(self, tmp_path):
        def run(side):
            dirs = (str(tmp_path / side.root / "s"), str(tmp_path / side.root / "w"))
            rep = _ab(side.parallel.parallel_ab(n_sets=12, n_nodes=16, num_shards=3, workers=4,
                                                storm_rounds=1, wal_dirs=dirs, **side.kw))
            return rep, side.parallel.durable_state_normalized(dirs[1])

        (jax, jstate), (port, pstate) = both(run)
        assert port == jax and pstate == jstate
        assert port["identical"] and port["wal_acked_identical"] is True

    def test_crash_recovery_with_workers(self, tmp_path):
        def run(side):
            tenants = side.scale.tenant_namespaces(6)
            runs = {}
            for workers in (1, 4):
                directory = str(tmp_path / side.root / str(workers))
                h = side.parallel._make_harness(16, 3, workers, directory, **side.kw)
                side.parallel._populate(h, 10, tenants)
                h.converge(max_ticks=200)
                lost = h.durability.simulate_crash(torn_tail_bytes=23)
                recovered, report = side.durability.recover_store(directory, clock=h.clock,
                                                                  cache_lag=True)
                runs[workers] = {
                    "audit": side.durability.verify_acked_prefix(directory, recovered),
                    "torn_tail": report.torn_tail, "lost": lost,
                    "replayed": report.replayed_records,
                    "durable": side.parallel.durable_state_normalized(directory)}
                h.engine.close()
            return runs

        jax, port = both(run)
        assert port == jax
        assert port[1]["durable"] == port[4]["durable"]
        assert all(r["audit"] == [] and r["torn_tail"] for r in port.values())


def _spread_namespaces(side, num_shards, want=3):
    by_shard, i = {}, 0
    while len(by_shard) < want:
        by_shard.setdefault(side.shard_of(f"ns-{i}", num_shards), f"ns-{i}")
        i += 1
    return list(by_shard.values())


def _engine_with_tracker(side, num_shards, workers):
    store = side.Store(side.VirtualClock(), cache_lag=True, num_shards=num_shards)
    engine = side.Engine(store, store.clock)
    if workers > 1:
        assert engine.enable_workers(workers)
    order, lock = [], threading.Lock()

    def reconcile(key):
        with lock:
            order.append(key)
        return side.continue_reconcile()

    engine.register(side.Controller(name="track", kind="Service", reconcile=reconcile))
    return store, engine, order


def _traffic(side, store, namespaces, per_ns=5):
    for i in range(per_ns):
        for ns in namespaces:
            store.create(side.types.GenericObject(
                kind="Service", metadata=side.ObjectMeta(name=f"svc-{i}", namespace=ns),
                spec={"i": i}))


class TestCoordinationPlane:
    def test_per_shard_order_matches_serial_projection(self):
        def run(side):
            namespaces = _spread_namespaces(side, 4)
            runs = {}
            for workers in (1, 4):
                store, engine, order = _engine_with_tracker(side, 4, workers)
                _traffic(side, store, namespaces)
                engine.drain()
                runs[workers] = {ns: [k for k in order if k[1] == ns] for ns in namespaces}
                runs[f"{workers} sorted"] = sorted(order)
                engine.close()
            return runs

        jax, port = both(run)
        assert port == jax
        assert port[1] == port[4] and port["1 sorted"] == port["4 sorted"]

    def test_concurrent_routing_raises(self):
        def run(side):
            store, engine, _ = _engine_with_tracker(side, 3, 1)
            engine._router_lock.acquire()
            try:
                with pytest.raises(RuntimeError, match="single drainer"):
                    engine._route_events()
            finally:
                engine._router_lock.release()
            engine._route_events()
            engine.close()
            return True

        assert both(run) == [True, True]

    def test_deferred_consumers_replayed_in_serial_order(self):
        def run(side):
            namespaces = _spread_namespaces(side, 3)
            runs = {}
            for workers in (1, 4):
                store, engine, _ = _engine_with_tracker(side, 3, workers)
                seen = []
                store.subscribe_system_per_shard(lambda ev, _seen=seen: _seen.append(
                    (ev.type, ev.obj.metadata.namespace, ev.obj.metadata.name)))

                def reconcile(key, _store=store):
                    _kind, ns, name = key
                    if _store.get("Shadow", ns, f"shadow-{name}") is None:
                        _store.create(side.types.GenericObject(
                            kind="Shadow",
                            metadata=side.ObjectMeta(name=f"shadow-{name}", namespace=ns),
                            spec={}))
                    return side.continue_reconcile()

                engine.controllers[0].reconcile = reconcile
                _traffic(side, store, namespaces, per_ns=3)
                engine.drain()
                runs[workers] = seen
                engine.close()
            return runs

        jax, port = both(run)
        assert port == jax and port[1] == port[4]

    def test_enable_workers_requires_sharded_capture_store(self):
        def run(side):
            store = side.Store(side.VirtualClock(), cache_lag=True, num_shards=1)
            engine = side.Engine(store, store.clock)
            out = [engine.enable_workers(4), engine.workers]
            sharded = side.Store(side.VirtualClock(), cache_lag=True, num_shards=4)
            engine4 = side.Engine(sharded, sharded.clock)
            out += [engine4.enable_workers(4), type(engine4.workers).__name__,
                    engine4.workers.workers, engine4.enable_workers(4, backend="process"),
                    type(engine4.workers).__name__]
            engine4.close()
            out.append(engine4.workers)
            thread = side.Engine(side.Store(side.VirtualClock(), num_shards=4))
            out += [thread.enable_workers(4, backend="process"), type(thread.workers).__name__,
                    thread.workers.backend]
            thread.close()
            return out

        jax, port = both(run)
        assert port == jax
        assert port == [False, None, True, "ParallelDrain", 4, True, "ParallelDrain", None,
                        True, "ProcessDrain", "process"]

    def test_env_opt_in(self, monkeypatch):
        monkeypatch.setenv("GROVE_TPU_CP_WORKERS", "3")

        def run(side):
            store = side.Store(side.VirtualClock(), cache_lag=True, num_shards=4)
            engine = side.Engine(store, store.clock)
            out = [engine.workers.workers, engine.workers.backend]
            engine.close()
            monkeypatch.setenv("GROVE_TPU_CP_BACKEND", "process")
            engine = side.Engine(side.Store(side.VirtualClock(), num_shards=4))
            out += [engine.workers.workers, engine.workers.backend]
            engine.close()
            monkeypatch.delenv("GROVE_TPU_CP_BACKEND")
            return out + [engine.workers]

        jax, port = both(run)
        assert port == jax == [3, "thread", 3, "process", None]

    def test_pending_namespaces_gauge_semantics_under_workers(self):
        tenants = ["tenant-000", "tenant-001", "tenant-002"]

        def run(side):
            readings = {}
            for workers in (1, 4):
                side.METRICS.reset()
                h = side.parallel._make_harness(16, 4, workers, **side.kw)
                side.parallel._populate(h, 8, tenants)
                h.converge(max_ticks=120)
                readings[workers] = {k: v for k, v in side.METRICS.gauges.items()
                                     if k.startswith("pending_namespaces@")}
                h.engine.close()
            return readings

        jax, port = both(run)
        assert port == jax and port[1] == port[4] and port[4]
        side = cp_side("grove_tpu_torch")
        expected = {}
        for ns in tenants:
            expected[side.shard_of(ns, 4)] = expected.get(side.shard_of(ns, 4), 0) + 1
        for idx in range(4):
            assert port[4].get(f"pending_namespaces@{idx}", 0) == expected.get(idx, 0)


class TestThreadSafetyAudit:
    def test_event_seq_atomic_under_threads(self):
        def run(side):
            store = side.Store(side.Clock())
            ctx = side.OperatorContext(store=store, clock=store.clock)
            threads = [threading.Thread(target=lambda: [
                ctx.record_event("PodGang", "GangAdmitted", f"m-{i}") for i in range(50)])
                for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return [len(list(store.scan("Event"))), ctx._event_seq]

        assert both(run) == [[400, 400], [400, 400]]

    def test_desired_memo_locked(self):
        def run(side):
            ctx = side.OperatorContext(store=side.Store(side.Clock()), clock=side.Clock())
            ctx._desired_memo_max = 64
            errors = []

            def hammer(tid):
                try:
                    for i in range(400):
                        ctx.desired_cache(("kind", tid, i % 96), lambda: object())
                except Exception as e:  # pragma: no cover - the failure mode
                    errors.append(e)

            threads = [threading.Thread(target=hammer, args=(t,)) for t in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return errors

        assert both(run) == [[], []]

    def test_worker_span_context(self):
        def run(side):
            tracer = side.TRACER
            tracer.enabled = True
            try:
                tracer.set_worker(3)
                with tracer.span("test.worker") as span:
                    pass
                tracer.set_worker(None)
                with tracer.span("test.coordinator") as plain:
                    pass
                return [span.attrs.get("worker"), "worker" in plain.attrs]
            finally:
                tracer.set_worker(None)
                tracer.enabled = False
                tracer.reset()

        assert both(run) == [[3, False], [3, False]]

    def test_registry_and_sequence_rebase(self):
        """The live-context registry the process drain reads, and the
        Event-name range a forked worker moves into."""
        def run(side):
            common = __import__(f"{side.root}.controller.common", fromlist=["x"])
            store = side.Store(side.Clock())
            a = side.OperatorContext(store=store, clock=store.clock)
            b = side.OperatorContext(store=store, clock=store.clock)
            other = side.OperatorContext(store=side.Store(side.Clock()), clock=store.clock)
            mine = common.contexts_of_store(store)
            a.record_event("PodGang", "GangAdmitted", "m")
            common.rebase_event_sequences(0)
            seqs = [a._event_seq, b._event_seq]
            common.rebase_event_sequences(2)
            out = [mine == [a, b], other not in mine, seqs,
                   [a._event_seq, b._event_seq, other._event_seq]]
            common.rebase_event_sequences(-1)
            return out

        jax, port = both(run)
        assert port == jax
        stride = 10_000_000
        assert port[:3] == [True, True, [1, 0]] and port[3][:2] == [1 + 2 * stride, 2 * stride]


class TestWorkerSweep:
    def test_sweep_reports_all_arms(self):
        def run(side):
            rep = side.parallel.worker_sweep(n_sets=8, n_nodes=16, num_shards=4,
                                              worker_counts=(1, 2), **side.kw)
            assert "utilization" in rep["sweep"][1]
            rep["sweep"] = [{k: v for k, v in row.items() if k not in SWEEP_TIMES}
                            for row in rep["sweep"]]
            return rep

        jax, port = both(run)
        assert port == jax
        assert [row["workers"] for row in port["sweep"]] == [1, 2]
        assert all(row["all_ready"] and row["reconciles"] > 0 for row in port["sweep"])
        assert len({row["reconciles"] for row in port["sweep"]}) == 1
