"""The port's process drain (``runtime/procworkers.py``) and the overlap
pump against the JAX package's, on the CPU.

Each case runs ``tests/test_procworkers.py``'s scenario (same shapes and
seeds) through both packages (``tests/torch_cp_sides.py``) and compares
what it reads: the serial-twin A/B reports less busy times and boundary
bytes (which carry each reply's timing), ``problems`` empty in both; the
durable states a crash over worker-written WALs recovers; the shutdown;
the SIGKILLed worker's repatriation and its store against the serial
twin; the overlap pump's speculated spec, hits and stale fallbacks. Then
the boundary-fault run and the reflective decoder of the codec A/B's "off"
arm.
"""

import multiprocessing

import pytest

from tests.torch_cp_sides import both

TIMED_STATS = ("busy_seconds_by_worker", "boundary_bytes")


def _stats(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k not in TIMED_STATS}


def _ab(rep: dict) -> dict:
    rep = dict(rep)
    rep["worker_stats"] = _stats(rep["worker_stats"])
    return rep


class TestProcessSerialTwin:
    @pytest.mark.parametrize("workers,seed", [(2, 1234), (4, 7), (4, 2026)])
    def test_storm_equivalence(self, workers, seed):
        def run(side):
            rep = side.parallel.parallel_ab(n_sets=8, n_nodes=16, num_shards=5,
                                            workers=workers, seed=seed, storm_rounds=1,
                                            backend="process", **side.kw)
            assert rep["worker_stats"]["boundary_bytes"] > 0
            # the harness armed the overlap pump; the process drain called it
            return _ab(rep), _overlap(side)

        (jax, jpump), (port, pump) = both(run)
        assert port == jax and pump == jpump and sum(pump) > 0
        assert port["identical"] and port["problems"] == []
        assert port["boundaries_compared"] == 2
        assert all(s == p for s, p in port["reconciles"])
        stats = port["worker_stats"]
        assert stats["backend"] == "process" and stats["worker_crashes"] == 0
        assert sum(stats["reconciles_by_worker"][1:]) > 0

    def test_wal_acked_prefixes_identical(self, tmp_path):
        def run(side):
            dirs = (str(tmp_path / side.root / "s"), str(tmp_path / side.root / "w"))
            rep = _ab(side.parallel.parallel_ab(n_sets=12, n_nodes=16, num_shards=3, workers=2,
                                                storm_rounds=1, wal_dirs=dirs,
                                                backend="process", **side.kw))
            return rep, side.parallel.durable_state_normalized(dirs[1])

        (jax, jstate), (port, pstate) = both(run)
        assert port == jax and pstate == jstate
        assert port["identical"] and port["wal_acked_identical"] is True


class TestCrashRecovery:
    def test_cold_restart_over_worker_written_wals(self, tmp_path):
        def run(side):
            tenants = side.scale.tenant_namespaces(6)
            runs = {}
            for workers in (1, 2):
                directory = str(tmp_path / side.root / str(workers))
                h = side.parallel._make_harness(16, 3, workers, directory, backend="process",
                                                **side.kw)
                side.parallel._populate(h, 10, tenants)
                h.converge(max_ticks=200)
                sig = side.resource_signature(h.store)
                h.durability.simulate_crash(torn_tail_bytes=23)
                h.engine.close()
                recovered, report = side.durability.recover_store(directory, clock=h.clock,
                                                                  cache_lag=True)
                audit = side.durability.verify_acked_prefix(directory, recovered)
                durable = side.parallel.durable_state_normalized(directory)
                restarted = side.SimHarness.cold_restart(
                    recovered, h.cluster.nodes, config=h.config, durability_dir=directory,
                    **side.kw)
                restarted.engine.enable_workers(workers, backend="process")
                ticks = restarted.converge(max_ticks=200)
                runs[workers] = {"audit": audit, "torn_tail": report.torn_tail,
                                 "durable": durable, "ticks": ticks,
                                 "same_tree": side.resource_signature(restarted.store) == sig}
                restarted.durability.close()
                restarted.engine.close()
            return runs

        jax, port = both(run)
        assert port == jax
        assert port[1]["durable"] == port[2]["durable"]
        assert all(r["audit"] == [] and r["torn_tail"] and r["same_tree"]
                   for r in port.values())


class TestShutdown:
    def test_clean_shutdown_leaves_no_orphans(self):
        def run(side):
            h = side.parallel._make_harness(16, 3, 2, backend="process", **side.kw)
            side.parallel._populate(h, 6, side.scale.tenant_namespaces(3))
            h.converge(max_ticks=200)
            drain = h.engine.workers
            out = [drain is not None, drain.active]
            h.engine.close()
            h.engine.close()  # idempotent
            out += [drain._procs, h.store._process_drain, h.engine.round_hook,
                    [p.name for p in multiprocessing.active_children()
                     if p.name.startswith("cp-worker-")]]
            return out

        assert both(run) == [[True, False, {}, None, None, []]] * 2


class TestWorkerCrash:
    def test_sigkill_mid_round_reexecutes_deterministically(self):
        def run(side):
            tenants = side.scale.tenant_namespaces(4)
            serial = side.parallel._make_harness(16, 3, 1, **side.kw)
            side.parallel._populate(serial, 8, tenants)
            serial.converge(max_ticks=200)
            h = side.parallel._make_harness(16, 3, 2, backend="process", **side.kw)
            h.engine.workers.chaos_kill_worker = 1
            side.parallel._populate(h, 8, tenants)
            h.converge(max_ticks=200)
            out = {"stats": _stats(h.engine.workers.stats()),
                   "crashes": side.METRICS.counters.get("cp_worker_crashes_total", 0),
                   "same": side.parallel._dump(h) == side.parallel._dump(serial),
                   "dump": side.parallel._dump(h)}
            h.engine.close()
            serial.engine.close()
            return out

        jax, port = both(run)
        assert port == jax
        assert port["stats"]["worker_crashes"] == 1 and port["crashes"] == 1 and port["same"]

    def test_boundary_faults_are_invisible(self):
        """Seeded drop, duplicate and delay on the wire: the retransmit and
        dedup path heals every frame, the store equals the serial twin's."""
        def run(side):
            tenants = side.scale.tenant_namespaces(4)
            dumps = []
            for workers in (1, 2):
                h = side.parallel._make_harness(16, 3, workers, backend="process", **side.kw)
                if workers > 1:
                    h.engine.workers.inject_boundary_faults(7, drop_rate=0.08, dup_rate=0.08,
                                                            delay_rate=0.08)
                side.parallel._populate(h, 4, tenants)
                h.converge(max_ticks=60)
                dumps.append(side.parallel._dump(h))
                counts = dict(h.engine.workers.boundary_fault_counts) if workers > 1 else None
                h.engine.close()
            return {"same": dumps[0] == dumps[1], "counts": counts, "dump": dumps[1]}

        jax, port = both(run)
        assert port == jax
        counts = port["counts"]
        assert port["same"] and counts["retransmits"] >= 1
        assert counts["drop"] + counts["dup"] + counts["delay"] >= 1


_BLOCKED_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: blocked
spec:
  replicas: 1
  template:
    cliques:
      - name: big
        spec:
          roleName: big
          replicas: 2
          podSpec:
            containers:
              - name: big
                image: busybox:stable
                resources:
                  requests:
                    cpu: 64
"""


def _blocked_harness(side):
    # cpu 64 fits no sim node: the gang stays pending, a stable set to
    # speculate on; the delta cache is off so the overlap entry is consumed
    h = side.parallel._make_harness(16, 3, 1, **side.kw)
    h.apply(side.load_podcliquesets(_BLOCKED_YAML)[0])
    for _ in range(6):
        h.engine.drain()
        h.schedule()
        h.cluster.kubelet_tick()
        h.clock.advance(1.0)
    h.scheduler.delta = None
    return h


def _overlap(side):
    c = side.METRICS.counters
    return [c.get("cp_overlap_hits_total", 0), c.get("cp_overlap_stale_total", 0)]


class TestOverlapPump:
    def test_speculated_spec_is_byte_identical(self):
        def run(side):
            h = _blocked_harness(side)
            sched = h.scheduler
            built = sched.speculate_encode()
            ((ns, gname), entry) = next(iter(sched._overlap_cache.items()))
            pods = [p for p in sched._pending_pods(ns)
                    if p.metadata.labels.get(side.LABEL_PODGANG) == gname]
            fresh = sched._build_gang_spec(ns, gname, pods)
            out = [built, fresh[0] == entry[2], dict(fresh[1]) == entry[3], entry[1],
                   sorted(entry[2])]
            h.engine.close()
            return out

        jax, port = both(run)
        assert port == jax and port[:3] == [1, True, True]

    def test_quiet_round_hits_and_keeps_entry(self):
        def run(side):
            h = _blocked_harness(side)
            h.scheduler.speculate_encode()
            out = [_overlap(side)]
            h.schedule()
            out.append(_overlap(side))
            h.schedule()
            out.append(_overlap(side))
            h.engine.close()
            return out

        jax, port = both(run)
        assert port == jax
        (h0, s0), (h1, s1), (h2, s2) = port
        assert (h1, s1) == (h0 + 1, s0) and (h2, s2) == (h0 + 2, s0)

    def test_forced_stale_falls_back_to_serial_reencode(self):
        def run(side):
            h = _blocked_harness(side)
            sched = h.scheduler
            sched.speculate_encode()
            key = next(iter(sched._overlap_cache))
            before = _overlap(side)
            h.store.create(side.types.GenericObject(
                kind="Service", metadata=side.ObjectMeta(name="stale-poke", namespace=key[0]),
                spec={}))
            h.schedule()
            out = [before, _overlap(side), key in sched._overlap_cache, sched.speculate_encode()]
            h.engine.close()
            return out

        jax, port = both(run)
        assert port == jax
        (h0, s0), (h1, s1), kept, rebuilt = port
        assert (h1, s1) == (h0, s0 + 1) and not kept and rebuilt == 1


def test_no_memo_decode_equals_the_memoized_one():
    """``api/wire.NO_MEMO`` (process_codec_ab's "off" arm) decodes every
    object of a converged store as the memoized decoder does, in both
    packages."""
    def run(side):
        wire = __import__(f"{side.root}.api.wire", fromlist=["x"])
        export = __import__(f"{side.root}.api.serialize", fromlist=["x"]).export_object
        h = side.parallel._make_harness(16, 3, 1, **side.kw)
        side.parallel._populate(h, 4, side.scale.tenant_namespaces(3))
        h.converge(max_ticks=60)
        docs = [export(o) for kind in h.store.kinds() if kind in wire.KIND_REGISTRY
                for o in h.store.scan(kind)]
        memo = [wire.decode_object(d) for d in docs]
        wire.NO_MEMO = True
        try:
            plain = [wire.decode_object(d) for d in docs]
        finally:
            wire.NO_MEMO = False
        h.engine.close()
        return [len(docs), plain == memo, sorted({d["kind"] for d in docs})]

    jax, port = both(run)
    assert port == jax and port[0] > 0 and port[1]
