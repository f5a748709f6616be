"""The port's durability layer against the JAX package's, on the CPU.

Each case runs one scenario (``tests/test_durability.py``'s, on the same
population and seeds) through both packages' own harness, store and
durability layer (``tests/torch_cp_sides.py``) and compares what it reads:
the crash and recovery reports less their wall times, the canonical dumps,
the resourceVersions, the acked-prefix audits, the torn-tail events, the
segments and snapshots on disk; the audits must be empty where the JAX
test wants them empty. The WAL is a file format, so it also crosses
packages: a log the JAX harness wrote recovers in the port to the JAX
store's dump, and one the port wrote replays in the JAX package to the
port store's.
"""

import os
import random

import pytest

from tests.torch_cp_sides import SIDES, both, cp_side, fresh


def _report(report) -> dict:
    doc = report.as_dict()
    doc.pop("wall_seconds")
    doc.pop("replay_records_per_sec")
    return doc


def converged_harness(side, wal_dir, n_sets=4, num_nodes=8):
    h = side.harness(num_nodes=num_nodes, durability_dir=wal_dir)
    side.recovery._populate(h, n_sets)
    h.converge(max_ticks=200)
    pods = h.store.list("Pod")
    assert pods and all(side.is_ready(p) for p in pods), h.tree()
    return h


def _dump(side, store):
    return side.store_dump(store, include_events=False)


def _canon(side, store):
    """The dump two packages compare: uids renumbered by position (each
    package draws its own random uid token)."""
    return side.store_dump(store, canonical_uids=True, include_events=False)


def _dirs(tmp_path):
    return {root: str(tmp_path / root) for root in SIDES}


def run_both(tmp_path, scenario):
    dirs = _dirs(tmp_path)
    return both(lambda side: scenario(side, dirs[side.root]))


class TestRecoveryRoundTrip:
    def test_crash_recover_is_exact(self, tmp_path):
        def scenario(side, wal_dir):
            h = converged_harness(side, wal_dir)
            pre = _dump(side, h.store)
            pre_rv = h.store.resource_version
            lost = h.durability.simulate_crash()
            store, report = side.durability.recover_store(wal_dir, clock=h.clock,
                                                          cache_lag=True)
            return {"exact": _dump(side, store) == pre, "rv": [pre_rv, store.resource_version],
                    "lost": lost, "report": _report(report), "objects": len(pre),
                    "audit": side.durability.verify_acked_prefix(wal_dir, store),
                    "dump": _canon(side, store)}

        jax, port = run_both(tmp_path, scenario)
        assert port == jax
        assert port["exact"] and port["rv"][0] == port["rv"][1]
        assert port["report"]["restored_objects"] == port["objects"]
        assert port["audit"] == []

    def test_unflushed_tail_rolls_back_to_acked_prefix(self, tmp_path):
        def scenario(side, wal_dir):
            h = converged_harness(side, wal_dir)
            acked_rv = h.durability.wal.durable_rv
            pcs = h.store.get("PodCliqueSet", "default", "svc-0000")
            pcs.spec.replicas = 7
            h.store.update(pcs)  # committed in memory, never pumped
            ahead = h.store.resource_version > acked_rv
            lost = h.durability.simulate_crash()
            store, _ = side.durability.recover_store(wal_dir, clock=h.clock)
            return {"ahead": ahead, "lost": lost, "acked": acked_rv,
                    "rv": store.resource_version,
                    "replicas": store.get("PodCliqueSet", "default", "svc-0000").spec.replicas,
                    "audit": side.durability.verify_acked_prefix(wal_dir, store)}

        jax, port = run_both(tmp_path, scenario)
        assert port == jax
        assert port["ahead"] and port["lost"] >= 1 and port["rv"] == port["acked"]
        assert port["replicas"] != 7 and port["audit"] == []

    def test_recovered_run_reconverges(self, tmp_path):
        def scenario(side, wal_dir):
            h = converged_harness(side, wal_dir)
            sig = side.resource_signature(h.store)
            h.durability.simulate_crash(torn_tail_bytes=29)
            store, report = side.durability.recover_store(wal_dir, clock=h.clock,
                                                          cache_lag=True)
            restarted = side.SimHarness.cold_restart(store, h.cluster.nodes, config=h.config,
                                                     durability_dir=wal_dir, **side.kw)
            ticks = restarted.converge(max_ticks=200)
            pods = restarted.store.list("Pod")
            out = {"ready": bool(pods) and all(side.is_ready(p) for p in pods),
                   "same_tree": side.resource_signature(restarted.store) == sig,
                   "ticks": ticks, "report": _report(report), "sig": sig,
                   "dump": _canon(side, restarted.store)}
            restarted.durability.close()
            return out

        jax, port = run_both(tmp_path, scenario)
        assert port == jax
        assert port["ready"] and port["same_tree"] and port["report"]["torn_tail"]

    def test_events_are_outside_the_contract(self, tmp_path):
        def scenario(side, wal_dir):
            h = converged_harness(side, wal_dir)
            h.durability.simulate_crash()
            store, _ = side.durability.recover_store(wal_dir, clock=h.clock)
            return store.kinds()

        jax, port = run_both(tmp_path, scenario)
        assert port == jax and "Event" not in port

    def test_verifier_catches_divergence(self, tmp_path):
        def scenario(side, wal_dir):
            h = converged_harness(side, wal_dir)
            h.durability.simulate_crash()
            store, _ = side.durability.recover_store(wal_dir, clock=h.clock)
            victim = next(store.scan("Service"))
            store.delete("Service", victim.metadata.namespace, victim.metadata.name)
            return side.durability.verify_acked_prefix(wal_dir, store)

        jax, port = run_both(tmp_path, scenario)
        assert port == jax
        assert any("acked commit lost" in p for p in port), port


class TestTornTail:
    def test_torn_tail_truncated_and_reported(self, tmp_path):
        def scenario(side, wal_dir):
            h = converged_harness(side, wal_dir)
            pre = _dump(side, h.store)
            side.EVENTS.reset()
            h.durability.simulate_crash(torn_tail_bytes=77)
            store, report = side.durability.recover_store(wal_dir, clock=h.clock)
            events = sorted(r.reason for r in side.EVENTS.list())
            # the tear was removed from disk: a second recovery reads a
            # clean log and lands on the same state
            store2, report2 = side.durability.recover_store(wal_dir, clock=h.clock)
            return {"report": _report(report), "report2": _report(report2), "events": events,
                    "exact": _dump(side, store) == pre, "exact2": _dump(side, store2) == pre}

        jax, port = run_both(tmp_path, scenario)
        assert port == jax
        assert port["report"]["torn_tail"] and not port["report2"]["torn_tail"]
        assert "WalTornTail" in port["events"] and "RecoveryCompleted" in port["events"]
        assert port["exact"] and port["exact2"]

    def test_garbage_mid_segment_cuts_the_prefix_there(self, tmp_path):
        def scenario(side, wal_dir):
            h = converged_harness(side, wal_dir, n_sets=2)
            h.durability.close()
            segs = side.wal.list_segments(wal_dir)
            path = segs[0][1]
            size = os.path.getsize(path)
            with open(path, "rb+") as fh:
                fh.seek(size // 2)
                fh.write(b"\xff\xff\xff\xff")
            store, report = side.durability.recover_store(wal_dir, clock=h.clock)
            return {"segments": len(segs), "size": size, "report": _report(report),
                    "audit": side.durability.verify_acked_prefix(wal_dir, store),
                    "dump": _canon(side, store)}

        jax, port = run_both(tmp_path, scenario)
        assert port == jax
        assert port["report"]["torn_tail"] and port["audit"] == []


class TestSnapshotsAndSegments:
    def test_rotation_snapshot_truncation(self, tmp_path):
        def scenario(side, wal_dir):
            h = side.harness(num_nodes=8, durability_dir=wal_dir)
            h.durability.wal.segment_max_bytes = 8 * 1024
            h.durability.snapshot_every_bytes = 32 * 1024
            side.recovery._populate(h, 6)
            h.converge(max_ticks=300)
            pre = _dump(side, h.store)
            out = {"snapshots_taken": h.durability.snapshots_taken,
                   "snapshots_on_disk": len(side.snapshot.list_snapshots(wal_dir)),
                   "segments": [name for _, name in side.wal.list_segments(wal_dir)]}
            out["segments"] = [os.path.basename(p) for p in out["segments"]]
            h.durability.simulate_crash()
            store, report = side.durability.recover_store(wal_dir, clock=h.clock)
            out.update(report=_report(report), exact=_dump(side, store) == pre,
                       audit=side.durability.verify_acked_prefix(wal_dir, store))
            return out

        jax, port = run_both(tmp_path, scenario)
        assert port == jax
        assert port["snapshots_taken"] >= 1 and port["snapshots_on_disk"] == 1
        assert port["report"]["snapshot_rv"] > 0 and port["exact"] and port["audit"] == []

    def test_deletes_after_snapshot_stay_deleted(self, tmp_path):
        def scenario(side, wal_dir):
            h = converged_harness(side, wal_dir, n_sets=3)
            h.durability.snapshot()
            h.delete("svc-0001")
            h.converge(max_ticks=200)
            gone = h.store.get("PodCliqueSet", "default", "svc-0001") is None
            pre = _dump(side, h.store)
            h.durability.simulate_crash()
            store, report = side.durability.recover_store(wal_dir, clock=h.clock)
            return {"gone": gone, "report": _report(report),
                    "still_gone": store.get("PodCliqueSet", "default", "svc-0001") is None,
                    "exact": _dump(side, store) == pre}

        jax, port = run_both(tmp_path, scenario)
        assert port == jax
        assert port["gone"] and port["still_gone"] and port["exact"]
        assert port["report"]["snapshot_rv"] > 0


def _seeded_schedule(seed: int, n_batches: int = 8, batch_size: int = 6):
    """``tests/test_durability.py``'s op schedule over PodCliques (creates,
    spec updates, copy-on-write status commits, deletes), as plain data."""
    rng = random.Random(seed)
    live, batches, counter = [], [], 0
    for _ in range(n_batches):
        batch = []
        for _ in range(batch_size):
            choices = ["create"] + (["update", "status", "status", "delete"] if live else [])
            op = rng.choice(choices)
            if op == "create":
                name = f"clq-{counter:03d}"
                counter += 1
                live.append(name)
                batch.append(("create", name, rng.randrange(1, 9)))
            elif op == "delete":
                batch.append(("delete", live.pop(rng.randrange(len(live)))))
            else:
                batch.append((op, live[rng.randrange(len(live))], rng.randrange(0, 9)))
        batches.append(batch)
    return batches


def _apply_batch(side, store, batch) -> None:
    for op in batch:
        if op[0] == "create":
            store.create(side.types.PodClique(
                metadata=side.ObjectMeta(name=op[1]),
                spec=side.types.PodCliqueSpec(role_name="r", replicas=op[2])))
        elif op[0] == "delete":
            store.delete("PodClique", "default", op[1])
        elif op[0] == "update":
            obj = store.get("PodClique", "default", op[1])
            obj.spec.replicas = op[2]
            store.update(obj)
        else:
            view = store.get("PodClique", "default", op[1], readonly=True)
            status = side.deep_copy(view.status)
            status.ready_replicas = op[2]
            side.commit_status(store, view, status)


@pytest.mark.parametrize("crash_after", [3, 8])
def test_crash_point_acked_prefix(tmp_path, crash_after):
    """Crash after ``crash_after`` durable batches of the seeded schedule
    (the odd point with a mid-schedule snapshot and a torn final write):
    the recovered store equals an oracle that ran exactly those batches, in
    both packages alike."""
    batches = _seeded_schedule(20260803)
    dirs = _dirs(tmp_path)

    def scenario(side):
        wal_dir = dirs[side.root]
        store = side.Store(side.VirtualClock())
        dur = side.durability.StoreDurability(store, wal_dir)
        for b in range(crash_after):
            _apply_batch(side, store, batches[b])
            dur.pump()
            if b == crash_after // 2 and crash_after % 2 == 1:
                dur.snapshot()
        if crash_after < len(batches):
            _apply_batch(side, store, batches[crash_after])
        lost = dur.simulate_crash(torn_tail_bytes=13 * (crash_after % 2))
        recovered, report = side.durability.recover_store(wal_dir, clock=store.clock)
        oracle = side.Store(side.VirtualClock())
        for b in range(crash_after):
            _apply_batch(side, oracle, batches[b])
        return {"lost": lost, "report": _report(report),
                "audit": side.durability.verify_acked_prefix(wal_dir, recovered),
                "dump": side.store_dump(recovered, canonical_uids=True),
                "oracle": side.store_dump(oracle, canonical_uids=True),
                "rv": [recovered.resource_version, oracle.resource_version]}

    jax, port = both(scenario)
    assert port == jax
    assert port["audit"] == [] and port["dump"] == port["oracle"]
    assert port["rv"][0] == port["rv"][1]


class TestInertAB:
    def test_store_path_identical_without_durability(self, tmp_path):
        batches = _seeded_schedule(7)
        dirs = _dirs(tmp_path)

        def scenario(side):
            plain = side.Store(side.VirtualClock())
            for batch in batches:
                _apply_batch(side, plain, batch)
            durable = side.Store(side.VirtualClock())
            dur = side.durability.StoreDurability(durable, dirs[side.root])
            for batch in batches:
                _apply_batch(side, durable, batch)
                dur.pump()
            out = {"same": side.store_dump(durable, canonical_uids=True)
                   == side.store_dump(plain, canonical_uids=True),
                   "rv": [durable.resource_version, plain.resource_version],
                   "stats": {k: v for k, v in dur.stats().items()}}
            dur.close()
            return out

        jax, port = both(scenario)
        assert port == jax
        assert port["same"] and port["rv"][0] == port["rv"][1]


class TestRestoreObjects:
    def test_requires_fresh_store(self):
        def scenario(side):
            store = side.Store(side.VirtualClock())
            store.create(side.types.PodClique(
                metadata=side.ObjectMeta(name="x"),
                spec=side.types.PodCliqueSpec(role_name="r", replicas=1)))
            with pytest.raises(side.GroveError) as err:
                store.restore_objects([], rv=99)
            sharded = side.Store(side.VirtualClock(), num_shards=3)
            with pytest.raises(side.GroveError) as err2:
                sharded.restore_objects([], rv=5)
            return [str(err.value), str(err2.value)]

        jax, port = both(scenario)
        assert port == jax

    def test_resource_version_resumes_monotonic(self, tmp_path):
        def scenario(side, wal_dir):
            h = converged_harness(side, wal_dir, n_sets=2)
            rv = h.store.resource_version
            h.durability.simulate_crash()
            store, _ = side.durability.recover_store(wal_dir, clock=h.clock)
            recovered_rv = store.resource_version
            created = store.create(side.types.PodClique(
                metadata=side.ObjectMeta(name="post-recovery"),
                spec=side.types.PodCliqueSpec(role_name="r", replicas=1)))
            return [rv, recovered_rv, created.metadata.resource_version]

        jax, port = run_both(tmp_path, scenario)
        assert port == jax
        assert port[1] == port[0] and port[2] == port[0] + 1


class TestCrossPackageWal:
    """The on-disk format is one: each package recovers the other's log."""

    @pytest.mark.parametrize("writer,reader", [("grove_tpu", "grove_tpu_torch"),
                                               ("grove_tpu_torch", "grove_tpu")])
    @pytest.mark.parametrize("num_shards", [1, 3])
    def test_log_recovers_in_the_other_package(self, tmp_path, writer, reader, num_shards):
        w, r = cp_side(writer), cp_side(reader)
        fresh(w)
        wal_dir = str(tmp_path / "wal")
        store = w.Store(w.VirtualClock(), cache_lag=True, num_shards=num_shards)
        h = w.harness(num_nodes=16, store=store, durability_dir=wal_dir)
        w.scale._populate(h, 12, w.scale.tenant_namespaces(6))
        h.converge(max_ticks=200)
        h.durability.snapshot()  # a snapshot base and a replayed tail
        h.delete("svc-000001", namespace="tenant-001")
        h.converge(max_ticks=200)
        want = w.store_dump(h.store, include_events=False)
        want_rv = h.store.resource_version
        h.durability.simulate_crash(torn_tail_bytes=31)
        h.engine.close()
        fresh(r)
        store, report = r.durability.recover_store(wal_dir, clock=r.VirtualClock(),
                                                   cache_lag=True)
        assert r.store_dump(store, include_events=False) == want
        assert store.resource_version == want_rv and store.num_shards == num_shards
        assert report.torn_tail and report.snapshot_rv > 0
        assert r.durability.verify_acked_prefix(wal_dir, store) == []
        # and the reader's own recovery of its own writes agrees
        mine, _ = w.durability.recover_store(wal_dir, clock=w.VirtualClock(), cache_lag=True)
        assert w.store_dump(mine, include_events=False) == want
