"""The port's keyspace-sharded store and engine against the JAX package's.

The same seeded operation schedules (``tests/test_shards.py``'s storms, as
plain data) drive a port ``Store(num_shards=S)`` and a JAX one; the two must
agree on the keyspace map, the cross-shard ``list`` order, the canonical
dump, the per-shard resourceVersion vector and census, every pod summary
(and the flat fold), each shard's own fan-out in order, the
namespace-only candidate sets, the engine's round-robin drain and the census
gate. Arming the parallel drain on a sharded port store gives the thread
drain (``tests/test_torch_workers.py`` holds it to the JAX package's).
"""

import random
import zlib

import pytest

from grove_tpu.api.meta import ObjectMeta as JMeta
from grove_tpu.api.pod import Pod as JPod
from grove_tpu.runtime.clock import Clock as JClock
from grove_tpu.runtime.clock import VirtualClock as JVirtualClock
from grove_tpu.runtime.engine import Controller as JController
from grove_tpu.runtime.engine import Engine as JEngine
from grove_tpu.runtime.flow import ReconcileStepResult as JResult
from grove_tpu.runtime.store import Store as JStore
from grove_tpu.sim.recovery import store_dump as j_store_dump
from grove_tpu.sim.scale import census_spread_problems as j_census_spread
from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import Condition, ObjectMeta, deep_copy, set_condition
from grove_tpu_torch.api.pod import COND_POD_READY, Pod, is_ready, is_terminating
from grove_tpu_torch.observability.events import EVENTS
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.tracing import TRACER
from grove_tpu_torch.runtime.clock import Clock, VirtualClock
from grove_tpu_torch.runtime.engine import Controller, Engine
from grove_tpu_torch.runtime.errors import GroveError
from grove_tpu_torch.runtime.flow import ReconcileStepResult
from grove_tpu_torch.runtime.shards import FOLD_FAN_IN, ShardSummaryTree, shard_of
from grove_tpu_torch.runtime.store import Store
from grove_tpu_torch.sim.recovery import store_dump
from grove_tpu_torch.sim.scale import census_spread_problems
from tests.test_shards import NAMESPACES, PCLQS, _storm_ops
from tests.test_shards import _apply_storm_op as j_apply_storm_op


def _mk_pod(rng, ns: str, name: str) -> Pod:
    pod = Pod(metadata=ObjectMeta(name=name, namespace=ns))
    pod.metadata.labels[namegen.LABEL_PODCLIQUE] = rng.choice(PCLQS)
    if rng.random() < 0.3:
        pod.metadata.finalizers = ["grove.io/test"]
    return pod


def _flip_ready(rng, pod: Pod) -> None:
    set_condition(
        pod.status.conditions,
        Condition(type=COND_POD_READY, status=rng.choice(["True", "False"]), reason="Storm"),
        rng.random() * 100,
    )


def apply_storm_op(store: Store, op) -> None:
    """``tests/test_shards._apply_storm_op`` on the port's store: the same
    random draws, so both packages' objects are the same."""
    kind = op[0]
    if kind == "create":
        _, ns, name, seed, fin = op
        pod = _mk_pod(random.Random(seed), ns, name)
        pod.metadata.finalizers = ["grove.io/test"] if fin else []
        store.create(pod)
    elif kind == "status":
        _, ns, name, seed = op
        pod = store.get("Pod", ns, name)
        _flip_ready(random.Random(seed), pod)
        store.update(pod, bump_generation=False)
    elif kind == "delete":
        store.delete("Pod", op[1], op[2])
    elif kind == "definalize":
        store.remove_finalizer("Pod", op[1], op[2], "grove.io/test")


def _flat_summary(store):
    pods = [p for p in store.scan("Pod") if not is_terminating(p)]
    return len(pods), sum(1 for p in pods if is_ready(p))


def _pair(num_shards, cache_lag=False):
    """A port and a JAX store on frozen virtual clocks (the dumps carry the
    creation timestamps)."""
    return (Store(VirtualClock(), cache_lag=cache_lag, num_shards=num_shards),
            JStore(JVirtualClock(), cache_lag=cache_lag, num_shards=num_shards))


# ---------------------------------------------------------------------------
# keyspace map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_shards", [1, 2, 3, 5, 8, 16])
def test_keyspace_map_matches_jax(num_shards):
    store, jstore = _pair(num_shards)
    assert store.num_shards == jstore.num_shards == num_shards
    for ns in NAMESPACES + ["", "tenant-000", "tenant-063"]:
        want = jstore.shard_index(ns)
        assert store.shard_index(ns) == shard_of(ns, num_shards) == want
        if ns and num_shards > 1:
            assert want == zlib.crc32(ns.encode()) % num_shards
    assert store.shard_index("") == 0


def test_store_shards_from_env(monkeypatch):
    monkeypatch.setenv("GROVE_TPU_STORE_SHARDS", "3")
    assert Store(Clock()).num_shards == 3
    monkeypatch.delenv("GROVE_TPU_STORE_SHARDS")
    assert Store(Clock()).num_shards == 1
    assert Store(Clock(), num_shards=0).num_shards == 1


def test_events_carry_the_shard():
    store = Store(Clock(), num_shards=5)
    try:
        rec = EVENTS.record(("Pod", "tenant-a", "p"), "Normal", "ShardProbe", "probe")
        assert rec.shard == shard_of("tenant-a", 5)
    finally:
        EVENTS.reset()
        Store(Clock())  # the newest store unwires the shard map
    assert EVENTS.shard_fn is None


# ---------------------------------------------------------------------------
# storms: both packages, every read equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 7, 42])
@pytest.mark.parametrize("num_shards", [1, 3, 5])
def test_storm_matches_jax(seed, num_shards):
    store, jstore = _pair(num_shards)
    for step, op in enumerate(_storm_ops(seed, 250)):
        apply_storm_op(store, op)
        j_apply_storm_op(jstore, op)
        summary = store.pod_summary()
        assert summary == jstore.pod_summary() == _flat_summary(store), step
    assert store.resource_version_vector() == jstore.resource_version_vector()
    assert store.resource_version == jstore.resource_version
    assert store.shard_census() == jstore.shard_census()
    assert store.kinds() == jstore.kinds()
    for i in range(num_shards):
        assert store.shard_kinds(i) == jstore.shard_kinds(i)
        assert store.shard_resource_version(i) == jstore.shard_resource_version(i)
        assert store.shard_emitted(i) == jstore.shard_emitted(i)
        assert [p.metadata.name for p in store.shard_scan(i, "Pod")] == [
            p.metadata.name for p in jstore.shard_scan(i, "Pod")]
    assert store_dump(store, canonical_uids=True) == j_store_dump(jstore, canonical_uids=True)
    assert [(p.metadata.namespace, p.metadata.name) for p in store.list("Pod")] == [
        (p.metadata.namespace, p.metadata.name) for p in jstore.list("Pod")]
    assert [(p.metadata.namespace, p.metadata.name) for p in store.scan("Pod")] == [
        (p.metadata.namespace, p.metadata.name) for p in jstore.scan("Pod")]
    for ns in NAMESPACES:
        for clq in PCLQS:
            row, jrow = store.pod_counters(ns, clq), jstore.pod_counters(ns, clq)
            assert (row.total, row.ready) == (jrow.total, jrow.ready)
    assert store.fold_depth_histogram() == jstore.fold_depth_histogram()


@pytest.mark.parametrize("seed", [5, 23, 99])
def test_sharded_equals_unsharded_on_same_schedule(seed):
    ops = _storm_ops(seed, 200)
    flat, sharded = Store(VirtualClock()), Store(VirtualClock(), num_shards=4)
    for op in ops:
        apply_storm_op(flat, op)
        apply_storm_op(sharded, op)
    assert [(p.metadata.namespace, p.metadata.name) for p in flat.list("Pod")] == [
        (p.metadata.namespace, p.metadata.name) for p in sharded.list("Pod")]
    want = {k: v for k, v in store_dump(flat, canonical_uids=True).items()}
    got = store_dump(sharded, canonical_uids=True)
    for doc in list(want.values()) + list(got.values()):
        doc["metadata"].pop("resourceVersion", None)
    assert got == want
    assert sharded.resource_version == flat.resource_version
    assert sum(sharded.resource_version_vector()) == sharded.resource_version


def test_cached_view_summary_under_lag_matches_jax():
    store, jstore = _pair(3, cache_lag=True)
    backlog, jbacklog = [], []
    store.subscribe(backlog.append)
    jstore.subscribe(jbacklog.append)
    rng = random.Random(13)
    for i, op in enumerate(_storm_ops(17, 150)):
        apply_storm_op(store, op)
        j_apply_storm_op(jstore, op)
        if rng.random() < 0.4:
            for _ in range(rng.randrange(0, len(backlog) + 1)):
                store.apply_event_to_cache(backlog.pop(0))
                jstore.apply_event_to_cache(jbacklog.pop(0))
            pods = [p for p in store.scan("Pod", cached=True) if not is_terminating(p)]
            want = (len(pods), sum(1 for p in pods if is_ready(p)))
            assert store.pod_summary(cached=True) == want == jstore.pod_summary(cached=True), i
    store.sync_cache()
    jstore.sync_cache()
    assert store.pod_summary(cached=True) == jstore.pod_summary(cached=True)


def test_summary_read_refolds_only_dirty_shards():
    store = Store(Clock(), num_shards=8)
    for op in _storm_ops(5, 120):
        apply_storm_op(store, op)
    first = store.pod_summary()
    assert not store._summary_dirty
    assert store.pod_summary() == first == _flat_summary(store)
    ns = NAMESPACES[0]
    store.create(_mk_pod(random.Random(9), ns, "hot-shard-pod"), consume=True)
    assert store._summary_dirty == {store.shard_index(ns)}
    assert store.pod_summary() == _flat_summary(store)


def test_fold_tree_shapes():
    assert Store(Clock(), num_shards=16).fold_depth_histogram() == [16, 2, 1]
    assert ShardSummaryTree(64).fold_depth_histogram() == [64, 8, 1]
    assert FOLD_FAN_IN == 8


def test_each_commit_bumps_exactly_one_shard_by_one():
    store = Store(Clock(), num_shards=3)
    prev = store.resource_version_vector()
    for i, ns in enumerate(NAMESPACES):
        store.create(Pod(metadata=ObjectMeta(name=f"p-{i}", namespace=ns)))
        vec = store.resource_version_vector()
        diffs = [b - a for a, b in zip(prev, vec)]
        assert sorted(diffs) == [0, 0, 1] and diffs[shard_of(ns, 3)] == 1
        prev = vec


def test_namespace_reads_route_to_owner_and_conflicts_stay_in_shard():
    store = Store(Clock(), num_shards=5)
    for i, ns in enumerate(NAMESPACES):
        store.create(Pod(metadata=ObjectMeta(name=f"p-{i}", namespace=ns)))
    for i, ns in enumerate(NAMESPACES):
        assert [p.metadata.name for p in store.list("Pod", namespace=ns)] == [f"p-{i}"]
        assert store.get("Pod", ns, f"p-{i}") is not None
    pod = store.get("Pod", "tenant-a", "p-1")
    stale = deep_copy(pod)
    _flip_ready(random.Random(1), pod)
    store.update(pod, bump_generation=False)
    _flip_ready(random.Random(2), stale)
    with pytest.raises(GroveError):
        store.update(stale, bump_generation=False)
    with pytest.raises(AttributeError):
        store.rv  # one sequence per shard
    single = Store(Clock())
    single.rv = 7
    assert single.resource_version == 7


# ---------------------------------------------------------------------------
# no full scans
# ---------------------------------------------------------------------------


def _counting_store(monkeypatch, num_shards):
    import grove_tpu_torch.runtime.store as store_mod

    store = Store(Clock(), num_shards=num_shards)
    touched = []
    real = store_mod.matches_labels

    def counting(obj, selector):
        touched.append(obj)
        return real(obj, selector)

    monkeypatch.setattr(store_mod, "matches_labels", counting)
    return store, touched


@pytest.mark.parametrize("num_shards", [1, 4])
def test_namespace_list_touches_only_the_namespace(monkeypatch, num_shards):
    store, touched = _counting_store(monkeypatch, num_shards)
    for ns in NAMESPACES:
        for i in range(20):
            store.create(Pod(metadata=ObjectMeta(name=f"p-{i}", namespace=ns)))
    touched.clear()
    assert len(store.list("Pod", namespace="tenant-a")) == 20
    assert len(touched) == 20
    assert all(p.metadata.namespace == "tenant-a" for p in touched)


@pytest.mark.parametrize("num_shards", [1, 4])
def test_indexed_selector_touches_only_candidates(monkeypatch, num_shards):
    store, touched = _counting_store(monkeypatch, num_shards)
    rng = random.Random(3)
    for ns in NAMESPACES:
        for i in range(15):
            pod = Pod(metadata=ObjectMeta(name=f"p-{i}", namespace=ns))
            pod.metadata.labels[namegen.LABEL_PODCLIQUE] = (
                "hot" if i < 3 else f"cold-{rng.randrange(4)}")
            store.create(pod)
    touched.clear()
    got = store.list("Pod", namespace="blue", label_selector={namegen.LABEL_PODCLIQUE: "hot"})
    assert len(got) == 3 and len(touched) <= 15


# ---------------------------------------------------------------------------
# per-shard fan-out
# ---------------------------------------------------------------------------


def test_per_shard_fanout_in_order_matches_jax():
    store, jstore = _pair(3)
    seen = {k: [] for k in range(3)}
    jseen = {k: [] for k in range(3)}
    for k in range(3):
        store.subscribe_system((lambda k: lambda ev: seen[k].append(ev))(k), shard=k)
        jstore.subscribe_system((lambda k: lambda ev: jseen[k].append(ev))(k), shard=k)
    every, jevery, per, jper = [], [], [], []
    store.subscribe_system(every.append)
    jstore.subscribe_system(jevery.append)
    store.subscribe_system_per_shard(per.append)
    jstore.subscribe_system_per_shard(jper.append)
    for op in _storm_ops(31, 120):
        apply_storm_op(store, op)
        j_apply_storm_op(jstore, op)

    def key(ev):
        return (ev.type, ev.kind, ev.obj.metadata.namespace, ev.obj.metadata.name, ev.shard)

    assert [key(e) for e in every] == [key(e) for e in jevery]
    assert [key(e) for e in per] == [key(e) for e in every]
    for k in range(3):
        assert seen[k] == [ev for ev in every if ev.shard == k]
        assert [key(e) for e in seen[k]] == [key(e) for e in jseen[k]]


# ---------------------------------------------------------------------------
# the engine: per-shard backlogs, round-robin, the workers guard
# ---------------------------------------------------------------------------


def _engine(num_shards, store_cls=Store, clock_cls=Clock, engine_cls=Engine,
            controller_cls=Controller, result_cls=ReconcileStepResult):
    store = store_cls(clock_cls(), num_shards=num_shards)
    engine = engine_cls(store)
    order = []

    def reconcile(key):
        order.append(key)
        return result_cls(result="done")

    engine.register(controller_cls(name="pods", kind="Pod", reconcile=reconcile))
    return store, engine, order


def _jengine(num_shards):
    return _engine(num_shards, JStore, JClock, JEngine, JController, JResult)


@pytest.mark.parametrize("num_shards", [1, 3, 4])
def test_engine_drain_order_matches_jax(num_shards):
    store, engine, order = _engine(num_shards)
    jstore, jengine, jorder = _jengine(num_shards)
    assert engine.controllers[0].queue.num_shards == num_shards
    for s, e in ((store, engine), (jstore, jengine)):
        for i, ns in enumerate(NAMESPACES * 3):
            s.create(Pod(metadata=ObjectMeta(name=f"p-{i}", namespace=ns)) if s is store
                     else JPod(metadata=JMeta(name=f"p-{i}", namespace=ns)))
    assert engine.drain() == jengine.drain() == len(NAMESPACES) * 3
    assert order == jorder
    assert len(set(order)) == len(order)
    if num_shards > 1:
        for idx in range(num_shards):
            assert METRICS.gauges[f"engine_shard_backlog@{idx}"] == 0


def test_round_robin_interleaves_shards():
    store, engine, order = _engine(3)
    jstore, jengine, jorder = _jengine(3)
    by_shard = {}
    for ns in NAMESPACES:
        by_shard.setdefault(shard_of(ns, 3), ns)
    (_, ns1), (_, ns2) = sorted(by_shard.items())[:2]
    for prefix, ns in (("a", ns1), ("b", ns2)):
        for i in range(6):
            store.create(Pod(metadata=ObjectMeta(name=f"{prefix}-{i}", namespace=ns)))
            jstore.create(JPod(metadata=JMeta(name=f"{prefix}-{i}", namespace=ns)))
    engine.drain()
    jengine.drain()
    assert order == jorder
    shards = [shard_of(k[1], 3) for k in order]
    assert sum(1 for a, b in zip(shards, shards[1:]) if a != b) >= len(order) - 2


def test_held_events_return_to_their_shard():
    store, engine, order = _engine(3)
    engine.hold_events("Pod")
    for i, ns in enumerate(NAMESPACES):
        store.create(Pod(metadata=ObjectMeta(name=f"p-{i}", namespace=ns)))
    assert engine.drain() == 0
    assert sum(len(b) for b in engine._backlogs) == len(NAMESPACES)
    for idx, backlog in enumerate(engine._backlogs):
        assert all(ev.shard == idx for ev in backlog)
    engine.release_events("Pod")
    assert engine.drain() == len(NAMESPACES)
    assert engine.discard_pending_events() == 0


def test_tracer_spans_carry_the_reconcile_shard():
    store, engine, _ = _engine(4)
    TRACER.reset()
    TRACER.enable()
    try:
        for i, ns in enumerate(NAMESPACES):
            store.create(Pod(metadata=ObjectMeta(name=f"p-{i}", namespace=ns)))
        engine.drain()
        spans = [sp for sp in TRACER.spans() if sp.name == "engine.reconcile"]
    finally:
        TRACER.disable()
        TRACER.reset()
    assert len(spans) == len(NAMESPACES)
    for sp in spans:
        assert sp.attrs["shard"] == shard_of(sp.attrs["key"].split("/")[0], 4)
    assert getattr(TRACER._tls, "shard", None) is None


def test_workers_guard(monkeypatch):
    """Arming the parallel drain on a sharded store gives the thread drain
    (or the process drain), at engine construction too; unsharded it stays
    the no-op."""
    store, engine, _ = _engine(3)
    assert engine.enable_workers(2) is True
    assert type(engine.workers).__name__ == "ParallelDrain" and engine.workers.workers == 2
    assert engine.enable_workers(4) is True  # armed already: unchanged
    assert engine.workers.workers == 2
    _, single, _ = _engine(1)
    assert single.enable_workers(4) is False
    monkeypatch.setenv("GROVE_TPU_CP_WORKERS", "4")
    armed = Engine(Store(Clock(), num_shards=2))
    assert armed.workers.workers == 2  # clamped to the shard count
    armed.close()
    assert Engine(Store(Clock())).workers is None
    engine.close()
    assert engine.workers is None


# ---------------------------------------------------------------------------
# the census gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("census,shards", [
    ([{"shard": 0, "objects": 10, "rv": 10}, {"shard": 1, "objects": 4, "rv": 4},
      {"shard": 2, "objects": 0, "rv": 0}], 3),
    ([{"shard": 0, "objects": 14, "rv": 14}, {"shard": 1, "objects": 0, "rv": 0},
      {"shard": 2, "objects": 0, "rv": 0}], 3),
    ([{"shard": 0, "objects": 14, "rv": 14}], 1),
    ([{"shard": 0, "objects": 0, "rv": 0}], 1),
])
def test_census_gate_matches_jax(census, shards):
    assert census_spread_problems(census, shards) == j_census_spread(census, shards)


def test_live_census_passes_gate():
    for shards in (1, 3):
        store = Store(VirtualClock(), num_shards=shards)
        for i, ns in enumerate(NAMESPACES * 2):
            store.create(Pod(metadata=ObjectMeta(name=f"c-{i}", namespace=ns)))
        assert census_spread_problems(store.shard_census(), shards) == []
        assert METRICS.gauges["store_shard_objects@0"] == store.shard_census()[0]["objects"]
