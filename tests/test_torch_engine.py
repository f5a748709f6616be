"""The port's store, engine and runtime helpers against the JAX package's,
on the CPU.

The serial cases of ``tests/test_runtime.py`` (store semantics, the label
index, the lagged informer cache, finalizer deletion, the expectations
store, the indexer, the flow helpers and the engine), each run on both
packages: the observations must be equal and keep the JAX test's asserts.
Also ``delete_collection``, the ``serialize`` / wire round trip of every
golden document of ``tests/test_wire_fixtures.py`` (the port's export of the
port's converged world equal to the committed fixtures and to the JAX
export), the uid repair (``uid-<8 hex>-<n>``, a fresh token after
``reset_uid_namespace``), and the port's samples pinned byte for byte to
``samples/``.
"""

from __future__ import annotations

import json
import pathlib
import re

import pytest

from tests.test_torch_operator import (  # noqa: F401 (the autouse fixture)
    JAX,
    PORT,
    SIDES,
    _fresh_singletons,
    harness,
    sample,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE_DIR = REPO / "tests" / "fixtures" / "wire"


def parts(side):
    m = side.mod
    return dict(
        ObjectMeta=m("api.meta").ObjectMeta, PodClique=side.types.PodClique,
        Pod=m("api.pod").Pod, VirtualClock=m("runtime.clock").VirtualClock,
        Store=m("runtime.store").Store, store=m("runtime.store"),
        Engine=m("runtime.engine").Engine, Controller=m("runtime.engine").Controller,
        GroveError=m("runtime.errors").GroveError,
        ExpectationsStore=m("runtime.expectations").ExpectationsStore,
        flow=m("runtime.flow"), indexer=m("runtime.indexer"),
    )


def mk(p, name, ns="default", labels=None):
    return p["PodClique"](metadata=p["ObjectMeta"](name=name, namespace=ns, labels=labels or {}))


def both(run):
    """``run(side, parts)`` on both packages; the answers must be equal.
    Returns the port's."""
    out = [run(side, parts(side)) for side in SIDES]
    assert out[1] == out[0]
    return out[1]


# -- the store ---------------------------------------------------------------


def test_crud_versions_and_conflicts():
    def run(side, p):
        s = p["Store"](p["VirtualClock"]())
        created = s.create(mk(p, "a"))
        got = s.get("PodClique", "default", "a")
        got.spec.replicas = 5
        updated = s.update(got)
        updated.status.ready_replicas = 1
        st = s.update_status(updated)
        out = [created.metadata.generation, updated.metadata.generation,
               updated.metadata.resource_version > created.metadata.resource_version,
               st.metadata.generation, s.resource_version]
        with pytest.raises(p["GroveError"]):
            s.create(mk(p, "a"))
        stale = s.get("PodClique", "default", "a")
        fresh = s.get("PodClique", "default", "a")
        fresh.spec.replicas = 6
        s.update(fresh)
        stale.spec.replicas = 9
        with pytest.raises(p["GroveError"]):
            s.update(stale)
        obj = mk(p, "b")
        s.create(obj)
        obj.spec.replicas = 99  # the caller's copy must not leak in
        out.append(s.get("PodClique", "default", "b").spec.replicas)
        return out

    out = both(run)
    assert out[:2] == [1, 2] and out[2] and out[3] == 2 and out[-1] != 99


def test_readonly_mutation_caught_by_integrity_guard():
    for side in SIDES:
        p = parts(side)
        s = p["Store"](p["VirtualClock"]())
        s.create(mk(p, "a"))
        s.create(mk(p, "b"))
        assert s.verify_readonly_integrity() == 2
        view = next(iter(s.scan("PodClique", "default")))
        view.spec.replicas = 99
        with pytest.raises(AssertionError, match="readonly contract"):
            s.verify_readonly_integrity()


def test_label_selector_and_index():
    def run(side, p):
        s = p["Store"](p["VirtualClock"]())
        s.create(mk(p, "a", labels={"grove.io/podgang": "g1", "custom/key": "v"}))
        s.create(mk(p, "b", labels={"grove.io/podgang": "g2", "custom/key": "w"}))
        names = lambda objs: [o.metadata.name for o in objs]  # noqa: E731
        out = [names(s.list("PodClique", "default", {"grove.io/podgang": "g1"})),
               names(s.list("PodClique", "default", {"custom/key": "v"})),
               names(s.list("PodClique", "default", {"grove.io/podgang": "g1",
                                                      "custom/key": "v"}))]
        obj = s.get("PodClique", "default", "a")
        obj.metadata.labels["grove.io/podgang"] = "g2"
        s.update(obj)
        out.append(names(s.list("PodClique", "default", {"grove.io/podgang": "g2"})))
        s.delete("PodClique", "default", "b")
        out.append(names(s.list("PodClique", "default", {"grove.io/podgang": "g2"})))
        return out

    assert both(run) == [["a"], ["a"], ["a"], ["a", "b"], ["a"]]


def test_finalizer_deletion_and_delete_collection():
    def run(side, p):
        s = p["Store"](p["VirtualClock"]())
        events = []
        s.subscribe(lambda ev: events.append((ev.type, ev.obj.metadata.name)))
        obj = mk(p, "a")
        obj.metadata.finalizers = ["grove.io/operator"]
        s.create(obj)
        s.delete("PodClique", "default", "a")
        pending = s.get("PodClique", "default", "a")
        out = [pending.metadata.deletion_timestamp is not None]
        s.remove_finalizer("PodClique", "default", "a", "grove.io/operator")
        out.append(s.get("PodClique", "default", "a") is None)
        for i in range(4):
            s.create(mk(p, f"c{i}", labels={"grove.io/podgang": "g" if i % 2 else "h"}))
        out.append(s.delete_collection("PodClique", "default", {"grove.io/podgang": "g"}))
        out.append(sorted(o.metadata.name for o in s.list("PodClique")))
        done = mk(p, "d")
        done.metadata.finalizers = ["x"]
        s.create(done)
        s.delete("PodClique", "default", "d")
        view = s.get("PodClique", "default", "d")
        view.metadata.finalizers = []
        s.update(view, bump_generation=False)
        out.append(s.complete_deletion_if_drained("PodClique", "default", "d"))
        return out, events, s.resource_version

    out, events, _ = both(run)
    assert out == [True, True, 2, ["c0", "c2"], True]
    assert events[:4] == [("Added", "a"), ("Modified", "a"), ("Modified", "a"), ("Deleted", "a")]


def test_watch_events_and_noop_suppression():
    def run(side, p):
        s = p["Store"](p["VirtualClock"]())
        events = []
        s.subscribe(events.append)
        s.create(mk(p, "a"))
        obj = s.get("PodClique", "default", "a")
        obj.spec.replicas = 7
        s.update(obj)
        s.update(s.get("PodClique", "default", "a"))  # no-op: no event
        s.delete("PodClique", "default", "a")
        return [e.type for e in events]

    assert both(run) == ["Added", "Modified", "Deleted"]


def test_commit_cow_spec_and_finalizer():
    def run(side, p):
        s = p["Store"](p["VirtualClock"]())
        s.create(mk(p, "a"))
        view = s.get("PodClique", "default", "a", readonly=True)
        spec = type(view.spec)(**vars(view.spec))
        spec.replicas = 4
        after = p["store"].commit_spec(s, view, spec)
        again = p["store"].commit_finalizer_add(s, after, "grove.io/operator")
        return [after.spec.replicas, after.metadata.generation,
                again.metadata.finalizers, s.resource_version]

    assert both(run) == [4, 1, ["grove.io/operator"], 3]


def test_cache_lag_and_informer_index():
    def run(side, p):
        clock = p["VirtualClock"]()
        s = p["Store"](clock, cache_lag=True)
        s.create(mk(p, "a"))
        out = [len(s.list("PodClique", cached=True))]
        s.sync_cache()
        out += [len(s.list("PodClique", cached=True)), len(s.list("PodClique"))]
        engine = p["Engine"](s, clock)
        engine.hold_events("PodClique")
        s.create(mk(p, "b", labels={"grove.io/podgang": "g1"}))
        engine.drain()
        out.append(len(s.list("PodClique", "default", {"grove.io/podgang": "g1"}, cached=True)))
        engine.release_events("PodClique")
        engine.drain()
        out.append(len(s.list("PodClique", "default", {"grove.io/podgang": "g1"}, cached=True)))
        return out

    assert both(run) == [0, 1, 1, 0, 1]


# -- expectations, indexer, flow ---------------------------------------------


def test_expectations_indexer_flow():
    def run(side, p):
        e = p["ExpectationsStore"]("pod")
        e.expect_creations("k", ["u1", "u2"])
        e.expect_deletions("k", ["u3"])
        out = [e.pending("k", observed_uids=["u1", "u3", "u4"]),
               e.pending("k", observed_uids=["u1", "u2", "u4"])]
        ix = p["indexer"]
        out += [ix.parse_index("pcs-0-frontend", "pcs-0-frontend-3"),
                ix.parse_index("pcs-0-frontend", "pcs-0-prefetch-3"),
                ix.allocate_indices("c", ["c-0", "c-2", "c-5"], 3)]
        with pytest.raises(p["GroveError"]):
            ix.allocate_indices("c", ["c-1", "c-1"], 1)
        f = p["flow"]
        calls = []

        def step(name, result):
            def run_step():
                calls.append(name)
                return result
            return run_step

        r = f.run_steps([step("a", f.continue_reconcile()),
                         step("b", f.reconcile_after(5.0, "wait")),
                         step("c", f.do_not_requeue())])
        err = f.reconcile_with_errors("boom", p["GroveError"]("ERR_X", "x"))
        out += [calls, r.result, r.requeue_after, err.has_errors(), err.short_circuits()]
        return out

    out = both(run)
    assert out[0] == ({"u2"}, {"u3"}) and out[1] == (set(), set())
    assert out[2:5] == [3, -1, [1, 3, 4]]
    assert out[5:] == [["a", "b"], "requeue_after", 5.0, True, True]


def test_error_helpers():
    def run(side, p):
        errors = side.mod("runtime.errors")
        r = errors.requeue_after_error(3.0, "op")
        c = errors.continue_and_requeue_error(2.0, "op", "again")
        agg = errors.ErrorAggregate([errors.GroveError("ERR_A", "a", "op")])
        last = errors.LastError.from_errors([errors.GroveError("ERR_B", "b", "op"), r], now=7.0)
        return [r.code, str(r), r.requeue_after, c.code, str(c), c.requeue_after,
                [e.code for e in agg.errors],
                [(x.code, x.description, x.observed_at) for x in last]]

    both(run)


# -- the engine (the toy replica controller of tests/test_runtime.py) --------


def _replica_controller(p, store, expectations):
    def reconcile(key):
        _, ns, name = key
        parent = store.get("PodClique", ns, name)
        if parent is None:
            return p["flow"].do_not_requeue()
        sel = {"parent": name}
        children = store.list("Pod", ns, sel, cached=True)
        observed = [c.metadata.uid for c in children]
        pending = expectations.pending(f"{ns}/{name}", observed)[0] if expectations else set()
        existing = len(children) + len(pending)
        for i in range(parent.spec.replicas - existing):
            child = p["Pod"](metadata=p["ObjectMeta"](
                name=f"{name}-child-{parent.metadata.generation}-{existing + i}",
                namespace=ns, labels=sel))
            created = store.create(child)
            if expectations is not None:
                expectations.expect_creations(f"{ns}/{name}", [created.metadata.uid])
        return p["flow"].continue_reconcile()

    return reconcile


@pytest.mark.parametrize("with_expectations", [True, False])
def test_expectations_absorb_the_lagged_cache_race(with_expectations):
    def run(side, p):
        clock = p["VirtualClock"]()
        store = p["Store"](clock, cache_lag=True)
        engine = p["Engine"](store, clock)
        exp = p["ExpectationsStore"]("toy") if with_expectations else None
        engine.register(p["Controller"](name="toy", kind="PodClique",
                                        reconcile=_replica_controller(p, store, exp)))
        engine.hold_events("Pod")
        parent = mk(p, "p")
        parent.spec.replicas = 3
        store.create(parent)
        engine.drain()
        fresh = store.get("PodClique", "default", "p")
        fresh.metadata.annotations["touch"] = "1"
        store.update(fresh)
        engine.drain()
        engine.release_events("Pod")
        engine.drain()
        return len(store.list("Pod", "default", {"parent": "p"}))

    n = both(run)
    assert (n == 3) if with_expectations else (n > 3)


def test_engine_requeue_panic_mapping_and_inner_events():
    def run(side, p):
        clock = p["VirtualClock"]()
        store = p["Store"](clock)
        engine = p["Engine"](store, clock)
        flow = p["flow"]
        seen, attempts, mapped = [], [], []

        def requeue(key):
            seen.append(clock.now())
            return flow.reconcile_after(30.0) if len(seen) == 1 else flow.do_not_requeue()

        def panics(key):
            attempts.append(1)
            if len(attempts) < 3:
                raise RuntimeError("boom")
            return flow.do_not_requeue()

        def parent_of(ev):
            parent = ev.obj.metadata.labels.get("parent")
            return [(ev.obj.metadata.namespace, parent)] if parent else []

        def mapping(key):
            mapped.append(key)
            if key[2] == "p" and store.get("Pod", "default", "child") is None:
                store.create(p["Pod"](metadata=p["ObjectMeta"](name="child",
                                                               labels={"parent": "p"})))
            return flow.do_not_requeue()

        engine.register(p["Controller"](name="r", kind="PodClique", reconcile=requeue))
        engine.register(p["Controller"](name="x", kind="PodGang", reconcile=panics))
        engine.register(p["Controller"](name="m", kind="PodCliqueScalingGroup",
                                        reconcile=mapping, watches=[("Pod", parent_of)]))
        store.create(mk(p, "a"))
        engine.drain()
        first = list(seen)
        engine.advance_and_drain(30.0)
        store.create(side.types.PodGang(metadata=p["ObjectMeta"](name="g")))
        engine.run_until_idle()
        pcsg = side.types.PodCliqueScalingGroup(metadata=p["ObjectMeta"](name="p"))
        store.create(pcsg)
        engine.drain()
        metrics = side.METRICS.counters
        return [first, seen, len(attempts), mapped,
                {k: v for k, v in metrics.items() if k.startswith("reconcile_")},
                engine.enable_workers(4)]

    out = both(run)
    assert out[0] == [0.0] and out[1] == [0.0, 30.0] and out[2] == 3
    assert out[3] == [("PodCliqueScalingGroup", "default", "p")] * 2
    assert out[5] is False  # unsharded store: the serial drain stays


# -- serialize / wire round trip (tests/test_wire_fixtures.py) ---------------


def _normalize(doc):
    from tests.test_wire_fixtures import _render

    return _render(doc)


@pytest.fixture(scope="module")
def converged_worlds():
    out = {}
    for side in SIDES:
        side.mod("api.meta").reset_uid_namespace()
        h = harness(side, num_nodes=16)
        h.apply(sample(side, "agentic-pipeline.yaml"))
        h.apply(sample(side))
        h.converge()
        out[side.root] = h
    yield out
    for side in SIDES:
        for layer in (side.TRACER, side.EVENTS, side.JOURNEYS, side.FLIGHTREC, side.TIMESERIES):
            layer.clock = None


FIXTURES = {
    "podcliqueset": ("PodCliqueSet", "simple1"),
    "podclique-standalone": ("PodClique", "simple1-0-frontend"),
    "podclique-pcsg-member": ("PodClique", "simple1-0-workers-0-compute"),
    "podcliquescalinggroup": ("PodCliqueScalingGroup", "simple1-0-workers"),
    "podgang-base": ("PodGang", "simple1-0"),
    "pod-initc": ("Pod", "agentic-0-router-0"),
    "service-headless": ("Service", "simple1-0"),
    "clustertopology": ("ClusterTopology", None),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_export_equals_golden_fixture_and_jax(converged_worlds, name):
    kind, obj_name = FIXTURES[name]
    docs = []
    for side in SIDES:
        h = converged_worlds[side.root]
        obj = h.topology if obj_name is None else h.store.get(kind, "default", obj_name)
        docs.append(_normalize(side.export_object(obj)))
    assert docs[1] == docs[0]
    assert docs[1] == (FIXTURE_DIR / f"{name}.json").read_text()


@pytest.mark.parametrize("name", ["podcliqueset", "podclique-standalone",
                                  "podclique-pcsg-member", "podcliquescalinggroup",
                                  "podgang-base", "pod-initc", "clustertopology"])
def test_wire_round_trip_lossless(name):
    text = (FIXTURE_DIR / f"{name}.json").read_text()
    obj = PORT.mod("api.wire").decode_object(json.loads(text))
    assert _normalize(PORT.export_object(obj)) == text


def test_kind_registry_matches_jax():
    regs = [{k: (v.cls.__name__, v.group, v.version, v.plural, v.namespaced, v.api_version)
             for k, v in side.mod("api.wire").KIND_REGISTRY.items()} for side in SIDES]
    assert regs[1] == regs[0]


# -- the uid repair and the samples --------------------------------------------


def test_uid_has_incarnation_token_and_reset_rotates_it():
    meta = PORT.mod("api.meta")
    meta.reset_uid_namespace()
    first = [meta.next_uid() for _ in range(3)]
    assert all(re.fullmatch(r"uid-[0-9a-f]{8}-[0-9]+", u) for u in first)
    assert [u.rsplit("-", 1)[1] for u in first] == ["1", "2", "3"]
    token = first[0].split("-")[1]
    meta.reset_uid_namespace()
    again = meta.next_uid()
    assert again.endswith("-1") and again.split("-")[1] != token
    # the same form as the JAX package's
    assert re.fullmatch(r"uid-[0-9a-f]{8}-[0-9]+", JAX.mod("api.meta").next_uid())


def test_template_hash_cache_survives_a_restarted_uid_sequence():
    """A fresh incarnation re-creates (uid, generation) pairs only under a
    new token, so the template-hash cache never serves a stale hash."""
    meta, hashing = PORT.mod("api.meta"), PORT.mod("api.hashing")
    hashes = []
    for image in ("busybox:a", "busybox:b"):
        meta.reset_uid_namespace()
        h = harness(PORT)
        pcs = sample(PORT)
        for clique in pcs.spec.template.cliques:
            clique.spec.pod_spec.containers[0].image = image
        h.apply(pcs)
        stored = h.store.get("PodCliqueSet", "default", "simple1")
        hashes.append(hashing.pod_template_hash_for(stored, "frontend"))
    assert hashes[0] != hashes[1]


def test_port_samples_pinned_to_repository_samples():
    root = {p.name: p.read_bytes() for p in (REPO / "samples").glob("*.yaml")}
    port_dir = PORT.mod("models.scenarios").SAMPLES_DIR
    assert port_dir.parts[-3:] == ("grove_tpu_torch", "models", "samples")
    assert {p.name: p.read_bytes() for p in port_dir.glob("*.yaml")} == root
    # load_sample reads the port's own copy
    pcs = PORT.mod("models.scenarios").load_sample("simple")
    assert pcs.metadata.name == "simple1" and type(pcs).__module__.startswith("grove_tpu_torch")


def test_template_hashes_of_every_sample_match_jax():
    """Hashes follow field names: the pod-template hash of every clique of
    every sample, and the generation hash of every set, equal JAX's."""
    out = []
    for side in SIDES:
        hashing = side.mod("api.hashing")
        rows = {}
        for path in sorted((REPO / "samples").glob("*.yaml")):
            for obj in side.load_manifest_objects(path.read_text()):
                if obj.kind != "PodCliqueSet":
                    continue
                side.mod("admission.defaulting").default_podcliqueset(obj)
                rows[obj.metadata.name] = (
                    hashing.compute_pcs_generation_hash(obj),
                    [hashing.compute_pod_template_hash(c, obj.spec.template.priority_class_name)
                     for c in obj.spec.template.cliques],
                )
        out.append(rows)
    assert out[1] == out[0] and len(out[1]) == 10


# -- the threaded drain (drain_concurrent), the cases of
# tests/test_concurrent_engine.py on both packages -------------------------


def _service(p, side, name, rep):
    return side.mod("api.types").GenericObject(
        kind="Service", metadata=p["ObjectMeta"](name=name, namespace="default"),
        spec={"rep": rep})


def _overlaps(a, b) -> bool:
    return a[1] < b[2] and b[1] < a[2]


def _threaded_intervals(side, p, n_keys, bumps, concurrent_syncs, work_s=0.02):
    """Reconcile ``n_keys`` Services through ``drain_concurrent``; each
    reconcile bumps its own object until ``rep == bumps``, so its key comes
    back while it is still in flight. Returns the (key, start, end)
    intervals and the final reps."""
    import threading
    import time

    store = p["Store"](p["VirtualClock"]())
    store_lock, ivl_lock = threading.Lock(), threading.Lock()
    engine = p["Engine"](store, store.clock)
    intervals = []

    def reconcile(key):
        start = time.monotonic()
        _kind, ns, name = key
        with store_lock:  # the in-memory store is not thread-safe
            obj = store.get("Service", ns, name)
            if obj is not None and obj.spec.get("rep", 0) < bumps:
                obj.spec = {"rep": obj.spec.get("rep", 0) + 1}
                store.update(obj)
        time.sleep(work_s)
        with ivl_lock:
            intervals.append((key, start, time.monotonic()))
        return p["flow"].continue_reconcile()

    engine.register(p["Controller"](name="test", kind="Service", reconcile=reconcile,
                                    concurrent_syncs=concurrent_syncs))
    with store_lock:
        for i in range(n_keys):
            store.create(_service(p, side, f"svc-{i}", 0))
    try:
        executed = engine.drain_concurrent()
        assert engine._ensure_pool() is engine._pool  # one pool for the engine's life
    finally:
        engine.close()
    assert engine._pool is None
    reps = {o.metadata.name: o.spec["rep"] for o in store.list("Service")}
    return intervals, reps, executed


@pytest.mark.parametrize("side_i", [0, 1], ids=["jax", "port"])
def test_drain_concurrent_runs_distinct_keys_in_parallel(side_i):
    side = SIDES[side_i]
    intervals, reps, executed = _threaded_intervals(side, parts(side), 4, 0, 4, work_s=0.03)
    assert len(intervals) == executed == 4
    assert reps == {f"svc-{i}": 0 for i in range(4)}
    cross = sum(1 for i in range(4) for j in range(i + 1, 4)
                if _overlaps(intervals[i], intervals[j]))
    assert cross > 0, "no two distinct keys ever ran at once"


@pytest.mark.parametrize("side_i", [0, 1], ids=["jax", "port"])
def test_drain_concurrent_never_overlaps_one_key(side_i):
    side = SIDES[side_i]
    bumps = 4
    intervals, reps, _ = _threaded_intervals(side, parts(side), 3, bumps, 4)
    assert reps == {f"svc-{i}": bumps for i in range(3)}
    by_key = {}
    for iv in intervals:
        by_key.setdefault(iv[0], []).append(iv)
    assert all(len(v) >= bumps for v in by_key.values())
    for key, ivs in by_key.items():
        ivs.sort(key=lambda iv: iv[1])
        for a, b in zip(ivs, ivs[1:]):
            assert not _overlaps(a, b), f"{key} reconciled twice at once"


def test_drain_concurrent_quiesces_like_jax():
    """One thread a controller: the threaded drain runs one key at a time
    in pop order, so both packages reconcile the same keys in the same
    order and end at the same store."""
    def run(side, p):
        store = p["Store"](p["VirtualClock"]())
        engine = p["Engine"](store, store.clock)
        seen = []

        def reconcile(key):
            seen.append(key[2])
            obj = store.get("Service", key[1], key[2])
            if obj.spec["rep"] < 2:
                obj.spec = {"rep": obj.spec["rep"] + 1}
                store.update(obj)
            return p["flow"].continue_reconcile()

        engine.register(p["Controller"](name="one", kind="Service", reconcile=reconcile))
        for i in range(5):
            store.create(_service(p, side, f"svc-{i}", 0))
        try:
            executed = engine.drain_concurrent()
        finally:
            engine.close()
        return executed, seen, store.resource_version

    executed, seen, _rv = both(run)
    assert executed == len(seen) == 15
