"""The port's observability layer against the JAX package's, on the CPU.

The metrics exposition, the tracer's summary and Chrome export, the wall
profiler and the gang journeys, each driven the same way in both packages;
then whole scheduler rounds with the tracer, the journeys and the profiler
on in both: the bridged ``SimHarness`` scenarios of
``tests/test_torch_scheduler.py`` (simple1, preemption, reclaim), a delta
and a frontier world, and a cut of the card's world (q). Per
round the span multiset (``(name, parent)``), the metric calls that do not
depend on time (every ``inc`` and ``set``; the names of ``observe``), the
journey marks and phases per gang, and the profiler's (controller, shard,
phase) rows and counts must be equal; the explain burst over the cut
worlds must give equal documents, less their timing fields.
"""

import math
import time
from collections import Counter

import numpy as np
import pytest

from grove_tpu.api.topology import ClusterTopology as JaxTopology
from grove_tpu.api.wire import decode_object as jax_decode
from grove_tpu.observability import journey as jax_journey_mod
from grove_tpu.observability import metrics as jax_metrics_mod
from grove_tpu.observability import profile as jax_profile_mod
from grove_tpu.observability import tracing as jax_tracing_mod
from grove_tpu.observability.events import EVENTS as JAX_EVENTS
from grove_tpu.observability.explain import ExplainEngine as JaxExplainEngine
from grove_tpu.observability.journey import JOURNEYS as JAX_JOURNEYS
from grove_tpu.observability.metrics import METRICS as JAX_METRICS
from grove_tpu.observability.profile import PROFILER as JAX_PROFILER
from grove_tpu.observability.tracing import TRACER as JAX_TRACER
from grove_tpu.runtime.clock import VirtualClock as JaxClock
from grove_tpu.runtime.store import Store as JaxStore
from grove_tpu.sim.cluster import SimCluster as JaxCluster, make_nodes as jax_make_nodes
from grove_tpu.solver.scheduler import GangScheduler as JaxScheduler
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.api.wire import decode_object
from grove_tpu_torch.models.scenarios import (
    EventCapture,
    apply_tick,
    explain_burst,
    observe_summary,
    scheduler_world,
    span_multiset,
)
from grove_tpu_torch.observability import journey as journey_mod
from grove_tpu_torch.observability import metrics as metrics_mod
from grove_tpu_torch.observability import profile as profile_mod
from grove_tpu_torch.observability import tracing as tracing_mod
from grove_tpu_torch.observability.events import EVENTS
from grove_tpu_torch.observability.explain import ExplainEngine
from grove_tpu_torch.observability.journey import JOURNEYS
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.profile import PROFILER
from grove_tpu_torch.observability.tracing import TRACER
from grove_tpu_torch.runtime.clock import VirtualClock
from grove_tpu_torch.runtime.store import Store
from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
from grove_tpu_torch.solver.scheduler import GangScheduler
from tests.test_torch_scheduler import (
    Bridge,
    assert_same_events,
    assert_same_world,
    harness_factory,  # noqa: F401  (a fixture)
    port_world_from,
    simple1,
)

PORT = (TRACER, JOURNEYS, PROFILER)
JAX = (JAX_TRACER, JAX_JOURNEYS, JAX_PROFILER)


@pytest.fixture
def glassbox():
    """Tracer, journeys and profiler on in both packages; everything off and
    empty again afterwards (they are process-global)."""
    for layer in PORT + JAX:
        layer.reset()
        layer.enable()
    yield
    for layer in PORT + JAX:
        layer.disable()
        layer.reset()
    JAX_TRACER.clock = TRACER.clock = None


# -- the metrics exposition ---------------------------------------------------


def _counters_and_gauges(m):
    m.inc("reconcile_total/podclique", 3)
    m.inc("reconcile_total/podclique")
    m.set("workqueue_depth/podclique", 2.0)
    m.set("gang_solve_waves", 7)


def _labeled_histogram(m):
    for v in (0.1, 0.2, 0.3, 0.4):
        m.observe("reconcile_seconds/podclique", v)


def _unlabeled_histogram(m):
    m.observe("gang_solve_seconds", 0.5)


def _empty_window(m):
    m.histograms["gang_solve_seconds"]  # registered, no samples retained
    m.hist_count["gang_solve_seconds"] = 10.0
    m.hist_sum["gang_solve_seconds"] = 5.0


def _shard_labels(m):
    m.set("pending_namespaces@3", 2)
    m.set("store_shard_objects/pods@0", 11)
    m.inc("wal_records_total@1", 5)
    m.observe("shard_commit_seconds/wal@2", 0.25)


def _window_trim(m):
    for i in range(m.MAX_SAMPLES + 7):
        m.observe("quota_order_seconds", i * 1e-3)


def _reset(m):
    _counters_and_gauges(m)
    _labeled_histogram(m)
    m.reset()
    m.inc("after_reset_total")


EXPOSITION_CASES = {
    "counters_and_gauges": _counters_and_gauges,
    "labeled_histogram": _labeled_histogram,
    "unlabeled_histogram": _unlabeled_histogram,
    "empty_window": _empty_window,
    "shard_labels": _shard_labels,
    "window_trim": _window_trim,
    "reset": _reset,
}


@pytest.mark.parametrize("case", sorted(EXPOSITION_CASES))
def test_prometheus_text_matches_jax(case):
    """tests/test_metrics_exposition.py's cases (and the shard grammar, the
    window trim and reset): the same calls give the same exposition text,
    byte for byte, and the same percentiles."""
    jax_m, port_m = jax_metrics_mod.Metrics(), metrics_mod.Metrics()
    EXPOSITION_CASES[case](jax_m)
    EXPOSITION_CASES[case](port_m)
    text = port_m.prometheus_text()
    assert text == jax_m.prometheus_text()
    assert text.endswith("\n") and "nan" not in text.lower()
    for name in list(jax_m.histograms) + ["missing"]:
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            want, got = jax_m.percentile(name, q), port_m.percentile(name, q)
            assert got == want or (math.isnan(got) and math.isnan(want)), (name, q)


# -- tracing ------------------------------------------------------------------


def _nested_spans(tracer):
    tracer.enable()
    with tracer.span("outer", k="v") as outer:
        for i in range(3):
            with tracer.span("inner", i=i):
                with tracer.span("leaf"):
                    time.sleep(0.0005)
        assert tracer.current_span() is outer
        outer.set("done", True)
    leaked = tracer.span("ended-late")
    tracer.span("child-of-late").end()
    leaked.end()
    assert tracer.current_span() is None


def test_trace_summary_and_chrome_export_match_jax():
    """The same nested spans give the same summary keys and counts, the same
    (name, parent) multiset and a Chrome trace both validators accept; the
    virtual clock stamps ``vt``."""
    jax_t, port_t = jax_tracing_mod.Tracer(), tracing_mod.Tracer()
    jax_t.clock, port_t.clock = JaxClock(12.5), VirtualClock(12.5)
    _nested_spans(jax_t)
    _nested_spans(port_t)
    want, got = jax_t.summary(), port_t.summary()
    assert list(got) == list(want)
    assert {k: v["count"] for k, v in got.items()} == {k: v["count"] for k, v in want.items()}
    for row in got.values():
        assert set(row) == {"count", "total_s", "p50_s", "p99_s", "max_s"}
        assert row["p50_s"] <= row["p99_s"] <= row["max_s"] <= row["total_s"]
    assert span_multiset(port_t.spans()) == span_multiset(jax_t.spans())
    js, ps = jax_t.summary_json(), port_t.summary_json()
    assert {k: v for k, v in ps.items() if k != "spans"} == {
        k: v for k, v in js.items() if k != "spans"
    }
    events = port_t.chrome_trace()
    assert tracing_mod.validate_chrome_trace(events) == []
    assert jax_tracing_mod.validate_chrome_trace(events) == []
    assert [e["name"] for e in events] == [e["name"] for e in jax_t.chrome_trace()]
    by_name = {e["name"]: e for e in events}
    outer, inner = by_name["outer"], by_name["inner"]
    assert inner["args"]["parent"] == "outer" and outer["args"]["done"] is True
    assert all(e["args"]["vt"] == 12.5 and e["shard"] == -1 for e in events)
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert [s.name for s in port_t.slowest(1)] == ["outer"]
    port_t.reset()
    assert port_t.spans() == [] and port_t.recorded == 0


MALFORMED_TRACES = {
    "not_a_list": {"not": "a list"},
    "missing_name": [{"ph": "X", "ts": 1}],
    "float_ts": [{"ph": "X", "ts": 1.5, "name": "a", "dur": 1}],
    "empty": [],
    "not_an_object": ["event"],
    "x_without_dur": [{"ph": "X", "ts": 1, "name": "a"}],
}


@pytest.mark.parametrize("case", sorted(MALFORMED_TRACES))
def test_chrome_validator_rejects_malformed_as_jax(case):
    """tests/test_tracing.py's malformed traces, and two more: the port's
    validator finds the same problems as the JAX package's."""
    trace = MALFORMED_TRACES[case]
    got = tracing_mod.validate_chrome_trace(trace)
    assert got and got == jax_tracing_mod.validate_chrome_trace(trace)


def test_disabled_tracer_records_nothing():
    t = tracing_mod.Tracer()
    t.disable()
    with t.span("x") as sp:
        sp.set("k", 1)
    assert sp is tracing_mod._NULL_SPAN and t.spans() == [] and t.current_span() is None


# -- the wall profiler --------------------------------------------------------


@pytest.fixture
def profiler():
    PROFILER.reset()
    PROFILER.enable()
    yield PROFILER
    PROFILER.disable()
    PROFILER.reset()


def test_profiler_exclusive_times_sum_to_outer_wall(profiler):
    """Self-times over a nested phase tree sum to the outermost phase's
    wall, and a re-keyed phase attributes its children to its controller
    and shard (tests/test_glassbox.py)."""
    with profiler.phase("drain", controller="engine"):
        time.sleep(0.005)
        with profiler.phase("dequeue"):
            time.sleep(0.005)
        with profiler.phase("reconcile", controller="podclique", shard=2):
            time.sleep(0.005)
            with profiler.phase("store-commit"):
                time.sleep(0.005)
        with profiler.phase("dequeue"):
            pass
    report = profiler.report(wall_seconds=profiler.covered_wall_seconds())
    assert report["covered_wall_seconds"] == pytest.approx(report["attributed_seconds"], rel=0.05)
    assert report["coverage"] == pytest.approx(1.0, abs=0.05)
    rows = {(p["controller"], p["shard"], p["phase"]): p["count"] for p in report["phases"]}
    assert rows == {
        ("engine", -1, "drain"): 1,
        ("engine", -1, "dequeue"): 2,
        ("podclique", 2, "reconcile"): 1,
        ("podclique", 2, "store-commit"): 1,
    }
    assert set(report["by_controller"]) == {"engine", "podclique"}
    assert [p["total_s"] for p in report["phases"]] == sorted(
        (p["total_s"] for p in report["phases"]), reverse=True
    )
    assert len(profiler.report(top=2)["phases"]) == 2


def test_profiler_disabled_is_the_shared_noop():
    PROFILER.disable()
    ph = PROFILER.phase("solve")
    assert ph is profile_mod._NULL_PHASE
    with ph:
        pass
    assert profile_mod.PHASES == jax_profile_mod.PHASES
    assert profile_mod.disabled_check_cost_ns(iters=1000) > 0.0


def test_log_bucket_quantiles_match_jax():
    """The log-bucket histogram gives the JAX package's quantiles on the
    same samples, ordered and bounded by the bucket width."""
    rng = np.random.default_rng(3)
    samples = [3, 5, 9, 100, 4000, 4100, 65000] + [int(x) for x in rng.integers(0, 1 << 20, 200)]
    jax_h, port_h = jax_profile_mod._Hist(), profile_mod._Hist()
    for us in samples:
        jax_h.add(us)
        port_h.add(us)
    assert (port_h.count, port_h.total_us, port_h.max_us) == (
        jax_h.count, jax_h.total_us, jax_h.max_us)
    qs = [port_h.quantile_us(q) for q in (0.1, 0.5, 0.9, 0.99)]
    assert qs == [jax_h.quantile_us(q) for q in (0.1, 0.5, 0.9, 0.99)]
    assert 0 < qs[0] <= qs[1] <= qs[2] <= qs[3] <= port_h.max_us * 1.5
    assert profile_mod._Hist().quantile_us(0.5) == 0.0


# -- gang journeys ------------------------------------------------------------


def _journey_script(tracker, clock):
    """Three gangs through the tracker's marks: g0 and g1 admitted in one
    round (g1 through the residual), g2 deferred, g3 created and deleted."""
    tracker.clock = clock
    for name in ("g0", "g1", "g2", "g3"):
        tracker.note_created("ns", name)
    tracker.note_deleted("ns", "g3")
    for name in ("g0", "g1", "g2"):
        tracker.note_seen("ns", name)
    t0 = tracker.t()
    tracker.note_round(t0, tracker.t(), tracker.t())
    for name in ("g0", "g1", "g2"):
        tracker.note_encoded("ns", name)
    tracker.note_partition("ns", "g0", 1)
    tracker.note_partition("ns", "g1", jax_journey_mod.PARTITION_RESIDUAL)
    for name in ("g0", "g1"):
        tracker.note_commit("ns", name)
        tracker.note_scheduled("ns", name)
    tracker.note_scheduled("ns", "unknown")


def _timeless(doc):
    """A journey document less its times."""
    out = {k: v for k, v in doc.items() if k not in ("phases", "segments", "total_s", "age_s")}
    out["phases"] = [p["phase"] for p in doc.get("phases", [])]
    out["segments"] = sorted(doc.get("segments", {}))
    return out


def test_journeys_match_jax():
    """The same marks give the same journeys (phases, completion, rounds,
    partition), decomposition shape, critical path and pending rows; the
    time series wait, so the window summary is the JAX engine-off shell."""
    jax_j, port_j = jax_journey_mod.JourneyTracker(), journey_mod.JourneyTracker()
    _journey_script(jax_j, JaxClock(4.0))
    _journey_script(port_j, VirtualClock(4.0))
    for name in ("g0", "g1", "g2"):
        got = port_j.journey("ns", name)
        assert _timeless(got) == _timeless(jax_j.journey("ns", name))
    assert port_j.journey("ns", "g0")["complete"] and port_j.journey("ns", "g0")["partition"] == 1
    assert port_j.journey("ns", "g3") is None  # deleted: dropped
    assert port_j.completed_total == jax_j.completed_total == 2
    d = port_j.decomposition()
    assert d["journeys"] == 2 and set(d["segments"]) == set(journey_mod.JOURNEY_SEGMENTS)
    assert d["admission_p99_s"] >= d["admission_p50_s"] >= 0.0
    cp = port_j.critical_path()
    assert cp["journeys"] == 2 and cp["tail"]["complete"]
    assert sum(row["share"] for row in cp["segments"].values()) == pytest.approx(1.0, abs=0.02)
    assert [_timeless(r) for r in port_j.pending()] == [_timeless(r) for r in jax_j.pending()]
    assert [r["stage"] for r in port_j.pending()] == ["solve"]
    assert port_j.pending_ages() == jax_j.pending_ages() == [("ns", 0.0)]
    assert port_j.window_summary(60.0) == jax_j.window_summary(60.0)
    assert journey_mod.JOURNEY_PHASES == jax_journey_mod.JOURNEY_PHASES


def test_recreated_gang_shows_its_live_journey():
    """A deleted and recreated gang's in-flight journey wins over its last
    incarnation's completed one (tests/test_glassbox.py)."""
    j = journey_mod.JourneyTracker()
    j.note_created("ns", "g")
    j.note_seen("ns", "g")
    j.note_round(j.t(), j.t(), j.t())
    j.note_encoded("ns", "g")
    j.note_commit("ns", "g")
    j.note_scheduled("ns", "g")
    assert j.journey("ns", "g")["complete"]
    j.note_created("ns", "g")
    doc = j.journey("ns", "g")
    assert doc["complete"] is False and [p["phase"] for p in doc["phases"]] == ["created"]
    j.reset()
    assert j.journey("ns", "g") is None and j.completed_total == 0


# -- whole rounds -------------------------------------------------------------


class RoundRecorder:
    """Records, while active, one package's metric calls and journey marks
    (the store's created/deleted marks aside), and resets its tracer and
    profiler on entry."""

    NOTES = ("note_seen", "note_round", "note_encoded", "note_partition", "note_commit",
             "note_scheduled")

    def __init__(self, metrics, tracer, journeys, profiler):
        self.metrics, self.tracer, self.journeys, self.profiler = (
            metrics, tracer, journeys, profiler)

    def __enter__(self):
        self.tracer.reset()
        self.profiler.reset()
        self.calls, self.notes = [], []
        self.completed0 = self.journeys.completed_total
        for kind in ("inc", "set", "observe"):
            self._wrap(self.metrics, kind, self.calls)
        for note in self.NOTES:
            self._wrap(self.journeys, note, self.notes)
        return self

    @staticmethod
    def _wrap(obj, name, out):
        inner = getattr(obj, name)

        def record(*args, **kwargs):
            out.append((name,) + args + tuple(kwargs.values()))
            return inner(*args, **kwargs)

        setattr(obj, name, record)

    def __exit__(self, *exc):
        for kind in ("inc", "set", "observe"):
            del self.metrics.__dict__[kind]
        for note in self.NOTES:
            del self.journeys.__dict__[note]

    def result(self) -> dict:
        """What the round recorded that does not depend on time."""
        encoded = sorted({(n[1], n[2]) for n in self.notes if n[0] == "note_encoded"})
        phases = {}
        for ns, name in encoded:
            doc = self.journeys.journey(ns, name)
            # a fresh port world stamps `created` on every gang it loads
            phases[f"{ns}/{name}"] = [p["phase"] for p in doc["phases"] if p["phase"] != "created"]
        return {
            "spans": span_multiset(self.tracer.spans()),
            "inc": Counter((c[1], c[2] if len(c) > 2 else 1.0) for c in self.calls
                           if c[0] == "inc"),
            "set": {c[1]: c[2] for c in self.calls if c[0] == "set"},
            "observe": Counter(c[1] for c in self.calls if c[0] == "observe"
                               and c[1] != "gang_solve_compile_seconds"),
            "notes": [n for n in self.notes if n[0] != "note_round"],
            "rounds_noted": sum(1 for n in self.notes if n[0] == "note_round"),
            "phases": phases,
            "completed": self.journeys.completed_total - self.completed0,
            "profile": sorted((p["controller"], p["shard"], p["phase"], p["count"])
                              for p in self.profiler.report()["phases"]),
        }


def port_recorder():
    return RoundRecorder(METRICS, TRACER, JOURNEYS, PROFILER)


def jax_recorder():
    return RoundRecorder(JAX_METRICS, JAX_TRACER, JAX_JOURNEYS, JAX_PROFILER)


def assert_same_observation(tag, got, want):
    for key in want:
        assert got[key] == want[key], (tag, key, got[key], want[key])


class ObservedBridge(Bridge):
    """Bridge whose rounds run with the glass-box layer on in both
    packages and compare what it recorded, round by round."""

    def round(self, namespace=None):
        JOURNEYS.reset()  # a fresh port world: its journeys start at load
        store, cluster, sched = port_world_from(self.jax_sched)
        # the binding gc pass reads the store (rows the profiler counts): a
        # port cluster that lived through the rounds would hold the JAX
        # map's stale entries too, and skip the pass when the JAX one does
        cluster.bindings = dict(self.jax_sched.cluster.bindings)
        cluster._deleted_since_gc = self.jax_sched.cluster._deleted_since_gc
        EVENTS.clock = store.clock
        with EventCapture(EVENTS) as port_events, port_recorder() as port_rec:
            port_bound = sched.schedule_pending(namespace)
        with EventCapture(JAX_EVENTS) as jax_events, jax_recorder() as jax_rec:
            jax_bound = self.inner(namespace)
        assert port_bound == jax_bound
        assert_same_events(port_events.events, jax_events.events)
        assert_same_world(store, cluster, self.jax_sched.store, self.jax_sched.cluster)
        got, want = port_rec.result(), jax_rec.result()
        assert_same_observation(f"round {len(self.rounds) + 1}", got, want)
        self.rounds.append(want)
        return jax_bound

    def seen(self, key):
        return set().union(*(r[key] for r in self.rounds))


def test_simple1_rounds_observe_as_jax(harness_factory, glassbox):
    h = harness_factory(num_nodes=16)
    bridge = ObservedBridge(h.scheduler, monitor=h.node_monitor, broker=h.disruption)
    h.apply(simple1())
    h.converge()
    assert len(bridge.rounds) >= 3
    assert "scheduler.commit<scheduler.schedule" in bridge.seen("spans")
    assert sum(r["completed"] for r in bridge.rounds) >= 1
    assert any(("scheduler", -1, "commit") == p[:3] for r in bridge.rounds for p in r["profile"])


def test_preemption_rounds_observe_as_jax(harness_factory, glassbox):
    from grove_tpu.config.operator import load_operator_configuration
    from tests.test_preemption import small_pcs

    cfg = load_operator_configuration("solver: {priorityClasses: {critical: 100, batch: 1}}")
    h = harness_factory(num_nodes=2, config=cfg)
    for n in h.cluster.nodes:
        n.capacity = {"cpu": 8.0}
    bridge = ObservedBridge(h.scheduler, monitor=h.node_monitor, broker=h.disruption)
    h.apply(small_pcs("low", cpu=4, priority_class="batch"))
    h.converge()
    h.apply(small_pcs("high", cpu=4, priority_class="critical"))
    h.converge()
    assert ("gang_preemptions_total", 1.0) in bridge.seen("inc")
    # the trial solves of preemption nest in the round, as in JAX: no span
    # of its own around them
    assert "scheduler.solve<scheduler.schedule" in bridge.seen("spans")
    assert not any(s.startswith("scheduler.preempt") for s in bridge.seen("spans"))


def test_reclaim_rounds_observe_as_jax(harness_factory, glassbox):
    from grove_tpu.sim import multitenant

    tenants = (("team-a", 3.0, 6), ("team-b", 2.0, 6), ("team-c", 1.0, 6))
    h, _ = multitenant.build_contended_harness(tenants=tenants)
    assert h.scheduler.delta is None
    bridge = ObservedBridge(h.scheduler, monitor=h.node_monitor, broker=h.disruption)
    h.converge(max_ticks=120)
    assert ("quota_reclaims_total", 1.0) in bridge.seen("inc")
    assert "scheduler.solve<quota.reclaim" in bridge.seen("spans")


def _world_pair(name, n_nodes, n_gangs, ticks=None, delta=False, frontier=False):
    """One scheduler world loaded into both packages from its documents."""
    w = scheduler_world(name, n_nodes, n_gangs, ticks)
    jax_store = JaxStore(JaxClock(0.0))
    jax_cluster = JaxCluster(store=jax_store, nodes=jax_make_nodes(*w["nodes"]))
    jax_sched = JaxScheduler(jax_store, jax_cluster, JaxTopology(), w["priority_map"])
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store, make_nodes(*w["nodes"]))
    sched = GangScheduler(store, cluster, ClusterTopology(), w["priority_map"], device="cpu")
    for s in (jax_sched, sched):
        if delta:
            assert s.enable_delta()
        if frontier:
            assert s.enable_frontier()
    return w, (jax_store, jax_cluster, jax_sched), (store, cluster, sched)


def _observed_round(jax_side, port_side, tag):
    (jax_store, jax_cluster, jax_sched), (store, cluster, sched) = jax_side, port_side
    with EventCapture(JAX_EVENTS) as jax_events, jax_recorder() as jax_rec:
        jax_sched.schedule_pending()
    with EventCapture(EVENTS) as port_events, port_recorder() as port_rec:
        sched.schedule_pending()
    assert_same_events(port_events.events, jax_events.events)
    assert_same_world(store, cluster, jax_store, jax_cluster)
    want, got = jax_rec.result(), port_rec.result()
    # both worlds were created with the journeys on: every phase compares
    assert_same_observation(tag, got, want)
    return want


@pytest.mark.parametrize("world", ["delta", "frontier"])
def test_delta_and_frontier_rounds_observe_as_jax(world, glassbox):
    """A cut of the churn world (δ) and of the frontier's (φ) (two slices
    of 64 nodes), round 1 and a churn tick, through both packages with
    delta (and the frontier) on: the delta encode, the partitioned solve
    and every gang's partition stamp recorded alike."""
    JAX_EVENTS.reset()
    EVENTS.reset()
    w, jax_side, port_side = _world_pair(
        world, 128, 96, ticks=1, delta=True, frontier=world == "frontier")
    rounds = []
    for step, tick in enumerate([None] + w["ticks"]):
        for (store, cluster, _), decode in ((jax_side, jax_decode), (port_side, decode_object)):
            if tick is None:
                for doc in w["queues"] + w["rounds"][0]:
                    store.create(decode(doc))
            else:
                apply_tick(store, cluster, tick, decode)
        rounds.append(_observed_round(jax_side, port_side, f"{world} round {step + 1}"))
    spans = set().union(*(r["spans"] for r in rounds))
    assert "solve.delta_encode<scheduler.schedule" in spans
    if world == "frontier":
        assert "solve.partition<scheduler.schedule" in spans
        partitions = {n[3] for r in rounds for n in r["notes"] if n[0] == "note_partition"}
        assert len(partitions) >= 2
    assert port_side[2].delta.state_fingerprint() == jax_side[2].delta.state_fingerprint()
    JAX_EVENTS.reset()
    EVENTS.reset()


def test_cut_q_world_observes_and_explains_as_jax(glassbox):
    """The card's `[observe]` on (q) cut to 32 nodes and 72 gangs (four
    stay pending): the world created with the layer on, the round's spans,
    metric calls, journeys and profiler rows equal to JAX's,
    ``observe_summary`` equal, every admitted gang's journey complete; then
    the explain burst's documents equal (less timing) and the read-only pin
    held; and the same round with everything off gives the same results."""
    world, n_nodes, n_gangs = "q", 32, 72
    JAX_EVENTS.reset()
    EVENTS.reset()
    JAX_METRICS.reset()
    METRICS.reset()
    w, jax_side, port_side = _world_pair(world, n_nodes, n_gangs)
    summaries = []
    for index, docs in enumerate([w["queues"]] + w["rounds"]):
        for doc in docs:
            jax_side[0].create(jax_decode(doc))
            port_side[0].create(decode_object(doc))
        if index == 0:
            continue
        JAX_METRICS.reset()
        METRICS.reset()
        _observed_round(jax_side, port_side, f"({world}) round {index}")
        got = observe_summary(TRACER, METRICS, JOURNEYS)
        assert got == observe_summary(JAX_TRACER, JAX_METRICS, JAX_JOURNEYS)
        summaries.append(got)
    store, cluster, sched = port_side
    for gang in store.scan("PodGang"):
        if any(c.type == "Scheduled" and c.status == "True" for c in gang.status.conditions):
            doc = JOURNEYS.journey(gang.metadata.namespace, gang.metadata.name)
            assert doc["complete"], doc
    assert summaries[0]["journeys_completed_total"] > 0
    pin = store.resource_version_vector()
    want = explain_burst(JaxExplainEngine(jax_side[2]), jax_side[0], jax_side[1])
    got = explain_burst(ExplainEngine(sched), store, cluster)
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key
    assert store.resource_version_vector() == pin == jax_side[0].resource_version_vector()
    # everything off: the same rounds, the same results
    for layer in PORT:
        layer.disable()
    _, _, (store2, cluster2, sched2) = _world_pair(world, n_nodes, n_gangs)
    for index, docs in enumerate([w["queues"]] + w["rounds"]):
        for doc in docs:
            store2.create(decode_object(doc))
        if index:
            sched2.schedule_pending()
    assert_same_world(store2, cluster2, store, cluster)
    JAX_EVENTS.reset()
    EVENTS.reset()
