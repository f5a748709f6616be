"""The port's SLO observatory and flight recorder against the JAX package's,
on the CPU, fed the same seeded streams.

- ``TimeSeriesStore``: seeded storms (``tests/test_slo_observatory.py``'s
  generator and its NumPy oracle) through both engines, every window at
  every probe equal to the oracle's and to JAX's bit for bit, ring
  wraparound included; counter tracking and collectors.
- ``SloSpec`` / ``SloEngine``: the grammar (parsed fields, rendering, the
  errors) and the engine over good/bad patterns (breach, recovery, burn on
  both windows, budget math, no data, a reducer of the wrong kind): equal
  ``status()``, events and Prometheus rows.
- ``Forecaster``: seeded diurnal storms, the persistence and absent
  shells, the skill feed and ``report``: equal documents.
- ``DecisionLedger``: the same chains, effects and eviction: equal status
  and events.
- ``FlightRecorder``: a bundle less its wall stamps equal to JAX's.
- The store's ``pod_counters`` / ``pod_summary`` against a full rescan and
  the JAX store, over a seeded pod storm; ``window_summary`` against the
  SLO indicator.
- The SLO world (``models/scenarios.run_slo_world``) cut to 256 nodes,
  through both packages with the observatory on: every round, the series
  windows, the SLO status, the forecast and the flight bundle equal.
"""

import math
import random
import tempfile
import types

import numpy as np
import pytest

from grove_tpu.api.topology import ClusterTopology as JaxTopology
from grove_tpu.api.wire import decode_object as jax_decode
from grove_tpu.observability import events as jax_events_mod
from grove_tpu.observability import flightrec as jax_flightrec
from grove_tpu.observability import forecast as jax_forecast
from grove_tpu.observability import journey as jax_journey
from grove_tpu.observability import ledger as jax_ledger
from grove_tpu.observability import slo as jax_slo
from grove_tpu.observability import timeseries as jax_ts
from grove_tpu.observability import tracing as jax_tracing
from grove_tpu.observability.metrics import METRICS as JAX_METRICS
from grove_tpu.runtime.clock import VirtualClock as JaxClock
from grove_tpu.runtime.store import Store as JaxStore
from grove_tpu.sim.cluster import SimCluster as JaxCluster, make_nodes as jax_make_nodes
from grove_tpu.solver.scheduler import GangScheduler as JaxScheduler
from grove_tpu_torch.api.meta import Condition, set_condition
from grove_tpu_torch.api.pod import ContainerStatus
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.api.wire import decode_object
from grove_tpu_torch.models.scenarios import (
    flight_summary,
    gang_world_docs,
    run_slo_world,
    stress_gang_specs,
)
from grove_tpu_torch.observability import events as events_mod
from grove_tpu_torch.observability import flightrec
from grove_tpu_torch.observability import forecast
from grove_tpu_torch.observability import journey
from grove_tpu_torch.observability import ledger
from grove_tpu_torch.observability import slo
from grove_tpu_torch.observability import timeseries as ts
from grove_tpu_torch.observability import tracing
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.runtime.aggregate import pod_features
from grove_tpu_torch.runtime.clock import VirtualClock
from grove_tpu_torch.runtime.store import Store
from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
from grove_tpu_torch.solver.scheduler import GangScheduler
from tests.test_slo_observatory import NumpyOracle, _storm

PORT = types.SimpleNamespace(
    TIMESERIES=ts.TIMESERIES, SLO=slo.SLO, SloSpec=slo.SloSpec, FORECASTER=forecast.FORECASTER,
    LEDGER=ledger.LEDGER, FLIGHTREC=flightrec.FLIGHTREC, JOURNEYS=journey.JOURNEYS,
    EVENTS=events_mod.EVENTS, METRICS=METRICS, TRACER=tracing.TRACER, ledger=ledger,
    parse_duration=slo.parse_duration, load_bundle=flightrec.load_bundle)
JAX = types.SimpleNamespace(
    TIMESERIES=jax_ts.TIMESERIES, SLO=jax_slo.SLO, SloSpec=jax_slo.SloSpec,
    FORECASTER=jax_forecast.FORECASTER, LEDGER=jax_ledger.LEDGER,
    FLIGHTREC=jax_flightrec.FLIGHTREC, JOURNEYS=jax_journey.JOURNEYS,
    EVENTS=jax_events_mod.EVENTS, METRICS=JAX_METRICS, TRACER=jax_tracing.TRACER,
    ledger=jax_ledger, parse_duration=jax_slo.parse_duration,
    load_bundle=jax_flightrec.load_bundle)
SIDES = (PORT, JAX)


def _disarm():
    for side in SIDES:
        side.TIMESERIES.disable()
        side.TIMESERIES.reset()
        side.TIMESERIES.tap = None
        side.TIMESERIES.clock = None
        for layer in (side.SLO, side.FORECASTER, side.LEDGER, side.JOURNEYS, side.TRACER):
            layer.disable()
            layer.reset()
        side.FLIGHTREC.disable()
        side.FLIGHTREC.reset()
        side.JOURNEYS.clock = side.TRACER.clock = side.EVENTS.clock = None
        side.EVENTS.reset()
        side.METRICS.reset()


@pytest.fixture(autouse=True)
def observatories():
    """Both packages' process-global layers disarmed and empty around every
    test."""
    _disarm()
    yield
    _disarm()


def _event_rows(recorder):
    return sorted((r.kind, r.namespace, r.name, r.type, r.reason, r.message, r.count)
                  for r in recorder.list())


# -- the time-series engine --------------------------------------------------------

NAMES = ("g:a", "g:b", "ready_fraction", "d:lat", "d:wait", "never")


class _Both:
    """Feeds one storm into the port's engine, the JAX engine and the
    oracle alike."""

    def __init__(self, capacity):
        self.engines = (ts.TimeSeriesStore(capacity=capacity).enable(),
                        jax_ts.TimeSeriesStore(capacity=capacity).enable())
        self.oracle = NumpyOracle(capacity=capacity)

    def gauge(self, name, value, vt):
        for e in self.engines:
            e.gauge(name, value, vt=vt)

    def observe(self, name, value, vt):
        for e in self.engines:
            e.observe(name, value, vt=vt)


@pytest.mark.parametrize("seed,capacity,windows", [
    (7, 4096, (1.0, 5.0, 30.0, 120.0, 1000.0)),
    (1234, 4096, (1.0, 5.0, 30.0, 120.0, 1000.0)),
    (2026, 4096, (1.0, 5.0, 30.0, 120.0, 1000.0)),
    (3, 32, (5.0, 31.0, 200.0)),
    (99, 32, (5.0, 31.0, 200.0)),
], ids=["storm7", "storm1234", "storm2026", "wrap3", "wrap99"])
def test_reducers_match_jax_and_the_oracle(seed, capacity, windows):
    both = _Both(capacity)
    checked = [0]

    def check(vt):
        for name in NAMES:
            for w in windows:
                got, want = (e.window(name, w, now=vt) for e in both.engines)
                assert got == want, (name, w, vt)
                oracle = both.oracle.window(name, w, now=vt)
                if oracle.get("n", 0) == 0 and oracle.get("count", 0) == 0:
                    assert got.get("n", 0) == 0 and got.get("count", 0) == 0
                    continue
                assert got == oracle, (name, w, vt)
                checked[0] += 1
        assert both.engines[0].gauge_samples("g:a", 60.0, now=vt) == \
            both.engines[1].gauge_samples("g:a", 60.0, now=vt)

    end = _storm(seed, both, both.oracle, check, n_events=3000 if capacity > 32 else 2000)
    assert checked[0] > 50
    if capacity == 32:
        assert end > 32 * 5  # the ring wrapped
    for e in both.engines:
        assert e.series_names() == sorted(NAMES[:-1])
    assert both.engines[0].snapshot(60.0) == both.engines[1].snapshot(60.0)


def test_sample_tracks_counters_and_runs_collectors():
    for side in SIDES:
        side.TIMESERIES.enable()
        side.METRICS.inc("probe_total", 5)
        side.TIMESERIES.track_counter("probe_total")
        fired = []
        side.TIMESERIES.add_collector(fired.append)
        side.METRICS.inc("probe_total", 3)
        side.TIMESERIES.sample(1.0)
        side.TIMESERIES.remove_collector(fired.append)
        side.TIMESERIES.remove_collector(fired.append)
        side.METRICS.inc("probe_total", 4)
        side.TIMESERIES.sample(2.0)
        assert fired == [1.0]
    got, want = (s.TIMESERIES.window("rate:probe_total", 10.0, now=2.0) for s in SIDES)
    assert got == want and got["n"] == 2 and got["last"] == 4.0
    assert METRICS.counters["timeseries_samples_total"] == 2
    assert PORT.TIMESERIES.reduce("rate:probe_total", "min", 10.0, now=2.0) == 3.0
    assert PORT.TIMESERIES.reduce("nothing", "p99", 10.0, now=2.0) is None


# -- the SLO grammar and engine ------------------------------------------------------

SPECS = (
    "admission_latency_vt:p99 < 1s over 5m target 99.9% budget 1h burn 14.4x 5m/1h",
    "ready_fraction >= 0.9 over 2m",
    "ready_fraction/default/serve >= 0.9 over 90s",
    "scaleup_latency_vt:p50 < 500ms over 1m",
    "queue_wait_vt/tenant-0:last <= 2h over 1d target 50%",
)


@pytest.mark.parametrize("text", SPECS)
def test_spec_grammar_matches_jax(text):
    got, want = (s.SloSpec.parse(text) for s in SIDES)
    assert vars(got) == vars(want)
    assert got.render() == want.render()


@pytest.mark.parametrize("bad", ["no-operator over 5m", "lat:p99 < 1s", "", "lat < 1s over 5 parsecs"])
def test_spec_errors_match_jax(bad):
    messages = []
    for side in SIDES:
        with pytest.raises(ValueError) as err:
            side.SloSpec.parse(bad)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    for side in SIDES:
        with pytest.raises(ValueError):
            side.parse_duration("5 parsecs")
        with pytest.raises(ValueError):
            side.SloSpec(name="x", series="s", op="<", threshold=1, window=60, target=1.5)


SLO_CASES = {
    # spec, pattern [(ticks, good)], gauge series instead of a distribution
    "breach_recovery": ("lat:p99 < 1s over 10s target 80% budget 60s burn 2x 10s/30s",
                        [(60, True), (30, False), (120, True)], False),
    "budget": ("lat:p99 < 1s over 5s target 90% budget 100s", [(95, True), (5, False)], False),
    "burn": ("lat:p99 < 1s over 2s target 90% budget 300s burn 3x 10s/60s",
             [(120, True), (6, False), (30, True), (60, False)], False),
    "gauge_mean": ("lat:mean <= 1 over 20s target 95% budget 120s",
                   [(40, True), (50, False), (40, True)], True),
    "config_error": ("lat:rate < 1 over 5s target 90%", [(10, True)], True),
}


def _run_slo(side, name, spec, pattern, gauge, flight_dir=None):
    side.TIMESERIES.enable()
    side.SLO.enable()
    if flight_dir is not None:
        side.FLIGHTREC.enable(out_dir=flight_dir)
    side.SLO.add(side.SloSpec.parse(spec, name=name))
    vt = 0.0
    for n_ticks, good in pattern:
        for _ in range(n_ticks):
            vt += 1.0
            value = 0.1 if good else 10.0
            if gauge:
                side.TIMESERIES.gauge("lat", value, vt=vt)
            else:
                side.TIMESERIES.observe("lat", value, vt=vt)
            side.TIMESERIES.sample(vt)
            side.SLO.evaluate(vt)
    side.SLO.evaluate(vt)  # one verdict per tick: a second call counts nothing
    side.SLO.evaluate(200_000.0)  # no data in the window: not evaluated
    return vt


@pytest.mark.parametrize("case", list(SLO_CASES))
def test_slo_engine_matches_jax(case):
    spec, pattern, gauge = SLO_CASES[case]
    with tempfile.TemporaryDirectory() as port_dir, tempfile.TemporaryDirectory() as jax_dir:
        for side, out in ((PORT, port_dir), (JAX, jax_dir)):
            _run_slo(side, case, spec, pattern, gauge, flight_dir=out)
        got, want = (s.SLO.status(300.0) for s in SIDES)
        assert got == want
        assert PORT.SLO.burning() == JAX.SLO.burning()
        assert PORT.SLO.budget_remaining(case) == JAX.SLO.budget_remaining(case)
        assert [r[:5] + r[6:] for r in _event_rows(PORT.EVENTS)] == \
            [r[:5] + r[6:] for r in _event_rows(JAX.EVENTS)]
        assert {k: v for k, v in METRICS.gauges.items() if k.startswith("slo_")} == \
            {k: v for k, v in JAX_METRICS.gauges.items() if k.startswith("slo_")}
        assert {k: v for k, v in METRICS.counters.items() if k.startswith("slo_")} == \
            {k: v for k, v in JAX_METRICS.counters.items() if k.startswith("slo_")}
        row = got["objectives"][0]
        if case == "config_error":
            assert row["state"] == "config-error" and row["evaluations"] == 0
        else:
            assert row["evaluations"] == sum(n for n, _ in pattern)
        if case == "breach_recovery":
            assert row["breaches"] == 1 and row["recoveries"] == 1
        if case == "burn":
            assert len(PORT.EVENTS.list(reason="SloBurnRateHigh")) == 1
        if row["breaches"]:
            bundles = [s.load_bundle(s.FLIGHTREC.dumps[0]) for s in SIDES]
            assert bundles[0]["reason"] == "SloBreach"
            assert bundles[0]["detail"] == bundles[1]["detail"]
            assert f"objective={case}" in bundles[0]["detail"]
        prom = [ln for ln in METRICS.prometheus_text().splitlines() if "slo_" in ln]
        jax_prom = [ln for ln in JAX_METRICS.prometheus_text().splitlines() if "slo_" in ln]
        assert prom == jax_prom


def test_window_summary_equals_the_slo_indicator():
    """The journey view's window and the SLO indicator cite the same
    number, in both packages alike."""
    values = []
    for side in SIDES:
        side.TIMESERIES.enable()
        side.SLO.enable()
        spec = side.SLO.add("admission_latency_vt:p99 < 60s over 120s target 90%")
        rng = random.Random(4)
        vt = 0.0
        for _ in range(200):
            vt += 1.0
            side.TIMESERIES.observe("admission_latency_vt", rng.uniform(0, 90), vt=vt)
        side.TIMESERIES.sample(vt)
        side.SLO.evaluate(vt)
        row = side.SLO.status()["objectives"][0]
        summary = side.JOURNEYS.window_summary(spec.window)
        assert summary["virtual"]["p99"] == row["value"] and summary["enabled"]
        values.append((summary, row))
    assert values[0] == values[1]


def test_journey_completion_feeds_the_series():
    """A completed journey observes its wall and virtual admission latency;
    with the time series off it observes nothing."""
    for side in SIDES:
        clock = VirtualClock(0.0) if side is PORT else JaxClock(0.0)
        side.JOURNEYS.enable()
        side.JOURNEYS.clock = clock
        for name in ("g0", "g1"):
            side.JOURNEYS.note_created("ns", name)
        side.JOURNEYS.note_seen("ns", "g0")
        clock.advance(7.0)
        side.JOURNEYS.note_round(0.0, 0.1, 0.2)
        side.JOURNEYS.note_encoded("ns", "g0")
        side.JOURNEYS.note_commit("ns", "g0")
        side.JOURNEYS.note_scheduled("ns", "g0")
        assert side.TIMESERIES.series_names() == []
        side.TIMESERIES.enable(clock=clock)
        side.JOURNEYS.note_seen("ns", "g1")
        side.JOURNEYS.note_encoded("ns", "g1")
        side.JOURNEYS.note_commit("ns", "g1")
        side.JOURNEYS.note_scheduled("ns", "g1")
        assert side.TIMESERIES.window("admission_latency", 100.0)["count"] == 1
        assert side.JOURNEYS.completed_total == 2
    got, want = (s.TIMESERIES.window("admission_latency_vt", 100.0) for s in SIDES)
    assert got == want and got["count"] == 1 and got["max"] == 7.0
    assert PORT.JOURNEYS.window_summary(100.0)["virtual"] == got


# -- the forecaster ---------------------------------------------------------------


def _diurnal_storm(side, seed, n_events, name="demand"):
    rng = random.Random(seed)
    vt = 0.0
    for _ in range(n_events):
        vt += rng.choice([0.0, 0.1, 0.3, 1.0, 2.5, 7.0, 19.0])
        value = 5.0 + 0.004 * vt + 2.0 * math.sin(2.0 * math.pi * vt / 600.0) + rng.gauss(0.0, 0.3)
        side.TIMESERIES.gauge(name, value, vt=vt)
    return vt


@pytest.mark.parametrize("case", ["storm7", "storm1234", "wrap", "persistence", "absent"])
def test_forecast_matches_jax(case):
    docs = []
    for side in SIDES:
        capacity = 256 if case == "wrap" else 4096
        side.TIMESERIES.enable(capacity=capacity)
        side.FORECASTER.enable(period=600.0, horizon=300.0, history=1800.0)
        seed = {"storm7": 7, "storm1234": 1234, "wrap": 5, "persistence": 9, "absent": 0}[case]
        n = {"persistence": 5, "absent": 0}.get(case, 1500)
        vt = _diurnal_storm(side, seed, n)
        doc = side.FORECASTER.forecast("demand", now=vt, feed=True)
        docs.append((doc, side.FORECASTER.forecast("demand", horizon=120.0, now=vt),
                     side.TIMESERIES.window("forecast_skill/demand", 10.0, now=vt)))
        side.TIMESERIES.enable(capacity=4096)
    assert docs[0] == docs[1]
    model = docs[0][0]["model"]
    assert model == {"persistence": "persistence", "absent": "absent"}.get(case, "diurnal-trend")
    if model == "diurnal-trend":
        assert len(docs[0][0]["points"]) == 12
    if case.startswith("storm"):  # a ring shorter than the horizon has no lag pairs
        assert "skill" in docs[0][0] and docs[0][2]["n"] == 1
    assert METRICS.counters["forecast_evaluations_total"] == 2


def test_forecast_report_sweeps_watched_series():
    docs = []
    for side in SIDES:
        side.TIMESERIES.enable()
        side.FORECASTER.enable()
        _diurnal_storm(side, 11, 400, name="a")
        vt = _diurnal_storm(side, 12, 400, name="b")
        side.FORECASTER.watch("a")
        side.FORECASTER.watch("b")
        side.FORECASTER.watch("a")
        docs.append(side.FORECASTER.report(now=vt))
    assert docs[0] == docs[1]
    assert [f["series"] for f in docs[0]["forecasts"]] == ["a", "b"]


# -- the decision ledger ------------------------------------------------------------


def _ledger_chains(side):
    lg = side.ledger
    side.LEDGER.enable(capacity=8)
    assert side.LEDGER.record(lg.TRIGGER_SLO_BURN, lg.ACTION_DRAIN_NODE, lg.OUTCOME_EXECUTED) \
        is not None
    ids = []
    for i in range(12):
        ids.append(side.LEDGER.record(
            [lg.TRIGGER_SLO_BURN, lg.TRIGGER_FORECAST_PEAK, lg.TRIGGER_FAILSLOW][i % 3],
            [lg.ACTION_MIGRATE_GANG, lg.ACTION_SCALE_UP, lg.ACTION_DRAIN_NODE][i % 3],
            [lg.OUTCOME_EXECUTED, lg.OUTCOME_SKIPPED][i % 2],
            trigger_detail=f"detail {i}",
            diagnosis={"gang": f"default/g{i}", "binding_constraint": "topology"},
            simulation={"flipped": [True, None, False][i % 3]},
            action={"target": f"node-{i}"} if i % 4 else None,
            reason="" if i % 2 == 0 else "cooldown",
            now=float(i),
        ))
    assert side.LEDGER.effect(ids[-1], 30.0, 0.25, 0.75, now=40.0)
    assert side.LEDGER.effect(ids[-2], 30.0, None, 0.75, now=41.0)
    assert not side.LEDGER.effect(ids[0], 30.0, 0.0, 1.0)  # evicted
    return (side.LEDGER.status(), side.LEDGER.entries(outcome=lg.OUTCOME_EXECUTED),
            side.LEDGER.entries(action_kind=lg.ACTION_SCALE_UP))


def test_ledger_matches_jax():
    for side in SIDES:
        side.LEDGER.disable()
        assert side.LEDGER.record(side.ledger.TRIGGER_SLO_BURN, side.ledger.ACTION_DRAIN_NODE,
                                  side.ledger.OUTCOME_EXECUTED) is None
    got, want = (_ledger_chains(s) for s in SIDES)
    assert got == want
    assert got[0]["recorded_total"] == 13 and got[0]["retained"] == 8
    assert PORT.ledger.ACTION_KINDS == JAX.ledger.ACTION_KINDS
    assert PORT.ledger.TRIGGER_KINDS == JAX.ledger.TRIGGER_KINDS
    assert [r[:5] + r[6:] for r in _event_rows(PORT.EVENTS)] == \
        [r[:5] + r[6:] for r in _event_rows(JAX.EVENTS)]
    assert {k: v for k, v in METRICS.counters.items() if k.startswith("remediation")} == \
        {k: v for k, v in JAX_METRICS.counters.items() if k.startswith("remediation")}


# -- the flight recorder -------------------------------------------------------------


def _small_round(side, out_dir):
    """A small scheduler round with the tracer and the flight recorder on,
    then an explicit trigger and a reconcile error; the bundle's manifest."""
    if side is PORT:
        store = Store(VirtualClock(5.0))
        cluster = SimCluster(store, make_nodes(16, {"cpu": 128.0, "tpu": 8.0}, 4, 4))
        sched = GangScheduler(store, cluster, ClusterTopology(), device="cpu")
        decode = decode_object
    else:
        store = JaxStore(JaxClock(5.0))
        cluster = JaxCluster(store=store, nodes=jax_make_nodes(16, {"cpu": 128.0, "tpu": 8.0}, 4, 4))
        sched = JaxScheduler(store, cluster, JaxTopology())
        decode = jax_decode
    side.TRACER.clock = side.EVENTS.clock = store.clock
    side.TRACER.enable()
    side.FLIGHTREC.enable(out_dir=out_dir, clock=store.clock, capacity=256, max_dumps=1)
    for doc in gang_world_docs(stress_gang_specs(24, seed=3)):
        store.create(decode(doc))
    sched.schedule_pending()
    side.FLIGHTREC.note_error("podclique", ("default", "x"), ValueError("boom"))
    first = side.FLIGHTREC.trigger("probe", "explicit")
    assert side.FLIGHTREC.trigger("probe", "again") is None  # this kind's budget spent
    assert side.FLIGHTREC.trigger("other") is not None  # another kind's own budget
    manifest = side.load_bundle(first)
    assert manifest["chrome"] and all(e["ph"] == "X" for e in manifest["chrome"])
    return manifest


def test_flight_bundle_matches_jax():
    with tempfile.TemporaryDirectory() as port_dir, tempfile.TemporaryDirectory() as jax_dir:
        got, want = (_small_round(s, d) for s, d in ((PORT, port_dir), (JAX, jax_dir)))
    assert flight_summary(got) == flight_summary(want)
    assert flight_summary(got)["commits"] > 0 and flight_summary(got)["spans"]
    assert [{k: v for k, v in e.items() if k != "t"} for e in got["errors"]] == \
        [{k: v for k, v in e.items() if k != "t"} for e in want["errors"]]
    assert sorted(e["name"] for e in got["chrome"]) == sorted(e["name"] for e in want["chrome"])
    assert [len(s.FLIGHTREC.dumps) for s in SIDES] == [2, 2]
    assert METRICS.counters["flightrec_dumps_total"] == 2
    for side in SIDES:
        side.FLIGHTREC.disable()
        assert tracing.FLIGHT_SINK is None and events_mod.EVENTS.sink is None


def test_flight_recorder_flag_is_in_the_all_off_check():
    from grove_tpu_torch.observability.profile import disabled_check_cost_ns

    assert disabled_check_cost_ns(iters=1000) > 0
    PORT.FLIGHTREC.enable()
    assert tracing.FLIGHT_SINK is PORT.FLIGHTREC and PORT.EVENTS.sink is PORT.FLIGHTREC
    PORT.FLIGHTREC.disable()


# -- the store's pod aggregates -------------------------------------------------------


def _rescan(store):
    """(total, ready) and per-clique counters of a full pass over the live
    pods."""
    total = ready = 0
    rows = {}
    for pod in store.scan("Pod"):
        feats = pod_features(pod)
        if feats is None:
            continue
        total += 1
        ready += feats[1]
        clique = pod.metadata.labels.get("grove.io/podclique")
        if clique is None:
            continue
        row = rows.setdefault((pod.metadata.namespace, clique), [0] * 6 + [{}])
        for i in range(6):
            row[i] += feats[i]
        if feats[6] is not None:
            row[6][feats[6]] = row[6].get(feats[6], 0) + 1
    return (total, ready), rows


def _counters(row):
    return [row.total, row.ready, row.scheduled, row.gated, row.error_exits,
            row.started_not_ready, dict(row.hash_counts)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pod_aggregates_equal_a_rescan_and_jax(seed):
    from grove_tpu.api.meta import Condition as JCondition, set_condition as j_set_condition
    from grove_tpu.api.pod import ContainerStatus as JContainerStatus

    rng = random.Random(seed)
    docs = [d for d in gang_world_docs(stress_gang_specs(12, seed=seed)) if d["kind"] == "Pod"]
    for d in docs:
        d["metadata"]["labels"]["grove.io/pod-template-hash"] = f"h{rng.randrange(3)}"
    port, jax_store = Store(VirtualClock(0.0)), JaxStore(JaxClock(0.0))
    live = []
    for step in range(400):
        op = rng.random()
        if op < 0.3 or not live:
            if not docs:
                continue
            doc = docs.pop(0)
            port.create(decode_object(doc))
            jax_store.create(jax_decode(doc))
            live.append((doc["metadata"]["namespace"], doc["metadata"]["name"]))
        elif op < 0.85:
            ns, name = live[rng.randrange(len(live))]
            change = rng.randrange(5)
            flip = rng.choice(["True", "False"])
            started = rng.random() < 0.5
            exit_code = rng.choice([None, 0, 1])
            phase = rng.choice(["Running", "Failed", "Pending"])
            gates = rng.choice([[], ["gate"]])
            for store, cond_cls, set_cond, cs_cls in (
                    (port, Condition, set_condition, ContainerStatus),
                    (jax_store, JCondition, j_set_condition, JContainerStatus)):
                pod = store.get("Pod", ns, name)
                if change < 2:
                    set_cond(pod.status.conditions,
                             cond_cls(type=["Ready", "PodScheduled"][change], status=flip),
                             float(step))
                elif change == 2:
                    pod.status.container_statuses = [
                        cs_cls(name="main", started=started, exit_code=exit_code)]
                elif change == 3:
                    pod.status.phase = phase
                else:
                    pod.spec.scheduling_gates = list(gates)
                if change < 4:
                    store.update_status(pod)
                else:
                    store.update(pod)
        else:
            ns, name = live.pop(rng.randrange(len(live)))
            port.delete("Pod", ns, name)
            jax_store.delete("Pod", ns, name)
        if step % 25 == 0 or step == 399:
            summary, rows = _rescan(port)
            assert port.pod_summary() == summary == jax_store.pod_summary()
            for (ns, clique), row in rows.items():
                got = _counters(port.pod_counters(ns, clique))
                assert got == row == _counters(jax_store.pod_counters(ns, clique))
    assert METRICS.gauges["aggregate_fold_depth"] == JAX_METRICS.gauges["aggregate_fold_depth"]


# -- the SLO world ----------------------------------------------------------------


def _slo_pkg(side):
    if side is PORT:
        from grove_tpu_torch.api.topology import ClusterTopology as Topology
        from grove_tpu_torch.runtime.clock import VirtualClock as Clock

        return types.SimpleNamespace(
            Store=Store, VirtualClock=Clock, SimCluster=SimCluster, make_nodes=make_nodes,
            GangScheduler=lambda *a: GangScheduler(*a, device="cpu"), ClusterTopology=Topology,
            decode_object=decode_object, EVENTS=PORT.EVENTS, METRICS=METRICS,
            TRACER=PORT.TRACER, JOURNEYS=PORT.JOURNEYS, TIMESERIES=PORT.TIMESERIES,
            SLO=PORT.SLO, SloSpec=PORT.SloSpec, FORECASTER=PORT.FORECASTER,
            FLIGHTREC=PORT.FLIGHTREC, install_serving_collector=ts.install_serving_collector,
            load_bundle=PORT.load_bundle)
    return types.SimpleNamespace(
        Store=JaxStore, VirtualClock=JaxClock, SimCluster=JaxCluster, make_nodes=jax_make_nodes,
        GangScheduler=JaxScheduler, ClusterTopology=JaxTopology, decode_object=jax_decode,
        EVENTS=JAX.EVENTS, METRICS=JAX_METRICS, TRACER=JAX.TRACER, JOURNEYS=JAX.JOURNEYS,
        TIMESERIES=JAX.TIMESERIES, SLO=JAX.SLO, SloSpec=JAX.SloSpec, FORECASTER=JAX.FORECASTER,
        FLIGHTREC=JAX.FLIGHTREC, install_serving_collector=jax_ts.install_serving_collector,
        load_bundle=JAX.load_bundle)


@pytest.mark.parametrize("n_nodes,n_gangs,ticks", [(256, 640, 4), (128, 320, 6)])
def test_slo_world_matches_jax(n_nodes, n_gangs, ticks):
    """The churn world through both packages with the observatory on: every
    round's summary and series windows, the final windows, the SLO status,
    the forecast and the flight bundle less timing equal (six ticks: the
    backlog's wait breaches by the sixth round)."""
    runs = []
    for side in SIDES:
        with tempfile.TemporaryDirectory() as out_dir:
            runs.append(run_slo_world(_slo_pkg(side), n_nodes, n_gangs, ticks, out_dir=out_dir))
    got, want = runs
    assert len(got["rounds"]) == ticks + 1
    for index, (g, w) in enumerate(zip(got["rounds"], want["rounds"])):
        assert np.isclose(g.pop("score_sum"), w.pop("score_sum"), rtol=1e-6), index
        assert g == w, f"round {index + 1}"
    assert got["windows"] == want["windows"]
    assert got["status"] == want["status"]
    assert got["forecast"] == want["forecast"]
    assert got["dumps"] == want["dumps"]
    assert got["flight"] == want["flight"]
    assert "queue_wait_vt/tenant-0" in got["windows"]
    assert got["windows"]["admission_latency_vt"]["count"] > 0
    if ticks >= 5:
        assert got["status"]["objectives"][0]["state"] == "breached"
        assert got["flight"]["reason"] == "SloBreach" and got["flight"]["commits"] > 0
