"""The port's voluntary-disruption layer against the JAX package's, on the
CPU, fed the same wire documents.

- The budget API: ``DisruptionBudget.from_dict`` and ``parse_duration``
  field for field; every sample PodCliqueSet exported by the JAX package
  and decoded by the port equal to the JAX object; the world's
  PodCliqueSet, NodeDrain and HorizontalPodAutoscaler documents decoded
  alike; the documents of the existing scheduler worlds unchanged byte for
  byte (sha256 taken before ``gang_world_docs`` gained ``budget_of``).
- ``DisruptionBroker``: inert without budgets (the same admissions as no
  broker), armed by a budget; the all-or-nothing budget, an unavailable
  gang counted against it, the quiet window; the storm breaker's open,
  deny and close, ``note_failure``, ``would_allow`` and ``export_gauges``.
- The scheduler's gates: preemption and quota reclaim with budget-0,
  budget-1 and unbudgeted victims.
- ``NodeDrainController``: a drain that relocates (trial pre-placement,
  whole eviction, readmission, Drained), a drain held by a budget, the
  terminate-and-requeue fallback of a full cluster, ``uncordon``.
- The disruption world (``models/scenarios.run_disruption_world``) cut to
  256 nodes and 160 gangs: every round, event, broker, monitor, drain and
  ledger state equal, and every scripted event shown.

Each step runs on both packages' objects built from the same documents;
results, the events it recorded and the state after it must be equal (the
placement score at rtol 1e-6, the rest bit for bit).
"""

import dataclasses
import hashlib
import json
import types

import numpy as np
import pytest

from grove_tpu.api.load import load_podcliqueset_file
from grove_tpu.api.serialize import export_object
from grove_tpu.api.topology import ClusterTopology as JaxTopology
from grove_tpu.api.types import DisruptionBudget as JaxBudget
from grove_tpu.api.types import parse_duration as jax_parse_duration
from grove_tpu.api.wire import decode_object as jax_decode
from grove_tpu.autoscale.hpa import HorizontalAutoscaler as JaxAutoscaler
from grove_tpu.autoscale.hpa import StaticMetricsProvider as JaxMetricsProvider
from grove_tpu.controller.nodehealth import NodeHealthMonitor as JaxMonitor
from grove_tpu.controller.remediate import RemediationController as JaxRemediator
from grove_tpu.disruption import DisruptionBroker as JaxBroker
from grove_tpu.disruption import NodeDrainController as JaxDrainer
from grove_tpu.observability.events import EVENTS as JAX_EVENTS
from grove_tpu.observability.explain import ExplainEngine as JaxExplain
from grove_tpu.observability.ledger import LEDGER as JAX_LEDGER
from grove_tpu.observability.metrics import METRICS as JAX_METRICS
from grove_tpu.runtime.clock import VirtualClock as JaxClock
from grove_tpu.runtime.store import Store as JaxStore
from grove_tpu.sim.cluster import SimCluster as JaxCluster
from grove_tpu.sim.cluster import make_nodes as jax_make_nodes
from grove_tpu.solver.scheduler import GangScheduler as JaxScheduler
from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.api.types import DisruptionBudget, parse_duration
from grove_tpu_torch.api.wire import decode_object
from grove_tpu_torch.autoscale.hpa import HorizontalAutoscaler, StaticMetricsProvider
from grove_tpu_torch.controller.nodehealth import NodeHealthMonitor
from grove_tpu_torch.controller.remediate import RemediationController
from grove_tpu_torch.disruption import DisruptionBroker, NodeDrainController
from grove_tpu_torch.models import scenarios
from grove_tpu_torch.models.scenarios import (
    EventCapture,
    _parity_budget,
    _pcs_doc,
    disruption_missing,
    gang_world_docs,
    queue_docs,
    round_summary,
    run_disruption_world,
    scheduler_world,
    stress_gang_specs,
)
from grove_tpu_torch.observability.events import EVENTS
from grove_tpu_torch.observability.explain import ExplainEngine
from grove_tpu_torch.observability.ledger import LEDGER
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.runtime.clock import VirtualClock
from grove_tpu_torch.runtime.store import Store
from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
from grove_tpu_torch.solver.scheduler import GangScheduler

PORT = types.SimpleNamespace(
    Store=Store, VirtualClock=VirtualClock, SimCluster=SimCluster, make_nodes=make_nodes,
    GangScheduler=GangScheduler, ClusterTopology=ClusterTopology, decode_object=decode_object,
    EVENTS=EVENTS, METRICS=METRICS, LEDGER=LEDGER, DisruptionBroker=DisruptionBroker,
    NodeDrainController=NodeDrainController, NodeHealthMonitor=NodeHealthMonitor,
    RemediationController=RemediationController, HorizontalAutoscaler=HorizontalAutoscaler,
    StaticMetricsProvider=StaticMetricsProvider, ExplainEngine=ExplainEngine,
    sched_kwargs={"device": "cpu"})
JAX = types.SimpleNamespace(
    Store=JaxStore, VirtualClock=JaxClock, SimCluster=JaxCluster, make_nodes=jax_make_nodes,
    GangScheduler=JaxScheduler, ClusterTopology=JaxTopology, decode_object=jax_decode,
    EVENTS=JAX_EVENTS, METRICS=JAX_METRICS, LEDGER=JAX_LEDGER, DisruptionBroker=JaxBroker,
    NodeDrainController=JaxDrainer, NodeHealthMonitor=JaxMonitor,
    RemediationController=JaxRemediator, HorizontalAutoscaler=JaxAutoscaler,
    StaticMetricsProvider=JaxMetricsProvider, ExplainEngine=JaxExplain, sched_kwargs={})
SIDES = (PORT, JAX)

# sha256 of json.dumps(scheduler_world(name, *args), sort_keys=True), taken
# before gang_world_docs gained budget_of
WORLD_DIGESTS = {
    "s": ((), "2e7dab7d7a66ac1eb6709ab261c6ace8de2bd782f805178811e1fe4b8c561dd9"),
    "q": ((), "b3aeea27b93b3782add7c28ab69ce12417cc07e340d439c7fa16b8c818a0d9a9"),
    "r": ((), "9987815372b2b2ad2f541021626dfd40fcfebdf0f2606fcef40a2a8ba16a3d60"),
    "delta": ((None, None, 24, 0),
              "448aecf5d699df35e10f904e08d8a91fe5b94c9d567e1298289d7ef768269172"),
    "frontier": ((None, None, 16, 0),
                 "63b2c992586892cf5b5bc71e8639fdd02b1d1ca006f8c3d0a717f8831d9c3e22"),
}


def _reset():
    for side in SIDES:
        side.EVENTS.reset()
        side.EVENTS.clock = None
        side.METRICS.reset()
        side.LEDGER.disable()
        side.LEDGER.reset()


@pytest.fixture(autouse=True)
def fresh_globals():
    """Both packages' event recorders, metrics and ledgers empty around
    every test."""
    _reset()
    yield
    _reset()


# -- worlds built from the same documents on both sides ---------------------------


def set_docs(name, n_gangs, budget=None, ns="default", cpu=4.0, count=1, priority_class="",
             queue=None):
    """A PodCliqueSet of ``n_gangs`` one-group gangs (``<name>-<k>``, ``count``
    pods of ``cpu`` each, floor = count), every gang labelled part of it."""
    specs = [{"name": f"{name}-{k}", "required_key": None, "preferred_key": None, "priority": 0,
              "groups": [{"name": f"{name}-{k}-w", "demand": {"cpu": cpu}, "count": count,
                          "min_count": count}]} for k in range(n_gangs)]
    docs = gang_world_docs(specs, namespace_of=lambda i, s: ns, queue_of=lambda i, s: queue,
                           priority_class_of=lambda i, s: priority_class)
    for doc in docs:
        doc["metadata"]["labels"][namegen.LABEL_PART_OF] = name
    pcs = _pcs_doc({"name": name, "groups": specs[0]["groups"]}, ns, {}, budget)
    pcs["spec"]["replicas"] = n_gangs
    return [pcs] + docs


def build(side, docs, n_nodes=4, capacity=None, priority_map=None, broker=None, monitor=None,
          hosts=2, blocks=2):
    store = side.Store(side.VirtualClock(0.0))
    cluster = side.SimCluster(store, side.make_nodes(
        n_nodes, dict(capacity or {"cpu": 8.0}), hosts, blocks))
    sched = side.GangScheduler(store, cluster, side.ClusterTopology(), dict(priority_map or {}),
                               **side.sched_kwargs)
    w = types.SimpleNamespace(side=side, store=store, clock=store.clock, cluster=cluster,
                              sched=sched)
    w.broker = side.DisruptionBroker(store, **(broker or {}))
    w.monitor = side.NodeHealthMonitor(store, cluster, **(monitor or {}))
    sched.broker, sched.monitor = w.broker, w.monitor
    w.drainer = side.NodeDrainController(store, cluster, sched, w.monitor, w.broker)
    w.monitor.drain_states = w.drainer.states
    w.docs = {}
    create(w, docs)
    return w


def create(w, docs):
    for doc in docs:
        w.store.create(w.side.decode_object(doc))
        if doc["kind"] == "Pod":
            w.docs[(doc["metadata"]["namespace"], doc["metadata"]["name"])] = doc


def recreate(w):
    """The PodClique controller's part: every pod of the documents that is
    gone comes back under its name."""
    for (ns, name), doc in w.docs.items():
        if w.store.get("Pod", ns, name, readonly=True) is None:
            w.store.create(w.side.decode_object(doc))


def both(docs, **kwargs):
    return [build(side, docs, **kwargs) for side in SIDES]


def step(worlds, fn):
    """Run ``fn(world)`` on each side inside an event capture; the results
    and the recorded events must be equal. Returns the port's result."""
    outs = []
    for w in worlds:
        with EventCapture(w.side.EVENTS) as cap:
            result = fn(w)
        outs.append((result, cap.events))
    assert outs[0] == outs[1]
    return outs[0][0]


def gang_rows(w):
    """Each PodGang's phase and conditions (less the placement score the
    Scheduled message cites: ``schedule`` holds the score at rtol 1e-6)."""
    rows = {}
    for gang in sorted(w.store.scan("PodGang"), key=lambda g: (g.metadata.namespace,
                                                                g.metadata.name)):
        rows[f"{gang.metadata.namespace}/{gang.metadata.name}"] = (
            gang.status.phase,
            [(c.type, c.status, c.reason,
              "" if c.message.startswith("placement score") else c.message,
              c.last_transition_time) for c in gang.status.conditions])
    return rows


def state(w):
    """Everything the disruption layer keeps or writes, read the same way
    from either package."""
    return {
        "bindings": sorted(f"{k[0]}/{k[1]}={v}" for k, v in w.cluster.bindings.items()),
        "gangs": gang_rows(w),
        "tokens": w.broker._tokens,
        "breaker_open": w.broker.breaker_open,
        "armed": w.broker._armed,
        "last_grant": sorted((list(k), v) for k, v in w.broker._last_grant.items()),
        "held": sorted(w.monitor._held),
        "probation": sorted(w.monitor._probation),
        "rescue_pending": sorted(w.monitor._rescue_pending),
        "rescues": w.monitor.rescues,
        "nodes": w.monitor.node_snapshot(),
        "drain": w.drainer.states(),
        "drained": w.drainer.drained_gangs,
        "cordoned": [n.name for n in w.cluster.nodes if n.cordoned],
    }


def assert_same(worlds):
    assert state(worlds[0]) == state(worlds[1])


def schedule(worlds):
    """One round on each side: its round_summary (score at rtol 1e-6)."""
    summaries = []
    for w in worlds:
        with EventCapture(w.side.EVENTS) as cap:
            w.sched.schedule_pending()
        summaries.append(round_summary(w.store, w.cluster, cap.events))
    got, want = dict(summaries[0]), dict(summaries[1])
    assert np.isclose(got.pop("score_sum"), want.pop("score_sum"), rtol=1e-6, atol=0)
    assert got == want
    assert_same(worlds)
    return summaries[0]


def gangs_of(w):
    return sorted(w.store.scan("PodGang"), key=lambda g: (g.metadata.namespace, g.metadata.name))


# -- the budget API -------------------------------------------------------------


@pytest.mark.parametrize("doc", [
    {"maxUnavailableGangs": 1}, {"maxUnavailableGangs": 0, "quietWindow": "30s"},
    {"quietWindow": "1m30s"}, {"quietWindow": 45}, {"maxUnavailableGangs": "2"}, {}, None])
def test_disruption_budget_from_dict_equals_jax(doc):
    got, want = DisruptionBudget.from_dict(doc), JaxBudget.from_dict(doc)
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("value", ["4h", "30m", "1h30m", "10s", "250ms", "1.5h", 12, 1.5])
def test_parse_duration_equals_jax(value):
    assert parse_duration(value) == jax_parse_duration(value)


@pytest.mark.parametrize("value", ["", "abc", "10x", "5m3", "h"])
def test_parse_duration_rejects_what_jax_rejects(value):
    with pytest.raises(ValueError) as got:
        parse_duration(value)
    with pytest.raises(ValueError) as want:
        jax_parse_duration(value)
    assert str(got.value) == str(want.value)


SAMPLES = ("agentic-pipeline", "drain-budget", "multinode-disaggregated", "simple1",
           "simple2-explicit-startup-order", "simple3-explicit-startup-order",
           "single-node-disaggregated", "spread-serving")


def _meta(obj):
    doc = dataclasses.asdict(obj.metadata)
    doc.pop("owner_references", None)  # the port's ObjectMeta does not model them
    return doc


@pytest.mark.parametrize("sample", SAMPLES)
def test_podcliqueset_document_round_trips(sample):
    """A sample PodCliqueSet exported by the JAX package decodes in the port
    to the JAX object: spec, status and metadata equal field for field."""
    pcs = load_podcliqueset_file(f"samples/{sample}.yaml")
    got = decode_object(json.loads(json.dumps(export_object(pcs))))
    assert got.kind == "PodCliqueSet"
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(pcs.spec)
    assert dataclasses.asdict(got.status) == dataclasses.asdict(pcs.status)
    assert _meta(got) == _meta(pcs)
    if sample == "drain-budget":
        assert got.spec.template.disruption_budget is not None


def test_world_documents_decode_alike():
    """The disruption world's PodCliqueSet documents (budgets by parity, the
    serving set), a NodeDrain and an HPA decode to equal objects."""
    world = scheduler_world("disruption", 64, 40)
    docs = [d for d in world["rounds"][0] if d["kind"] == "PodCliqueSet"]
    docs += [{"kind": "NodeDrain", "metadata": {"name": "node-3"},
              "spec": {"state": "Draining", "requestedAt": 12.0}},
             {"kind": "HorizontalPodAutoscaler",
              "metadata": {"name": "h", "namespace": "tenant-1"},
              "spec": {"targetKind": "PodClique", "targetName": "x", "maxReplicas": 4}}]
    assert sum(1 for d in docs if d["kind"] == "PodCliqueSet") == 41
    for doc in docs:
        got, want = decode_object(doc), jax_decode(doc)
        assert got.kind == want.kind
        assert _meta(got) == _meta(want)
        assert (dataclasses.asdict(got.spec) if dataclasses.is_dataclass(got.spec)
                else got.spec) == (dataclasses.asdict(want.spec)
                                   if dataclasses.is_dataclass(want.spec) else want.spec)
    budgets = [decode_object(d).spec.template.disruption_budget for d in docs[1:41]]
    assert [b.max_unavailable_gangs for b in budgets[:4]] == [0, 1, 0, 1]
    assert budgets[1].quiet_window == 30.0 and budgets[0].quiet_window is None


@pytest.mark.parametrize("name", sorted(WORLD_DIGESTS))
def test_existing_worlds_documents_unchanged(name):
    """Without ``budget_of`` every existing world's documents stay byte for
    byte as they were."""
    args, digest = WORLD_DIGESTS[name]
    world = scheduler_world(name, *args)
    assert hashlib.sha256(json.dumps(world, sort_keys=True).encode()).hexdigest() == digest


def test_budget_of_adds_one_podcliqueset_per_spec():
    specs = stress_gang_specs(12, seed=1)
    plain = gang_world_docs(specs)
    budgeted = gang_world_docs(specs, budget_of=_parity_budget)
    assert [d for d in budgeted if d["kind"] != "PodCliqueSet"] == plain
    pcs = [d for d in budgeted if d["kind"] == "PodCliqueSet"]
    assert [d["metadata"]["name"] for d in pcs] == [s["name"] for s in specs]
    assert pcs[1]["spec"]["template"]["disruptionBudget"] == {
        "maxUnavailableGangs": 1, "quietWindow": "30s"}


# -- the broker -----------------------------------------------------------------


def _placed(docs, **kwargs):
    worlds = both(docs, **kwargs)
    schedule(worlds)
    return worlds


def test_unconfigured_broker_is_inert():
    worlds = _placed(set_docs("svc", 2))
    assert step(worlds, lambda w: w.broker.active()) is False
    tokens = step(worlds, lambda w: w.broker._tokens)
    assert step(worlds, lambda w: w.broker.grant(gangs_of(w), "drain")) is True
    assert step(worlds, lambda w: w.broker._tokens) == tokens
    step(worlds, lambda w: w.broker.export_gauges())
    assert not step(worlds, lambda w: sorted(k for k in w.side.METRICS.gauges
                                             if "disrupt" in k))
    assert_same(worlds)


def test_budget_arms_the_broker():
    worlds = _placed(set_docs("svc", 2, budget={"maxUnavailableGangs": 1}))
    assert step(worlds, lambda w: w.broker.active()) is True
    assert_same(worlds)


def _low_docs(budget=None):
    """Two 8-cpu nodes filled by a batch set of two gangs."""
    return set_docs("low", 2, budget=budget, cpu=4.0, count=2, priority_class="batch")


def _high_docs():
    """A critical gang that needs one node's worth."""
    return set_docs("high", 1, cpu=4.0, count=2, priority_class="critical")


PRIORITIES = {"critical": 100, "batch": 1}


def test_inert_broker_gives_the_same_admissions_as_no_broker():
    """No budget anywhere: a round with a broker equals a round without one
    (and the JAX package's): the preemption goes through ungated."""
    docs = _low_docs()
    worlds = both(docs, n_nodes=2, priority_map=PRIORITIES)
    bare = build(PORT, docs, n_nodes=2, priority_map=PRIORITIES)
    bare.sched.broker = bare.sched.monitor = None
    rounds = []
    for index in range(3):
        if index == 1:
            for w in worlds + [bare]:
                create(w, _high_docs())
        rounds.append(schedule(worlds))
        with EventCapture(EVENTS) as cap:
            bare.sched.schedule_pending()
        plain = round_summary(bare.store, bare.cluster, cap.events)
        assert np.isclose(plain.pop("score_sum"), rounds[-1]["score_sum"], rtol=1e-6, atol=0)
        assert plain == {k: v for k, v in rounds[-1].items() if k != "score_sum"}
        for w in worlds + [bare]:
            recreate(w)
    assert [r["evicted"] for r in rounds] == [0, 1, 0]
    assert step(worlds, lambda w: w.broker.active()) is False


def test_all_or_nothing_within_one_set():
    worlds = _placed(set_docs("svc", 2, budget={"maxUnavailableGangs": 1}))
    tokens = step(worlds, lambda w: w.broker._tokens)
    assert step(worlds, lambda w: w.broker.grant(gangs_of(w), "drain")) is False
    assert step(worlds, lambda w: w.broker._tokens) == tokens
    assert step(worlds, lambda w: w.broker.grant(gangs_of(w)[:1], "drain")) is True
    assert_same(worlds)


def test_unavailable_gang_counts_against_the_budget():
    worlds = _placed(set_docs("svc", 2, budget={"maxUnavailableGangs": 1}))
    step(worlds, lambda w: w.sched._evict_victim(gangs_of(w)[0], {"name": "test"}))
    assert step(worlds, lambda w: w.broker.unavailable_gangs(("default", "svc"))) == 1
    assert step(worlds, lambda w: w.broker.grant(gangs_of(w)[1:], "drain")) is False
    assert step(worlds, lambda w: w.broker.grant(gangs_of(w)[:1], "drain")) is True
    assert step(worlds, lambda w: w.broker.voluntarily_disrupted_gangs(("default", "svc"))) == 1
    assert_same(worlds)


def test_quiet_window_paces_grants():
    worlds = _placed(set_docs("svc", 2, budget={"maxUnavailableGangs": 1, "quietWindow": "10s"}))
    assert step(worlds, lambda w: w.broker.grant(gangs_of(w)[:1], "drain")) is True
    assert step(worlds, lambda w: w.broker.would_allow(gangs_of(w)[1])) is False
    assert step(worlds, lambda w: w.broker.grant(gangs_of(w)[1:], "drain")) is False
    step(worlds, lambda w: w.clock.advance(11.0))
    assert step(worlds, lambda w: w.broker.grant(gangs_of(w)[1:], "drain")) is True
    assert_same(worlds)


def test_storm_opens_denies_then_quiet_closes():
    docs = (set_docs("a", 2, budget={"maxUnavailableGangs": 1})
            + set_docs("b", 2, budget={"maxUnavailableGangs": 1}))
    worlds = _placed(docs, broker={"bucket_capacity": 2, "refill_per_second": 0.0,
                                   "close_after": 5.0})
    step(worlds, lambda w: w.broker.arm())
    assert step(worlds, lambda w: w.broker.grant([gangs_of(w)[0]], "storm")) is True
    assert step(worlds, lambda w: w.broker.grant([gangs_of(w)[2]], "storm")) is True
    assert step(worlds, lambda w: w.broker.grant([gangs_of(w)[1]], "storm")) is False
    assert step(worlds, lambda w: w.broker.breaker_open) is True
    assert step(worlds, lambda w: w.broker.would_allow(gangs_of(w)[3])) is False
    assert step(worlds, lambda w: w.broker.grant([gangs_of(w)[3]], "storm")) is False
    step(worlds, lambda w: w.clock.advance(6.0))
    assert step(worlds, lambda w: w.broker.grant([gangs_of(w)[3]], "storm")) is True
    assert step(worlds, lambda w: w.broker.breaker_open) is False
    step(worlds, lambda w: w.broker.export_gauges())
    assert step(worlds, lambda w: dict(sorted(w.side.METRICS.gauges.items())))
    assert step(worlds, lambda w: dict(sorted(w.side.METRICS.counters.items())))
    assert_same(worlds)


def test_note_failure_opens_the_breaker():
    worlds = _placed(set_docs("svc", 2, budget={"maxUnavailableGangs": 1}),
                     broker={"bucket_capacity": 3, "refill_per_second": 0.5})
    step(worlds, lambda w: w.broker.note_failure(weight=2.0, reason="placement failed"))
    assert step(worlds, lambda w: w.broker.breaker_open) is False
    step(worlds, lambda w: w.clock.advance(1.0))
    step(worlds, lambda w: w.broker.note_failure(weight=2.0, reason="placement failed"))
    step(worlds, lambda w: w.broker.note_failure())
    assert step(worlds, lambda w: (w.broker.breaker_open, w.broker._tokens)) == (True, 0.0)
    assert_same(worlds)


# -- the scheduler's gates --------------------------------------------------------


@pytest.mark.parametrize("budget,evicted", [(0, 0), (1, 1), (None, 1)])
def test_preemption_respects_the_victims_budget(budget, evicted):
    """A budget-0 batch set is never a preemption victim (``would_allow``
    keeps it out of the trials); budget 1 or none: one gang goes."""
    docs = _low_docs(budget={"maxUnavailableGangs": budget} if budget is not None else None)
    worlds = both(docs, n_nodes=2, priority_map=PRIORITIES)
    total = 0
    for index in range(3):
        if index == 1:
            for w in worlds:
                create(w, _high_docs())
        total += schedule(worlds)["evicted"]
        for w in worlds:
            recreate(w)
    assert total == evicted
    high = step(worlds, lambda w: [g.status.phase for g in gangs_of(w)
                                   if g.metadata.name.startswith("high")])
    assert (high == ["Pending"]) == (evicted == 0)


def _reclaim_docs(budget):
    queues = queue_docs({"team-a": {"cpu": 8.0}, "team-b": {"cpu": 8.0}})
    return (queues + set_docs("a", 4, budget=budget, ns="team-a", cpu=4.0, queue="team-a"))


@pytest.mark.parametrize("budget,reclaimed", [(0, 0), (1, 1)])
def test_quota_reclaim_respects_the_victims_budget(budget, reclaimed):
    """Team a holds the whole cluster (twice its share); team b's gang
    reclaims from it unless a's budget is 0."""
    worlds = both(_reclaim_docs({"maxUnavailableGangs": budget}), n_nodes=2)
    schedule(worlds)
    for w in worlds:
        create(w, set_docs("b", 1, ns="team-b", cpu=4.0, queue="team-b"))
    got = schedule(worlds)
    assert got["events_by_reason"].get("QuotaReclaim", 0) == reclaimed
    for w in worlds:
        recreate(w)
    assert schedule(worlds)["admitted"] == reclaimed


# -- the drain controller ------------------------------------------------------------


def _drain_docs():
    return (set_docs("keep", 1, budget={"maxUnavailableGangs": 0}, cpu=6.0)
            + set_docs("move", 1, budget={"maxUnavailableGangs": 1}, cpu=6.0))


def _node_of(w, gang_name):
    gang = next(g for g in gangs_of(w) if g.metadata.name == gang_name)
    ref = gang.spec.pod_groups[0].pod_references[0]
    return w.cluster.bindings[(ref.namespace, ref.name)]


def test_drain_relocates_a_gang():
    worlds = _placed(_drain_docs())
    node = step(worlds, lambda w: _node_of(w, "move-0-0"))
    assert step(worlds, lambda w: w.drainer.request_drain(node)) == {"name": node,
                                                                       "drain": "Draining"}
    assert step(worlds, lambda w: w.drainer.request_drain("no-such-node")) is None
    assert step(worlds, lambda w: w.drainer.tick()) == 1
    assert_same(worlds)
    drained = step(worlds, lambda w: w.drainer.drained_gangs)
    assert [d["pre_placed"] for d in drained] == [True]
    for w in worlds:
        recreate(w)
    assert schedule(worlds)["admitted"] == 1
    step(worlds, lambda w: w.clock.advance(1.0))
    assert step(worlds, lambda w: (w.drainer.tick(), w.drainer.states(),
                                   w.drainer.drain_state(node))) == (1, {node: "Drained"},
                                                                     "Drained")
    assert step(worlds, lambda w: w.drainer.next_deadline()) is None
    assert step(worlds, lambda w: w.drainer.uncordon(node)) == {"name": node, "drain": ""}
    assert_same(worlds)


def test_drain_held_by_a_budget_stays_draining():
    worlds = _placed(_drain_docs())
    node = step(worlds, lambda w: _node_of(w, "keep-0-0"))
    step(worlds, lambda w: w.drainer.request_drain(node))
    for _ in range(3):
        assert step(worlds, lambda w: w.drainer.tick()) == 0
        step(worlds, lambda w: w.clock.advance(5.0))
    assert step(worlds, lambda w: w.drainer.states()) == {node: "Draining"}
    assert step(worlds, lambda w: w.drainer.next_deadline()) == 16.0
    assert_same(worlds)


def test_drain_of_a_full_cluster_falls_back_to_requeue():
    """No room elsewhere: the trial pre-placement fails, the gang is evicted
    whole anyway, held in the monitor's backoff, and the failure fed to the
    breaker."""
    docs = set_docs("full", 4, budget={"maxUnavailableGangs": 1}, cpu=8.0)
    worlds = _placed(docs)
    node = step(worlds, lambda w: _node_of(w, "full-0-0"))
    step(worlds, lambda w: w.drainer.request_drain(node))
    step(worlds, lambda w: w.drainer.tick())
    assert [d["pre_placed"] for d in step(worlds, lambda w: w.drainer.drained_gangs)] == [False]
    assert step(worlds, lambda w: sorted(w.monitor._held)) == [("default", "full-0-0")]
    assert step(worlds, lambda w: w.broker._tokens) == 9.0
    assert_same(worlds)


# -- the disruption world --------------------------------------------------------------


def test_cut_disruption_world_every_round_equal():
    """(omega) cut to 256 nodes and 160 gangs through both packages: every
    round's record and the script's choices equal, every scripted event
    shown."""
    runs = [run_disruption_world(side, 256, 160, scheduler_kwargs=side.sched_kwargs)
            for side in SIDES]
    assert not disruption_missing(runs[1])
    assert runs[0]["names"] == runs[1]["names"]
    assert len(runs[0]["rounds"]) == len(runs[1]["rounds"]) >= 15
    for got, want in zip(*(r["rounds"] for r in runs)):
        got, want = dict(got), dict(want)
        assert np.isclose(got.pop("score_sum"), want.pop("score_sum"), rtol=1e-6, atol=0)
        assert got == want
    assert scenarios.DISRUPTION_BROKER["bucket_capacity"] == 2
