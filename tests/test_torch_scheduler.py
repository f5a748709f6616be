"""The port's scheduler round against the JAX package's, on the CPU.

Each JAX ``SimHarness`` scenario runs as usual (from-scratch solves:
``GROVE_TPU_NO_DELTA=1``), with its scheduler's ``schedule_pending``
wrapped: before every JAX round the world — Pods, PodGangs, PodCliques and
Queues as wire documents (``grove_tpu.api.serialize.export_object``), the
nodes with their schedulable state, the binding map's order and the
reservation history, the virtual clock and the scheduler's sticky pads —
is loaded into a fresh port store and cluster through the port's own
``decode_object``, and the port's ``GangScheduler`` runs the round on the
CPU. Then the JAX round runs, and the two must agree: pods bound (and the
binding map), pods evicted, every PodGang's and Queue's status (the
placement score at rtol 1e-6: XLA fuses a multiply-add the port does not),
and every event's object, type and reason (messages compared the same
way). No JAX object or store reaches the port: only documents and plain
values cross.
"""

import re

import numpy as np
import pytest

from grove_tpu.api.load import load_podcliqueset_file
from grove_tpu.api.serialize import export_object
from grove_tpu.api.topology import ClusterTopology as JaxTopology
from grove_tpu.api.types import TopologyConstraint
from grove_tpu.api.wire import decode_object as jax_decode
from grove_tpu.observability.events import EVENTS as JAX_EVENTS
from grove_tpu.runtime.clock import VirtualClock as JaxClock
from grove_tpu.runtime.store import Store as JaxStore
from grove_tpu.sim.cluster import SimCluster as JaxCluster, make_nodes as jax_make_nodes
from grove_tpu.sim.harness import SimHarness
from grove_tpu.solver.scheduler import GangScheduler as JaxScheduler
from grove_tpu_torch.api.meta import ObjectMeta
from grove_tpu_torch.api.topology import ClusterTopology, ClusterTopologySpec, TopologyLevel
from grove_tpu_torch.api.wire import decode_object
from grove_tpu_torch.models.scenarios import EventCapture, round_summary, scheduler_world
from grove_tpu_torch.observability.events import EVENTS
from grove_tpu_torch.runtime.clock import VirtualClock
from grove_tpu_torch.runtime.store import Store
from grove_tpu_torch.sim.cluster import Node, SimCluster, make_nodes
from grove_tpu_torch.solver.scheduler import GangScheduler

KINDS = ("Queue", "PodGang", "PodClique", "Pod")
_NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?")


def same_text(a: str, b: str) -> bool:
    """Equal, except that decimal numbers in them (placement scores) are
    held at rtol 1e-6."""
    if a == b:
        return True
    if _NUMBER.sub("#", a) != _NUMBER.sub("#", b):
        return False
    return all(
        np.isclose(float(x), float(y), rtol=1e-6, atol=1e-9)
        for x, y in zip(_NUMBER.findall(a), _NUMBER.findall(b))
    )


def _conditions(conds):
    return [(c.type, c.status, c.reason, c.message, c.last_transition_time) for c in conds]


def assert_same_conditions(tag, got, want):
    got, want = _conditions(got), _conditions(want)
    assert len(got) == len(want), (tag, got, want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3] and g[4] == w[4] and same_text(g[3], w[3]), (tag, g, w)


def assert_same_events(got, want):
    assert [e[:5] for e in got] == [e[:5] for e in want]
    for g, w in zip(got, want):
        assert same_text(g[5], w[5]), (g, w)


def assert_same_world(port_store, port_cluster, jax_store, jax_cluster):
    """Bindings (in order), pods present, pod, PodGang and Queue statuses."""
    assert list(port_cluster.bindings.items()) == list(jax_cluster.bindings.items())
    for kind in KINDS:
        want = {(o.metadata.namespace, o.metadata.name): o for o in jax_store.scan(kind)}
        got = {(o.metadata.namespace, o.metadata.name): o for o in port_store.scan(kind)}
        assert set(got) == set(want), kind
        for key, w in want.items():
            g = got[key]
            assert_same_conditions((kind, key), g.status.conditions, w.status.conditions)
            if kind == "Pod":
                assert g.status.node_name == w.status.node_name, key
            elif kind == "PodGang":
                assert g.status.phase == w.status.phase, key
                if w.status.placement_score is None:
                    assert g.status.placement_score is None, key
                else:
                    assert np.isclose(g.status.placement_score, w.status.placement_score,
                                      rtol=1e-6, atol=0), key
            elif kind == "Queue":
                gs, ws = g.status, w.status
                assert (gs.usage, gs.dominant_share, gs.admitted_gangs, gs.pending_gangs) == (
                    ws.usage, ws.dominant_share, ws.admitted_gangs, ws.pending_gangs), key


def port_world_from(jax_sched):
    """A port store, cluster and scheduler holding the JAX scheduler's world
    as documents and plain values."""
    jax_store, jax_cluster = jax_sched.store, jax_sched.cluster
    store = Store(VirtualClock(jax_store.clock.now()))
    nodes = [
        Node(name=n.name, capacity=dict(n.capacity), labels=dict(n.labels),
             cordoned=n.cordoned, state=n.state)
        for n in jax_cluster.nodes
    ]
    cluster = SimCluster(store, nodes)
    topology = ClusterTopology(
        metadata=ObjectMeta(name=jax_sched.topology.metadata.name, namespace=""),
        spec=ClusterTopologySpec(
            levels=[TopologyLevel(lv.domain, lv.key) for lv in jax_sched.topology.spec.levels]
        ),
    )
    sched = GangScheduler(store, cluster, topology, dict(jax_sched.priority_map),
                          jax_sched.chunk_size, jax_sched.max_waves, device="cpu")
    for kind in KINDS:
        for obj in jax_store.scan(kind):
            store.create(decode_object(export_object(obj)), consume=True)
    cluster.last_node.update(jax_cluster.last_node)
    cluster.rebuild_bindings()
    live = {k: v for k, v in jax_cluster.bindings.items()
            if (p := jax_store.get("Pod", k[0], k[1], readonly=True)) is not None
            and p.metadata.deletion_timestamp is None
            and any(c.type == "PodScheduled" and c.status == "True"
                    for c in p.status.conditions)}
    # the persisted bindings are exactly the JAX map's live ones; keep its
    # order (node_free subtracts in binding order)
    assert cluster.bindings == live
    cluster.bindings = dict(live)
    # the scheduler's sticky pads, as a port scheduler that lived through
    # the same rounds would hold them
    sched._pad_groups._width = jax_sched._pad_groups._width
    for pad in ("_pad_q", "_pad_g", "_pad_r"):
        setattr(sched.quota, pad, getattr(jax_sched.quota, pad))
    return store, cluster, sched


class Bridge:
    """Wraps a JAX scheduler's schedule_pending: each round runs first on a
    port copy of the world, then on the JAX side, and both must agree."""

    def __init__(self, jax_sched, monitor=None, broker=None):
        self.jax_sched = jax_sched
        self.inner = jax_sched.schedule_pending
        self.monitor, self.broker = monitor, broker
        self.rounds = []
        jax_sched.schedule_pending = self.round

    def round(self, namespace=None):
        if self.monitor is not None:
            assert not self.monitor._held, "the node-health monitor held a gang"
        if self.broker is not None:
            assert not self.broker.active(), "the disruption broker has budgets"
        store, cluster, sched = port_world_from(self.jax_sched)
        EVENTS.clock = store.clock
        with EventCapture(EVENTS) as port_events:
            port_bound = sched.schedule_pending(namespace)
        with EventCapture(JAX_EVENTS) as jax_events:
            jax_bound = self.inner(namespace)
        assert port_bound == jax_bound
        assert_same_events(port_events.events, jax_events.events)
        assert_same_world(store, cluster, self.jax_sched.store, self.jax_sched.cluster)
        assert sched._pad_groups._width == self.jax_sched._pad_groups._width
        self.rounds.append([e[4] for e in jax_events.events])
        return jax_bound

    def reasons(self):
        return {r for rnd in self.rounds for r in rnd}


@pytest.fixture
def harness_factory(monkeypatch):
    monkeypatch.setenv("GROVE_TPU_NO_DELTA", "1")
    JAX_EVENTS.reset()
    EVENTS.reset()
    made = []

    def make(**kw):
        h = SimHarness(**kw)
        assert h.scheduler.delta is None
        made.append(h)
        return h

    yield make
    JAX_EVENTS.reset()
    JAX_EVENTS.clock = None
    EVENTS.reset()
    EVENTS.clock = None


def bridged(h):
    return Bridge(h.scheduler, monitor=h.node_monitor, broker=h.disruption)


def simple1():
    import pathlib

    return load_podcliqueset_file(
        str(pathlib.Path(__file__).resolve().parents[1] / "samples" / "simple1.yaml")
    )


def test_simple1_rounds_match(harness_factory):
    h = harness_factory(num_nodes=16)
    bridge = bridged(h)
    h.apply(simple1())
    h.converge()
    assert {"GangAdmitted", "PodBound"} <= bridge.reasons()
    assert len(bridge.rounds) >= 3


@pytest.mark.parametrize("constraint", ["pack", "spread"])
def test_topology_constraint_rounds_match(harness_factory, constraint):
    """tests/test_gang_scheduling.py's pack and spread worlds."""
    h = harness_factory(num_nodes=16)
    bridge = bridged(h)
    pcs = simple1()
    pcs.spec.template.topology_constraint = (
        TopologyConstraint(pack_domain="ici-block") if constraint == "pack"
        else TopologyConstraint(spread_domain="ici-block", spread_min_domains=4)
    )
    h.apply(pcs)
    h.converge()
    assert "GangAdmitted" in bridge.reasons()


def test_recovery_pin_rounds_match(harness_factory):
    """tests/test_gang_scheduling.py::test_replacement_pod_rejoins_surviving_
    domain: a killed pod of an ici-block-packed clique comes back through a
    recovery solve pinned to its survivors' block."""
    h = harness_factory(num_nodes=8)
    pcs = simple1()
    pcs.spec.template.cliques[0].spec.min_available = 1
    pcs.spec.template.cliques[0].topology_constraint = TopologyConstraint(pack_domain="ici-block")
    h.apply(pcs)
    h.converge()
    bridge = bridged(h)
    h.cluster.last_node.clear()
    h.store.delete("Pod", "default", "simple1-0-frontend-0")
    h.converge()
    assert "PodBound" in bridge.reasons()


def test_preemption_rounds_match(harness_factory):
    """tests/test_preemption.py::test_high_priority_preempts_low."""
    from grove_tpu.config.operator import load_operator_configuration
    from tests.test_preemption import small_pcs

    cfg = load_operator_configuration("solver: {priorityClasses: {critical: 100, batch: 1}}")
    h = harness_factory(num_nodes=2, config=cfg)
    for n in h.cluster.nodes:
        n.capacity = {"cpu": 8.0}
    bridge = bridged(h)
    h.apply(small_pcs("low", cpu=4, priority_class="batch"))
    h.converge()
    h.apply(small_pcs("high", cpu=4, priority_class="critical"))
    h.converge()
    assert "Preempted" in bridge.reasons()


def test_reclaim_rounds_match(harness_factory):
    """The reclaim world of grove_tpu/sim/multitenant.py build_contended_
    harness: team-a fills the cluster alone, team-b and team-c arrive and
    reclaim their deserved shares."""
    from grove_tpu.sim import multitenant

    tenants = (("team-a", 3.0, 6), ("team-b", 2.0, 6), ("team-c", 1.0, 6))
    h, _ = multitenant.build_contended_harness(tenants=tenants)
    assert h.scheduler.delta is None
    bridge = bridged(h)
    h.converge(max_ticks=120)
    assert "QuotaReclaim" in bridge.reasons()


def test_ceiling_rounds_match(harness_factory):
    """tests/test_quota.py::TestCeiling's world: a queue at its ceiling
    holds gangs back with QueuePending."""
    from grove_tpu.sim.multitenant import tenant_pcs, tenant_queue

    h = harness_factory(num_nodes=4)
    bridge = bridged(h)
    h.apply_queue(tenant_queue("capped", 1.0, ceiling_cpu=1.0))
    for i in range(3):
        h.apply(tenant_pcs("capped", i, namespace="default"))
    h.converge(max_ticks=80)
    assert "QueuePending" in bridge.reasons()


# -- the card's worlds, cut to CPU size ---------------------------------------


@pytest.mark.parametrize("world,n_nodes,n_gangs", [("s", 64, 192), ("r", 48, 96)])
def test_cut_world_rounds_match(world, n_nodes, n_gangs):
    """A cut of the card's worlds (s) and (r) (``scheduler_world``), loaded
    from the same documents into both packages: every round's summary,
    PodGang and Queue statuses, bindings and events agree."""
    JAX_EVENTS.reset()
    EVENTS.reset()
    w = scheduler_world(world, n_nodes, n_gangs)
    jax_store = JaxStore(JaxClock(0.0))
    jax_cluster = JaxCluster(store=jax_store, nodes=jax_make_nodes(*w["nodes"]))
    jax_sched = JaxScheduler(jax_store, jax_cluster, JaxTopology(), w["priority_map"])
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store, make_nodes(*w["nodes"]))
    sched = GangScheduler(store, cluster, ClusterTopology(), w["priority_map"], device="cpu")
    reasons = set()
    for docs in [w["queues"]] + w["rounds"]:
        for doc in docs:
            jax_store.create(jax_decode(doc))
            store.create(decode_object(doc), consume=True)
        if docs is w["queues"]:
            continue
        with EventCapture(JAX_EVENTS) as jax_events:
            jax_sched.schedule_pending()
        with EventCapture(EVENTS) as port_events:
            sched.schedule_pending()
        assert_same_events(port_events.events, jax_events.events)
        want = round_summary(jax_store, jax_cluster, jax_events.events)
        got = round_summary(store, cluster, port_events.events)
        assert np.isclose(got.pop("score_sum"), want.pop("score_sum"), rtol=1e-6)
        assert got == want
        assert_same_world(store, cluster, jax_store, jax_cluster)
        reasons |= {e[4] for e in jax_events.events}
    if world == "r":
        assert {"Preempted", "QuotaReclaim"} <= reasons
    JAX_EVENTS.reset()
    EVENTS.reset()


# -- the store, the wire codec and the device rule ------------------------------


def _gang_doc(name, labels=None):
    return {"apiVersion": "scheduler.grove.io/v1alpha1", "kind": "PodGang",
            "metadata": {"name": name, "namespace": "ns", "labels": labels or {}},
            "spec": {"podGroups": [{"name": f"{name}-c", "minReplicas": 1,
                                    "podReferences": [{"namespace": "ns", "name": f"{name}-p"}]}]}}


@pytest.mark.parametrize("case", ["conflict", "noop", "label_index", "finalizer"])
def test_store_semantics_match_jax(case):
    """resourceVersion conflicts, no-op suppression, label-selected scans
    (through the index) and finalizer-deferred deletes behave as the JAX
    store's, on the same documents."""
    from grove_tpu.runtime.errors import GroveError as JaxGroveError
    from grove_tpu_torch.runtime.errors import GroveError

    sides = []
    for store, decode, error in ((JaxStore(JaxClock(0.0)), jax_decode, JaxGroveError),
                                 (Store(VirtualClock(0.0)), decode_object, GroveError)):
        events = []
        store.subscribe_system(lambda ev, events=events: events.append((ev.type, ev.kind)))
        for i in range(4):
            store.create(decode(_gang_doc(f"g{i}", {"grove.io/podgang": f"g{i % 2}"})))
        out = []
        if case == "conflict":
            stale = store.get("PodGang", "ns", "g0")
            fresh = store.get("PodGang", "ns", "g0")
            fresh.status.phase = "Starting"
            store.update_status(fresh)
            stale.status.phase = "Running"
            with pytest.raises(error) as exc:
                store.update_status(stale)
            out.append(exc.value.code == "ERR_CONFLICT")
        elif case == "noop":
            view = store.get("PodGang", "ns", "g1", readonly=True)
            rv = view.metadata.resource_version
            store.update_status(store.get("PodGang", "ns", "g1"))
            out.append(store.get("PodGang", "ns", "g1").metadata.resource_version == rv)
        elif case == "label_index":
            out.append(sorted(g.metadata.name for g in store.scan(
                "PodGang", "ns", {"grove.io/podgang": "g1"})))
            store.delete("PodGang", "ns", "g3")
            out.append(sorted(g.metadata.name for g in store.scan(
                "PodGang", None, {"grove.io/podgang": "g1"})))
            out.append([g.metadata.name for g in store.list("PodGang")])
        else:
            g = store.get("PodGang", "ns", "g2")
            g.metadata.finalizers = ["keep"]
            store.update(g)
            store.delete("PodGang", "ns", "g2")
            kept = store.get("PodGang", "ns", "g2", readonly=True)
            out.append((kept is not None, kept.metadata.deletion_timestamp))
        sides.append((out, events))
    assert sides[0] == sides[1]


def test_wire_decode_of_exported_objects_matches():
    """Every object of a converged JAX world, exported and decoded by the
    port, keeps the fields the scheduler reads."""
    h = SimHarness(num_nodes=16)
    h.apply(simple1())
    h.converge()
    checked = 0
    for kind in KINDS:
        for obj in h.store.scan(kind):
            port = decode_object(export_object(obj))
            assert (port.kind, port.metadata.name, port.metadata.namespace,
                    port.metadata.labels) == (obj.kind, obj.metadata.name,
                                              obj.metadata.namespace, obj.metadata.labels)
            assert _conditions(port.status.conditions) == _conditions(obj.status.conditions)
            if kind == "Pod":
                assert port.spec.total_requests() == obj.spec.total_requests()
                assert port.spec.scheduling_gates == obj.spec.scheduling_gates
                assert port.status.node_name == obj.status.node_name
            elif kind == "PodGang":
                assert [(g.name, g.min_replicas, [(r.namespace, r.name) for r in g.pod_references])
                        for g in port.spec.pod_groups] == [
                    (g.name, g.min_replicas, [(r.namespace, r.name) for r in g.pod_references])
                    for g in obj.spec.pod_groups]
                assert port.status.phase == obj.status.phase
            checked += 1
    assert checked > 10
    JAX_EVENTS.reset()
    JAX_EVENTS.clock = None


def test_scheduler_without_a_device_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    store = Store(VirtualClock(0.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GangScheduler(store, SimCluster(store, make_nodes(4)))
