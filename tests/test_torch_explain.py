"""The port's admission explain engine against the JAX package's, on the CPU.

The contended explain scenario (``grove_tpu/sim/multitenant.build_explain_
scenario``: a fragmentation-blocked gang, a quota-capped gang and a gang
that fits, on a fragmented two-block cluster) is bridged into a port store
through wire documents (``port_world_from``), and both engines answer the
same questions: the verdicts and funnels, a scheduled gang's short verdict,
an unknown gang's None, ``capacity()``, what-if trials (a drain that flips
the fragmented gang, a queue rewrite, added and removed nodes) and the
malformed requests, every document equal less its timing fields. Then the
read-only pin with delta on, an all-cordoned cluster, and the frontier's
partition stage and the pending journeys' verdicts on a cut of (φ).
"""

import pytest

from grove_tpu.api.topology import ClusterTopology as JaxTopology
from grove_tpu.api.wire import decode_object as jax_decode
from grove_tpu.observability.events import EVENTS as JAX_EVENTS
from grove_tpu.observability.explain import ExplainEngine as JaxExplainEngine
from grove_tpu.observability.journey import JOURNEYS as JAX_JOURNEYS
from grove_tpu.runtime.clock import VirtualClock as JaxClock
from grove_tpu.runtime.store import Store as JaxStore
from grove_tpu.sim.cluster import SimCluster as JaxCluster, make_nodes as jax_make_nodes
from grove_tpu.sim.multitenant import _explain_pcs, build_explain_scenario
from grove_tpu.solver.scheduler import GangScheduler as JaxScheduler
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.api.wire import decode_object
from grove_tpu_torch.models.scenarios import scheduler_world, strip_timing
from grove_tpu_torch.observability.events import DETAIL_NO_NODES, EVENTS
from grove_tpu_torch.observability.explain import FUNNEL_STAGES, ExplainEngine
from grove_tpu_torch.observability.journey import JOURNEYS
from grove_tpu_torch.runtime.clock import VirtualClock
from grove_tpu_torch.runtime.store import Store
from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
from grove_tpu_torch.solver.scheduler import GangScheduler
from tests.test_torch_scheduler import port_world_from


def bridge_explain(harness):
    """A port scheduler (delta on, as the JAX harness's) over the JAX
    harness's world, its explain engine, and the store's resourceVersion
    carried over (a port store that lived through the same commits)."""
    store, cluster, sched = port_world_from(harness.scheduler)
    assert sched.enable_delta() and harness.scheduler.delta is not None
    store.rv = harness.store.resource_version
    return ExplainEngine(sched)


@pytest.fixture(scope="module")
def scenario():
    """The scenario (one build for the module) before any confirming
    round, and the port engine over its bridged world."""
    harness, refs = build_explain_scenario()
    yield harness, refs, bridge_explain(harness)
    JAX_EVENTS.reset()
    JAX_EVENTS.clock = None


def test_scenario_verdicts_match_jax(scenario):
    """frag (topology), capped (quota ceiling), fits; the funnel in stage
    order; a scheduled filler's short verdict; an unknown gang's None."""
    harness, refs, engine = scenario
    for key in ("frag", "capped", "fits"):
        want = harness.explain.explain("default", refs[key])
        got = engine.explain("default", refs[key])
        assert strip_timing(got) == strip_timing(want), key
        assert got["evaluated_in_ms"] >= 0.0
    frag = engine.explain("default", refs["frag"])
    assert (frag["binding_constraint"], frag["fits_now"]) == ("topology", False)
    assert [f["stage"] for f in frag["funnel"]] == list(FUNNEL_STAGES)
    assert frag["blocked_on"] == [f for f in frag["funnel"] if not f["ok"]]
    assert engine.explain("default", refs["capped"])["detail"] == "quota-ceiling"
    assert engine.explain("default", refs["fits"])["fits_now"]
    filler = next(g.metadata.name for g in harness.store.list("PodGang")
                  if g.metadata.name.startswith("fill-"))
    doc = engine.explain("default", filler)
    assert strip_timing(doc) == strip_timing(harness.explain.explain("default", filler))
    assert doc["state"] == "scheduled" and doc["funnel"] == []
    assert engine.explain("default", "no-such-gang") is None
    assert harness.explain.explain("default", "no-such-gang") is None
    assert engine.last_verdict("default", refs["frag"])["detail"] == "topology-fragmentation"
    assert engine.explains_total >= 6


def test_capacity_matches_jax(scenario):
    harness, _refs, engine = scenario
    got = engine.capacity()
    assert got == harness.explain.capacity()
    block = {lvl["key"]: lvl for lvl in got["levels"]}["cloud.google.com/gke-tpu-ici-block"]
    assert block["fragmentation"]["cpu"] == pytest.approx(0.5)


def test_whatif_matches_jax(scenario):
    """A drain of the bridge gang's node flips frag to fits-now, as in JAX;
    a queue rewrite, added and removed nodes give JAX's documents too."""
    harness, refs, engine = scenario
    target = {"namespace": "default", "name": refs["frag"]}
    bodies = [
        {"gang": target, "actions": [{"action": "drain-node", "node": refs["bridge_node"]}]},
        {"gang": {"namespace": "default", "name": refs["capped"]},
         "actions": [{"action": "set-queue", "queue": "team-b", "ceiling": {"cpu": 100.0}}]},
        {"gang": target, "actions": [
            {"action": "remove-node", "node": refs["bridge_node"]},
            {"action": "add-nodes", "count": 2, "like": refs["bridge_node"]},
            {"action": "set_queue", "queue": "team-new", "deserved": {"cpu": 1.0}},
        ]},
    ]
    for body in bodies:
        want = harness.explain.whatif(body)
        got = engine.whatif(body)
        assert strip_timing(got) == strip_timing(want), body
    drained = engine.whatif(bodies[0])
    assert drained["flipped"] and drained["after"]["fits_now"] and drained["after"]["hypothetical"]
    assert engine.whatifs_total == 4


MALFORMED = {
    "no_gang_name": {"actions": [{"action": "drain-node"}]},
    "no_actions": {"gang": {"namespace": "default", "name": "FRAG"}, "actions": []},
    "unknown_action": {"gang": {"namespace": "default", "name": "FRAG"},
                       "actions": [{"action": "summon-nodes"}]},
    "unknown_node": {"gang": {"namespace": "default", "name": "FRAG"},
                     "actions": [{"action": "drain-node", "node": "nope"}]},
    "unknown_gang": {"gang": {"namespace": "default", "name": "nope"},
                     "actions": [{"action": "drain-node", "node": "node-0"}]},
    "add_without_like": {"gang": {"namespace": "default", "name": "FRAG"},
                         "actions": [{"action": "add-nodes", "count": 1}]},
    "set_queue_without_queue": {"gang": {"namespace": "default", "name": "FRAG"},
                                "actions": [{"action": "set-queue"}]},
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_whatif_malformed_raises_as_jax(scenario, case):
    harness, refs, engine = scenario
    body = MALFORMED[case]
    if body.get("gang", {}).get("name") == "FRAG":
        body = dict(body, gang={"namespace": "default", "name": refs["frag"]})
    with pytest.raises(ValueError) as want:
        harness.explain.whatif(body)
    with pytest.raises(ValueError) as got:
        engine.whatif(body)
    assert str(got.value) == str(want.value)


def test_read_only_pin_with_delta(scenario):
    """After a port round (the delta state populated), an explain, capacity
    and what-if burst leaves the store's resourceVersion vector and the
    delta state's fingerprint as they were."""
    harness, refs, _engine = scenario
    engine = bridge_explain(harness)
    sched = engine.scheduler
    sched.schedule_pending()
    rv0 = sched.store.resource_version_vector()
    fp0 = sched.delta.state_fingerprint()
    pads = (sched._pad_groups._width, sched.quota.last_rows)
    for _ in range(2):
        for key in ("frag", "fits", "capped"):
            engine.explain("default", refs[key])
        engine.capacity()
        engine.whatif({"gang": {"namespace": "default", "name": refs["frag"]}, "actions": [
            {"action": "drain-node", "node": refs["bridge_node"]},
            {"action": "add-nodes", "count": 2, "like": refs["bridge_node"]},
            {"action": "set-queue", "queue": "team-a", "deserved": {"cpu": 16.0}},
        ]})
    assert sched.store.resource_version_vector() == rv0
    assert sched.delta.state_fingerprint() == fp0
    assert (sched._pad_groups._width, sched.quota.last_rows) == pads


def test_all_nodes_cordoned_binds_node_health():
    """With no schedulable node the binding constraint is node-health,
    no-schedulable-nodes, in both packages."""
    from grove_tpu.sim.harness import SimHarness

    harness = SimHarness(num_nodes=4)
    harness.apply(_explain_pcs("stuck", "default", 1.0))
    for _ in range(6):
        harness.engine.drain()
        harness.clock.advance(1.0)
    for node in harness.cluster.nodes:
        node.cordoned = True
    engine = bridge_explain(harness)
    gang = next(g.metadata.name for g in harness.store.list("PodGang")
                if g.metadata.name.startswith("stuck"))
    doc = engine.explain("default", gang)
    assert strip_timing(doc) == strip_timing(harness.explain.explain("default", gang))
    assert (doc["binding_constraint"], doc["detail"]) == ("node-health", DETAIL_NO_NODES)
    assert [(f["stage"], f["ok"]) for f in doc["funnel"][:2]] == [
        ("cluster", True), ("node-health", False)]


def test_frontier_partition_stage_matches_jax():
    """A cut of (φ) (two slices of 64 nodes, 272 gangs: four stay
    pending, all in tenant-0) after round 1 with delta and the frontier
    on: each pending gang's explain names its frontier partition, as the
    JAX engine's does."""
    JAX_EVENTS.reset()
    EVENTS.reset()
    w = scheduler_world("frontier", 128, 272, 0)
    jax_store = JaxStore(JaxClock(0.0))
    jax_cluster = JaxCluster(store=jax_store, nodes=jax_make_nodes(*w["nodes"]))
    jax_sched = JaxScheduler(jax_store, jax_cluster, JaxTopology(), w["priority_map"])
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store, make_nodes(*w["nodes"]))
    sched = GangScheduler(store, cluster, ClusterTopology(), w["priority_map"], device="cpu")
    for s, st, decode in ((jax_sched, jax_store, jax_decode), (sched, store, decode_object)):
        assert s.enable_frontier()
        for doc in w["queues"] + w["rounds"][0]:
            st.create(decode(doc))
        s.schedule_pending()
    jax_engine, engine = JaxExplainEngine(jax_sched), ExplainEngine(sched)
    pending = [g.metadata.name for g in store.scan("PodGang")
               if not any(c.type == "Scheduled" and c.status == "True" for c in g.status.conditions)]
    parts = set()
    for name in sorted(pending):
        got = engine.explain("tenant-0", name)
        assert strip_timing(got) == strip_timing(jax_engine.explain("tenant-0", name)), name
        parts.add(got.get("partition"))
    assert len(pending) == 4 and parts == {0, 1}, (pending, parts)
    # the pending journeys, annotated with each engine's last verdict
    for tracker in (JOURNEYS, JAX_JOURNEYS):
        tracker.reset()
        for name in pending:
            tracker.note_seen("tenant-0", name)
    rows = [(r["name"], r["stage"], r["last_verdict"]) for r in engine.pending_journeys()]
    assert sorted(rows) == sorted(
        (r["name"], r["stage"], r["last_verdict"]) for r in jax_engine.pending_journeys())
    assert len(rows) == 4 and all(v["state"] == "pending" for _, _, v in rows)
    JOURNEYS.reset()
    JAX_JOURNEYS.reset()
    JAX_EVENTS.reset()
    EVENTS.reset()
