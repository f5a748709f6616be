"""The port's delta-solve state against the JAX package's, on the CPU.

(a) The encoder's cached path (``NodeEncoding``, ``build_problem_cached``,
``slice_encoding``) and ``problems_identical`` equal the JAX package's bit
for bit on the same numpy inputs, pinned and spread specs included.

(b) The churn world (``scheduler_world("delta")`` cut to 64 nodes and 96
gangs, 24 ticks, two seeds): a JAX scheduler and a port scheduler, each with
``enable_delta()`` and the A/B self-check on every round, take the same tick
operations. Every round's summary, events, delta counters and whole
``state_fingerprint()`` must be equal; a port scheduler with delta off takes
the same operations and must bind the same pods.

(c) One seed of (b) under ``GROVE_TPU_SANITIZE=1``: the drift audit runs
every tick on both packages and finds nothing.

(d) The mirror gate: a seeded JAX ``SimHarness`` churn
(``grove_tpu/sim/deltachurn.churn_loop``, delta on) whose store writes
between rounds are replayed, as exported documents, into one persistent port
store (node attributes and the reservation history copied too). A port
round runs before each JAX round and must equal it, as
``tests/test_torch_scheduler.py``'s ``Bridge`` checks. The JAX round's own
writes are not replayed: the port round made its own.

(e) Counterparts of ``tests/test_deltastate.py``'s ``TestDirtyMasks`` and
``TestWarmStartAndReuse`` on worlds built from documents.

No JAX object or store reaches the port: only documents and plain values
cross.
"""

import numpy as np
import pytest

from grove_tpu.api.topology import ClusterTopology as JaxTopology
from grove_tpu.api.wire import decode_object as jax_decode
from grove_tpu.observability.events import EVENTS as JAX_EVENTS
from grove_tpu.runtime.clock import VirtualClock as JaxClock
from grove_tpu.runtime.store import Store as JaxStore
from grove_tpu.sim.cluster import SimCluster as JaxCluster, make_nodes as jax_make_nodes
from grove_tpu.solver import deltastate as jax_deltastate
from grove_tpu.solver import encode as jax_encode
from grove_tpu.solver.scheduler import GangScheduler as JaxScheduler
from grove_tpu_torch.api.pod import Pod, is_schedule_gated
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.api.wire import decode_object
from grove_tpu_torch.models.scenarios import (
    STRESS_CAPACITY,
    EventCapture,
    _renamed,
    apply_tick,
    delta_counters,
    gang_world_docs,
    round_summary,
    scheduler_world,
    stress_gang_specs,
)
from grove_tpu_torch.observability.events import EVENTS
from grove_tpu_torch.runtime.clock import VirtualClock
from grove_tpu_torch.runtime.store import Store
from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
from grove_tpu_torch.solver import deltastate, encode
from grove_tpu_torch.solver.scheduler import GangScheduler
from grove_tpu_torch.analysis import sanitize

from tests.test_torch_scheduler import (
    KINDS,
    assert_same_events,
    assert_same_world,
    port_world_from,
)

NODE_ARGS = (48, dict(STRESS_CAPACITY), 4, 3)  # 48 nodes, 4 blocks of 4 hosts a slice


@pytest.fixture(autouse=True)
def _events():
    JAX_EVENTS.reset()
    EVENTS.reset()
    yield
    JAX_EVENTS.reset()
    JAX_EVENTS.clock = None
    EVENTS.reset()
    EVENTS.clock = None


# -- (a) the encoder's cached path ------------------------------------------------


def _specs():
    """Stress gangs, plus spread, soft-spread and pinned (recovery) gangs."""
    from chip_smoke import spread_recovery_specs

    specs = _renamed(stress_gang_specs(24, seed=5), "s")
    specs += spread_recovery_specs(12, seed=6, n_nodes=NODE_ARGS[0])
    assert any(s.get("gang_pinned_node") for s in specs)
    assert any(g.get("pinned_node") for s in specs for g in s["groups"])
    assert any(s.get("spread_survivor_nodes") for s in specs)
    return specs


def _free(nodes, seed=3):
    """A free-capacity dict per node: capacity less a seeded usage."""
    rng = np.random.default_rng(seed)
    return {n.name: {r: v - float(rng.integers(0, 4)) * (0.5 if r == "cpu" else 1.0)
                     for r, v in n.capacity.items()} for n in nodes}


def _assert_problems_equal(got, want):
    """Every array and name list of two problems (one per package)."""
    for field in deltastate._PROBLEM_TENSORS:
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    for field in deltastate._PROBLEM_NAMES:
        assert getattr(got, field) == getattr(want, field), field


def test_node_encoding_matches_jax():
    resource_names = ["cpu", "memory", "tpu"]
    got = encode.NodeEncoding(make_nodes(*NODE_ARGS), ClusterTopology(), resource_names)
    want = jax_encode.NodeEncoding(jax_make_nodes(*NODE_ARGS), JaxTopology(), resource_names)
    for field in ("base_capacity", "topo", "seg_starts", "seg_ends"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    for field in ("node_names", "resource_names", "level_keys", "node_index"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("pre_encoded", [False, True], ids=["encoded", "pre_encoded"])
def test_build_problem_cached_matches_jax_and_from_scratch(pre_encoded):
    """The cached path equals the JAX package's cached path and the port's
    own from-scratch ``build_problem`` on the same free capacity."""
    specs = _specs()
    nodes, jax_nodes = make_nodes(*NODE_ARGS), jax_make_nodes(*NODE_ARGS)
    free = _free(nodes)
    full = encode.build_problem(nodes, specs, ClusterTopology(), free_capacity=free,
                                pad_gangs=64, pad_groups=4)
    rn = full.resource_names
    enc = encode.NodeEncoding(nodes, ClusterTopology(), rn)
    jax_enc = jax_encode.NodeEncoding(jax_nodes, JaxTopology(), rn)
    capacity = np.array([[free[name].get(r, 0.0) for r in rn] for name in enc.node_names],
                        np.float32)
    kw = {}
    jax_kw = {}
    if pre_encoded:
        kw["pre_encoded"] = encode.encode_gangs(specs, rn, enc.level_keys, 64, 4)
        jax_kw["pre_encoded"] = jax_encode.encode_gangs(specs, rn, jax_enc.level_keys, 64, 4)
    got = encode.build_problem_cached(enc, capacity.copy(), specs, 64, 4, **kw)
    want = jax_encode.build_problem_cached(jax_enc, capacity.copy(), specs, 64, 4, **jax_kw)
    _assert_problems_equal(got, want)
    assert deltastate.problems_identical(got, full) is None
    assert got.spread_seed.shape[1] > 0 and (got.group_pin >= 0).any() and (got.gang_pin >= 0).any()


@pytest.mark.parametrize("slab,pad_to", [((0, 48), None), ((16, 40), None), ((16, 40), 32),
                                          ((4, 9), 8)])
def test_slice_encoding_matches_jax(slab, pad_to):
    rn = ["cpu", "tpu"]
    enc = encode.NodeEncoding(make_nodes(*NODE_ARGS), ClusterTopology(), rn)
    jax_enc = jax_encode.NodeEncoding(jax_make_nodes(*NODE_ARGS), JaxTopology(), rn)
    got = encode.slice_encoding(enc, *slab, pad_to=pad_to)
    want = jax_encode.slice_encoding(jax_enc, *slab, pad_to=pad_to)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[3:] == want[3:]
    assert len(got[3]) == (pad_to or slab[1] - slab[0])


@pytest.mark.parametrize("field", [None, "capacity", "spread_seed", "group_pin", "count",
                                   "gang_names", "node_names"])
def test_problems_identical_matches_jax(field):
    """The first differing field, named alike by both packages."""
    specs = _specs()
    nodes = make_nodes(*NODE_ARGS)
    a = encode.build_problem(nodes, specs, ClusterTopology(), free_capacity=_free(nodes))
    b = encode.build_problem(nodes, specs, ClusterTopology(), free_capacity=_free(nodes))
    if field is not None:
        value = getattr(b, field)
        if isinstance(value, np.ndarray):
            value = value.copy()
            value.flat[-1] = value.flat[-1] + 1
        else:
            value = list(value)
            value[-1] = "changed"
        setattr(b, field, value)
    assert deltastate.problems_identical(a, b) == field
    assert jax_deltastate.problems_identical(a, b) == field


@pytest.mark.parametrize("value", ["", "0", "false", "1", "true", "yes"])
def test_sanitize_switch_matches_jax(monkeypatch, value):
    from grove_tpu.analysis import sanitize as jax_sanitize

    monkeypatch.setenv("GROVE_TPU_SANITIZE", value)
    assert sanitize.enabled() == jax_sanitize.enabled()


@pytest.mark.parametrize("gates", [[], ["grove.io/gate"]])
def test_is_schedule_gated_matches_jax(gates):
    from grove_tpu.api.pod import Pod as JaxPod, is_schedule_gated as jax_gated

    pod, jax_pod = Pod(), JaxPod()
    pod.spec.scheduling_gates = list(gates)
    jax_pod.spec.scheduling_gates = list(gates)
    assert is_schedule_gated(pod) == jax_gated(jax_pod) == bool(gates)


# -- (b), (c) the churn world ---------------------------------------------------

CHURN_NODES, CHURN_GANGS = 64, 96


def run_churn(seed):
    """The churn world through a JAX and a port delta scheduler (self-check
    on) and a port scheduler without delta, held round by round. Returns
    the port delta scheduler and what the rounds exercised."""
    w = scheduler_world("delta", CHURN_NODES, CHURN_GANGS, seed=seed)
    jax_store = JaxStore(JaxClock(0.0))
    jax_cluster = JaxCluster(store=jax_store, nodes=jax_make_nodes(*w["nodes"]))
    jax_sched = JaxScheduler(jax_store, jax_cluster, JaxTopology(), w["priority_map"])
    sides = []
    for delta in (True, False):
        store = Store(VirtualClock(0.0))
        cluster = SimCluster(store, make_nodes(*w["nodes"]))
        sched = GangScheduler(store, cluster, ClusterTopology(), w["priority_map"], device="cpu")
        if delta:
            assert sched.enable_delta()
            sched.delta_selfcheck = True
        sides.append((store, cluster, sched))
    assert jax_sched.enable_delta()
    jax_sched.delta_selfcheck = True
    (store, cluster, sched), (plain_store, plain_cluster, plain) = sides
    for doc in w["queues"] + w["rounds"][0]:
        jax_store.create(jax_decode(doc))
        for s, _c, _sched in sides:
            s.create(decode_object(doc), consume=True)
    seen = {"reuse": 0, "fallback": 0, "flap_back_reused": 0, "warm": 0, "selfcheck_s": 0.0}
    before_cordon = None
    for index, tick in enumerate([None] + w["ticks"]):
        ops = tick or []
        if any(op[0] == "cordon" and op[2] for op in ops):
            before_cordon = sched.delta._enc
        if tick:
            apply_tick(jax_store, jax_cluster, tick, jax_decode)
            for s, c, _sched in sides:
                apply_tick(s, c, tick, decode_object)
        counts = delta_counters(sched.delta)
        sched.last_selfcheck_seconds = 0.0
        with EventCapture(JAX_EVENTS) as jax_events:
            jax_bound = jax_sched.schedule_pending()
        with EventCapture(EVENTS) as port_events:
            bound = sched.schedule_pending()
        with EventCapture(EVENTS) as plain_events:
            plain_bound = plain.schedule_pending()
        tag = f"seed {seed} round {index + 1}"
        assert bound == jax_bound == plain_bound, tag
        assert_same_events(port_events.events, jax_events.events)
        assert_same_events(plain_events.events, port_events.events)
        want = round_summary(jax_store, jax_cluster, jax_events.events)
        for got in (round_summary(store, cluster, port_events.events),
                    round_summary(plain_store, plain_cluster, plain_events.events)):
            assert np.isclose(got.pop("score_sum"), want["score_sum"], rtol=1e-6), tag
            assert got == {k: v for k, v in want.items() if k != "score_sum"}, tag
        assert delta_counters(sched.delta) == delta_counters(jax_sched.delta), tag
        assert sched.delta.state_fingerprint() == jax_sched.delta.state_fingerprint(), tag
        assert_same_world(store, cluster, jax_store, jax_cluster)
        assert list(plain_cluster.bindings.items()) == list(cluster.bindings.items()), tag
        assert sched._pad_groups._width == jax_sched._pad_groups._width
        now = delta_counters(sched.delta)
        seen["reuse"] += now["solve_reuses"] > counts["solve_reuses"]
        seen["fallback"] += now["full_fallbacks"] > counts["full_fallbacks"]
        seen["warm"] += now["last_reused"]
        seen["selfcheck_s"] += sched.last_selfcheck_seconds
        if any(op[0] == "cordon" and not op[2] for op in ops):
            seen["flap_back_reused"] += sched.delta._enc is before_cordon
    return sched, seen


@pytest.mark.parametrize("seed", [0, 1])
def test_churn_world_delta_rounds_match_jax(seed):
    sched, seen = run_churn(seed)
    # the world exercised every path of the delta round
    assert seen["reuse"] >= 1 and seen["fallback"] == 2 and seen["flap_back_reused"] == 1
    assert seen["warm"] > 0 and seen["selfcheck_s"] > 0
    assert sched.delta.drift_detected == 0


def test_churn_world_under_the_sanitizer(monkeypatch):
    """GROVE_TPU_SANITIZE=1: both packages audit the free matrix against a
    full recount every tick (``check_drift``) and find no drift."""
    monkeypatch.setenv("GROVE_TPU_SANITIZE", "1")
    audits = []
    wrapped = deltastate.DeltaSolveState.check_drift

    def counting(self, nodes):
        audits.append(self._ticks)
        return wrapped(self, nodes)

    monkeypatch.setattr(deltastate.DeltaSolveState, "check_drift", counting)
    sched, seen = run_churn(0)
    # every round after the first, which builds the mirror, ran the audit
    assert audits == list(range(2, 26))
    assert sched.delta.drift_detected == 0 and seen["fallback"] == 2


# -- (d) the mirror gate ---------------------------------------------------------


class Mirror:
    """Replays a JAX harness store's writes into one persistent port store
    and runs the port's delta round before each JAX round; both must agree
    as ``Bridge`` (tests/test_torch_scheduler.py) checks."""

    def __init__(self, h):
        from grove_tpu.api.serialize import export_object

        self.h, self.export = h, export_object
        self.pending = []
        self.recording = True
        h.store.subscribe_system(self._record)
        jax_sched = h.scheduler
        self.store, self.cluster, self.sched = port_world_from(jax_sched)
        assert self.sched.enable_delta()
        self.sched.delta_selfcheck = True
        self.inner = jax_sched.schedule_pending
        jax_sched.schedule_pending = self.round
        self.rounds = []

    def _record(self, ev):
        if self.recording and ev.kind in KINDS:
            self.pending.append((ev.type, ev.kind, self.export(ev.obj)))

    def _replay(self):
        for kind_of_event, kind, doc in self.pending:
            meta = doc["metadata"]
            ns, name = meta.get("namespace", "default"), meta["name"]
            current = self.store.get(kind, ns, name, readonly=True)
            if kind_of_event == "Added":
                self.store.create(decode_object(doc), consume=True)
            elif kind_of_event == "Modified":
                obj = decode_object(doc)
                obj.metadata.resource_version = 0  # the port store keeps its own
                self.store.update(obj)
            elif current is not None:
                self.store.delete(kind, ns, name)
        self.pending.clear()

    def round(self, namespace=None):
        h = self.h
        assert not h.node_monitor._held, "the node-health monitor held a gang"
        assert not h.disruption.active(), "the disruption broker has budgets"
        self._replay()
        nodes = {n.name: n for n in self.cluster.nodes}
        for n in h.cluster.nodes:
            port = nodes[n.name]
            port.capacity, port.labels = dict(n.capacity), dict(n.labels)
            port.cordoned, port.state = n.cordoned, n.state
        self.cluster.last_node.update(h.cluster.last_node)
        self.store.clock._now = h.store.clock.now()
        EVENTS.clock = self.store.clock
        self.sched.delta_selfcheck = True
        with EventCapture(EVENTS) as port_events:
            port_bound = self.sched.schedule_pending(namespace)
        self.recording = False
        try:
            with EventCapture(JAX_EVENTS) as jax_events:
                jax_bound = self.inner(namespace)
        finally:
            self.recording = True
        assert port_bound == jax_bound
        assert_same_events(port_events.events, jax_events.events)
        assert_same_world(self.store, self.cluster, h.store, h.cluster)
        assert self.sched._pad_groups._width == h.scheduler._pad_groups._width
        self.rounds.append([e[4] for e in jax_events.events])
        return jax_bound


def test_mirror_gate_holds_one_port_store_through_a_jax_churn():
    from grove_tpu.api.meta import deep_copy
    from grove_tpu.models import load_sample
    from grove_tpu.sim import deltachurn
    from grove_tpu.sim.harness import SimHarness

    h = SimHarness(num_nodes=12)
    assert h.scheduler.delta is not None
    mirror = Mirror(h)
    for i in range(6):
        pcs = deep_copy(deltachurn._CHURN_BASE)
        pcs.metadata.name = f"seed-{i}"
        h.apply(pcs)
    for i in range(2):
        # a standing backlog (unplaceable at 12 nodes): real solves every tick
        pcs = deep_copy(load_sample("multinode_disaggregated"))
        pcs.metadata.name = f"backlog-{i}"
        h.apply(pcs)
    h.converge(max_ticks=30)
    report = deltachurn.churn_loop(h, ticks=24, seed=8, selfcheck_every=1, flap_every=8)
    d = mirror.sched.delta
    assert report["ops"]["arrivals"] and report["ops"]["pod_fails"] and report["ops"]["flaps"]
    assert len(mirror.rounds) >= 24 + 1
    assert {"GangAdmitted", "PodBound", "GangDeferred"} <= {r for rnd in mirror.rounds
                                                            for r in rnd}
    assert d.full_fallbacks >= 2 and d.warm_start_hits > 0 and d.drift_detected == 0
    assert list(mirror.cluster.bindings.items()) == list(h.cluster.bindings.items())


# -- (e) the dirty masks, the warm start and the solve reuse ---------------------

NS = "default"


def _mixed_world(num_nodes=6, ok_sets=3, big_sets=2, selfcheck=True):
    """A port world from documents with admittable gangs and a standing
    pending backlog (pods of 16 chips on nodes of 8), so solves keep running
    with real pending work every tick."""
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store, make_nodes(num_nodes, dict(STRESS_CAPACITY), 2, 2))
    sched = GangScheduler(store, cluster, ClusterTopology(), device="cpu")
    assert sched.enable_delta()
    sched.delta_selfcheck = selfcheck
    specs = _renamed(stress_gang_specs(ok_sets, seed=3), "ok")
    specs += [{"name": f"big{i}", "required_key": None, "preferred_key": None, "priority": 0,
               "groups": [{"name": f"big{i}-0", "demand": {"tpu": 16.0, "cpu": 2.0},
                           "count": 2, "min_count": 2}]} for i in range(big_sets)]
    for doc in gang_world_docs(specs):
        store.create(decode_object(doc), consume=True)
    return store, cluster, sched


def _converge(sched, rounds=4):
    for _ in range(rounds):
        sched.schedule_pending()


def _schedulable(cluster):
    return [n for n in cluster.nodes if n.schedulable]


class TestDirtyMasks:
    def test_status_only_gang_write_keeps_warm_start(self):
        store, cluster, sched = _mixed_world()
        _converge(sched)
        d = sched.delta
        sched.schedule_pending()
        sched.schedule_pending()
        before = d.warm_start_hits
        # an idle tick reruns the phase and health upkeep: cached specs
        # keep serving
        sched.schedule_pending()
        assert d.warm_start_hits > before

    def test_pod_bind_dirties_only_its_node_row(self):
        store, cluster, sched = _mixed_world(num_nodes=8, ok_sets=2, big_sets=0)
        _converge(sched)
        d = sched.delta
        assert not d._dirty_nodes
        (ns, name), node = next(iter(cluster.bindings.items()))
        store.delete("Pod", ns, name)
        assert d._dirty_nodes == {node}

    def test_free_matrix_matches_node_free_all_exactly(self):
        store, cluster, sched = _mixed_world()
        _converge(sched)
        d = sched.delta
        nodes = _schedulable(cluster)
        assert d.check_drift(nodes) is False, "incremental rows drifted"
        oracle = cluster.node_free_all(nodes)
        dicts = d.free_dicts(nodes)
        for node in nodes:
            for r, v in oracle[node.name].items():
                assert dicts[node.name].get(r, 0.0) == float(np.float32(v))

    def test_topology_change_falls_back_and_clears_specs(self):
        store, cluster, sched = _mixed_world()
        _converge(sched)
        d = sched.delta
        assert d._specs
        before = d.full_fallbacks
        cluster.nodes[0].cordoned = True
        sched.schedule_pending()
        assert d.full_fallbacks == before + 1
        assert d._enc is None or len(d._enc.node_names) == len(_schedulable(cluster))

    def test_flap_back_reuses_the_retired_encoding(self):
        store, cluster, sched = _mixed_world()
        _converge(sched)
        d = sched.delta
        sched.schedule_pending()  # standing backlog: the encode runs
        enc_before = d._enc
        assert enc_before is not None
        cluster.nodes[0].cordoned = True
        sched.schedule_pending()  # fallback 1: a fresh N-1 encoding
        assert d._enc is not enc_before
        cluster.nodes[0].cordoned = False
        before = d.full_fallbacks
        sched.schedule_pending()  # fallback 2: the flap back, a cache hit
        assert d.full_fallbacks == before + 1
        assert d._enc is enc_before
        assert len(d._enc_cache) >= 2

    def test_rebuild_bindings_epoch_invalidates_mirror(self):
        store, cluster, sched = _mixed_world()
        _converge(sched)
        d = sched.delta
        assert d._mirror_built
        cluster.rebuild_bindings()  # a rewrite outside the watch
        before = d.full_fallbacks
        sched.schedule_pending()
        assert d.full_fallbacks == before + 1
        sched.schedule_pending()
        assert d._mirror_built

    def test_manual_invalidate_registration_api(self):
        store, cluster, sched = _mixed_world()
        _converge(sched)
        d = sched.delta
        d.mark_node_dirty("node-0")
        assert "node-0" in d._dirty_nodes
        d.mark_gang_dirty(NS, "some-gang")
        assert (NS, "some-gang") in d._dirty_gangs
        before = d.full_fallbacks
        d.invalidate()
        assert d.full_fallbacks == before + 1
        assert not d._specs and d._enc is None
        # the next tick re-derives everything and the A/B still holds
        sched.schedule_pending()

    def test_drift_recovery_costs_exactly_one_fallback(self):
        store, cluster, sched = _mixed_world()
        _converge(sched)
        d = sched.delta
        sched.schedule_pending()  # the backlog keeps encodes running
        # corrupt one kept row, then put the audit on this tick
        d._free[0, 0] += 1.0
        d._ticks = d.drift_check_every - 1
        before_fb, before_drift = d.full_fallbacks, d.drift_detected
        sched.schedule_pending()
        assert d.drift_detected == before_drift + 1
        assert d.full_fallbacks == before_fb + 1
        assert d._node_sig is not None
        sched.schedule_pending()  # unchanged topology: no second fallback
        assert d.full_fallbacks == before_fb + 1
        assert (None, tuple(d._enc.resource_names)) not in d._enc_cache
        assert d.check_drift(_schedulable(cluster)) is False


class TestWarmStartAndReuse:
    def test_identical_ticks_reuse_the_whole_solve(self):
        store, cluster, sched = _mixed_world()
        _converge(sched)
        d = sched.delta
        sched.schedule_pending()  # settle the status writes
        sched.schedule_pending()
        before = d.solve_reuses
        sched.schedule_pending()
        sched.schedule_pending()
        assert d.solve_reuses >= before + 2, "an unchanged backlog must skip the solve"

    def test_pod_delta_breaks_the_reuse_fingerprint(self):
        store, cluster, sched = _mixed_world()
        _converge(sched)
        d = sched.delta
        sched.schedule_pending()
        sched.schedule_pending()
        reuses = d.solve_reuses
        # a pod eviction changes a node row and its gang
        (ns, name), _node = next(iter(cluster.bindings.items()))
        store.delete("Pod", ns, name)
        sched.schedule_pending()
        assert d.solve_reuses == reuses, "a changed input must solve again"

    def test_spec_cache_misses_on_pending_set_change(self):
        store, cluster, sched = _mixed_world()
        _converge(sched)
        d = sched.delta
        sched.schedule_pending()
        key = next(k for k in d._specs if k not in d._dirty_gangs)
        entry = d._specs[key]
        pendlike = [type("P", (), {"metadata": type("M", (), {"name": n})()})()
                    for n in entry["names"]]
        assert d.cached_spec(key[0], key[1], pendlike) is not None
        assert d.cached_spec(key[0], key[1], pendlike[:-1]) is None

    def test_has_clean_spec_and_encoding_view_are_pure_reads(self):
        """The read-only peeks: ``has_clean_spec`` answers what
        ``cached_spec`` could serve without counting a hit, and
        ``encoding_view`` hands out the live encoding and free matrix
        without folding anything."""
        store, cluster, sched = _mixed_world()
        _converge(sched)
        d = sched.delta
        sched.schedule_pending()
        before = d.state_fingerprint(), d.warm_start_hits, d.last_reused
        clean = [k for k in d._specs if d.has_clean_spec(*k)]
        assert clean and all(k not in d._dirty_gangs for k in clean)
        d.mark_gang_dirty(*clean[0])
        assert clean[0] in d._dirty_gangs and not d.has_clean_spec(*clean[0])
        d._dirty_gangs.discard(clean[0])
        enc, free = d.encoding_view()
        assert enc is d._enc and free is d._free
        assert (d.state_fingerprint(), d.warm_start_hits, d.last_reused) == before


def test_sole_pod_of_a_clique_comes_back_unpinned_as_in_jax():
    """ROADMAP C.3, a reference-side fault the port keeps: the gang-level
    recovery pin looks for survivors among the pending cliques only, so a
    replacement whose clique has no survivor is solved unpinned and can
    leave the gang's required slice. Two slices of two nodes; gang ``g``
    (cliques a and b, one pod of 8 chips each, packed in a slice) fills
    one slice and ``k`` takes a node of the other. a's pod is replaced
    while its node shrinks to 4 chips: both packages bind the replacement
    to the other slice, the same way."""
    from grove_tpu.api.wire import decode_object as jax_decode_object

    nodes = (4, {"cpu": 128.0, "tpu": 8.0}, 1, 2)
    specs = [{"name": "g", "required_key": "cloud.google.com/gke-tpu-slice",
              "preferred_key": None, "priority": 0,
              "groups": [{"name": n, "demand": {"tpu": 8.0, "cpu": 1.0}, "count": 1,
                          "min_count": 1} for n in ("a", "b")]},
             {"name": "k", "required_key": None, "preferred_key": None, "priority": 0,
              "groups": [{"name": "k", "demand": {"tpu": 8.0, "cpu": 1.0}, "count": 1,
                          "min_count": 1}]}]
    docs = gang_world_docs(specs)
    jax_store = JaxStore(JaxClock(0.0))
    jax_cluster = JaxCluster(store=jax_store, nodes=jax_make_nodes(*nodes))
    jax_sched = JaxScheduler(jax_store, jax_cluster, JaxTopology())
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store, make_nodes(*nodes))
    sched = GangScheduler(store, cluster, ClusterTopology(), device="cpu")
    for s in (jax_sched, sched):
        assert s.enable_delta()
        s.delta_selfcheck = True
    for doc in docs:
        jax_store.create(jax_decode_object(doc))
        store.create(decode_object(doc), consume=True)
    jax_sched.schedule_pending()
    sched.schedule_pending()
    assert list(cluster.bindings.items()) == list(jax_cluster.bindings.items())
    pod = next(d for d in docs if d["kind"] == "Pod" and d["metadata"]["name"].startswith("g-0-a"))
    name = pod["metadata"]["name"]
    old_node = cluster.bindings[("default", name)]
    tick = [("delete", "Pod", "default", name), ("create", pod)]
    for st, cl, decode in ((jax_store, jax_cluster, jax_decode_object),
                           (store, cluster, decode_object)):
        apply_tick(st, cl, tick, decode)
        next(n for n in cl.nodes if n.name == old_node).capacity["tpu"] = 4.0
    with EventCapture(JAX_EVENTS) as jax_events:
        jax_sched.schedule_pending()
    with EventCapture(EVENTS) as port_events:
        sched.schedule_pending()
    assert_same_events(port_events.events, jax_events.events)
    assert list(cluster.bindings.items()) == list(jax_cluster.bindings.items())
    assert delta_counters(sched.delta) == delta_counters(jax_sched.delta)
    slices = {n.name: n.labels["cloud.google.com/gke-tpu-slice"] for n in cluster.nodes}
    gang_slices = {slices[node] for (ns, pod_name), node in cluster.bindings.items()
                   if pod_name.startswith("g-0-")}
    assert len(gang_slices) == 2  # the reference's placement: the pack is broken
