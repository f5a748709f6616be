"""The port's partitioned frontier against the JAX package's, on the CPU.

(a) ``ops.packing.solve_wave_chunk_stack``: seeded stacks of B = 3 lanes
(two real lanes whose static flags differ, one inert padding lane) through
the JAX and the port function; every output equal, the PlacementScore at
rtol 1e-6 (XLA's CPU backend fuses its multiply-add; see
tests/test_torch_packing.py). Each port lane also equals the port's
``solve_wave_chunk`` on that lane alone, bit for bit, and the inert lane
leaves its capacity untouched.

(b) ``solver.kernel.solve_waves_stacked`` on buckets stacked from
partitioned problems (``FrontierState._build_lane`` and ``_stack_bucket``
over a multi-slice cluster): equal to the JAX stacked solve, and each lane
equal to the port's solo ``solve_waves`` on its subproblem.

(c) ``FrontierState.assign`` equal to the JAX package's on the cases of
tests/test_frontier.py's ``TestPartitionAssignment``.

(d) A four-slice cut of (phi) (``scheduler_world("frontier")``) through a
JAX and a port scheduler with delta, frontier and both self-checks on:
every round's summary, events, delta counters, ``state_fingerprint()`` and
the deterministic ``stats()`` fields equal.

(e) A one-slice world: frontier on equals frontier off round by round, and
no partitioned solve runs.

(f) A gang no slice holds goes through the residual and is admitted, as in
the JAX package; (g) two CPU devices equal the single-device path; (h) a
corrupted stacked lane makes the self-check raise.

No JAX object or store reaches the port: only documents, numpy arrays and
plain values cross.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.api.topology import ClusterTopology as JaxTopology
from grove_tpu.api.wire import decode_object as jax_decode
from grove_tpu.observability.events import EVENTS as JAX_EVENTS
from grove_tpu.ops import packing as jp
from grove_tpu.runtime.clock import VirtualClock as JaxClock
from grove_tpu.runtime.store import Store as JaxStore
from grove_tpu.sim.cluster import SimCluster as JaxCluster, make_nodes as jax_make_nodes
from grove_tpu.solver import encode as jax_encode
from grove_tpu.solver import frontier as jax_frontier
from grove_tpu.solver.kernel import solve_waves_stacked as jax_solve_waves_stacked
from grove_tpu.solver.scheduler import GangScheduler as JaxScheduler
from grove_tpu_torch.api.topology import ClusterTopology, ClusterTopologySpec, TopologyLevel
from grove_tpu_torch.api.wire import decode_object
from grove_tpu_torch.models.scenarios import (
    FRONTIER_STAT_FIELDS,
    STRESS_CAPACITY,
    EventCapture,
    _renamed,
    apply_tick,
    delta_counters,
    frontier_counters,
    gang_world_docs,
    queue_docs,
    round_summary,
    scheduler_world,
    stress_gang_specs,
)
from grove_tpu_torch.observability.events import EVENTS
from grove_tpu_torch.ops import packing as tp
from grove_tpu_torch.runtime.clock import VirtualClock
from grove_tpu_torch.runtime.store import Store
from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
from grove_tpu_torch.solver import encode, frontier
from grove_tpu_torch.solver.kernel import solve_waves, solve_waves_stacked
from grove_tpu_torch.solver.scheduler import GangScheduler

from tests.test_torch_flags import flag_specs
from tests.test_torch_scheduler import assert_same_events, assert_same_world

RESULT_FIELDS = ("admitted", "placed", "score", "chosen_level", "alloc")
# outputs of solve_wave_chunk_stack, in order
STACK_OUTPUTS = ("free_after", "admitted", "retry", "new_cap", "placed", "score",
                 "chosen_level", "alloc")
STACK_GANG_FIELDS = ("demand", "count", "min_count", "req_level", "pref_level", "group_req",
                     "group_pin", "gang_pin", "spread_level", "spread_min",
                     "spread_required", "spread_seed")
SENTINEL_FIELDS = ("req_level", "pref_level", "group_req", "group_pin", "gang_pin",
                   "spread_level")


@pytest.fixture(autouse=True)
def _events():
    JAX_EVENTS.reset()
    EVENTS.reset()
    yield
    JAX_EVENTS.reset()
    JAX_EVENTS.clock = None
    EVENTS.reset()
    EVENTS.clock = None


def _t(a):
    return torch.from_numpy(np.array(a))


def _equal(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


# -- (a) one stacked chunk-wave ---------------------------------------------------

N_LANE, G_LANE, P_LANE = 32, 24, 3
# two real lanes per case, on differently shaped topologies (their domain
# axes differ, so the stack pads one), then one inert lane
STACK_CASES = {
    "grouped+plain": ((("grouped", "plain"), ("plain",)), False),
    "pinned+plain": ((("pinned", "plain"), ("plain",)), True),
    "grouped+pinned": ((("grouped",), ("pinned", "plain")), False),
    "spread+plain": ((("spread", "plain"), ("plain",)), True),
}
LANE_TOPOLOGIES = ((4, 4), (2, 8))  # (hosts per ici-block, blocks per slice)


def _lane_problem(kinds, uniform, seed, topology):
    nodes = make_nodes(N_LANE, {"cpu": 16.0, "tpu": 4.0}, *topology)
    specs = flag_specs(G_LANE - 4, seed, kinds, uniform, N_LANE)
    return encode.build_problem(nodes, specs, ClusterTopology(), pad_gangs=G_LANE,
                                pad_groups=P_LANE)


def _stack(problems, inert=1):
    """Lane problems stacked as the frontier stacks them (domain axis padded
    to the widest, seeds to it too), then `inert` padding lanes."""
    d_max = max(p.seg_starts.shape[1] for p in problems)
    seeded = any(p.spread_seed.shape[1] for p in problems)

    def width(a, d):
        out = np.zeros(a.shape[:-1] + (d,), a.dtype)
        out[..., : a.shape[-1]] = a
        return out

    stack = {}
    for name in ("capacity", "topo", "seg_starts", "seg_ends") + STACK_GANG_FIELDS:
        mats = [getattr(p, name) for p in problems]
        if name in ("seg_starts", "seg_ends"):
            mats = [width(m, d_max) for m in mats]
        elif name == "spread_seed":
            mats = [width(m, d_max if seeded else 0) for m in mats]
        arr = np.stack(mats)
        pad = np.zeros((inert,) + arr.shape[1:], arr.dtype)
        if name in SENTINEL_FIELDS:
            pad -= 1
        stack[name] = np.concatenate([arr, pad])
    return stack


def _flags(stack):
    return dict(
        grouped=bool((stack["group_req"] >= 0).any()),
        pinned=bool((stack["gang_pin"] >= 0).any()),
        spread=bool((stack["spread_level"] >= 0).any()),
        uniform=bool((stack["min_count"] == stack["count"]).all()),
    )


@pytest.mark.parametrize("case", list(STACK_CASES))
def test_solve_wave_chunk_stack_matches_jax_and_solo(case):
    lane_kinds, uniform = STACK_CASES[case]
    problems = [_lane_problem(kinds, uniform, seed, topo)
                for seed, (kinds, topo) in enumerate(zip(lane_kinds, LANE_TOPOLOGIES))]
    stack = _stack(problems)
    b = len(problems) + 1
    rng = np.random.default_rng(len(case))
    chunk = 16
    sl = slice(0, chunk)
    # contended snapshots; the inert lane gets capacity it must not touch
    free = np.maximum(stack["capacity"] - rng.integers(0, 6, stack["capacity"].shape), 0)
    free = free.astype(np.float32)
    free[-1] = 7.0
    pending = rng.random((b, chunk)) < 0.9
    pending[-1] = False
    n_levels = stack["topo"].shape[2]
    narrow_cap = np.full((b, chunk), n_levels - 1, np.int32)
    narrow_cap[:, ::4] = rng.integers(-1, n_levels, (b, chunk))[:, ::4]
    # late-wave seeds: seed * 40503 wraps int32
    seeds = np.broadcast_to((np.arange(chunk) + 10240 + 15 * 7919).astype(np.int32), (b, chunk))
    gang = [stack[name][:, sl] for name in STACK_GANG_FIELDS]
    args = ([free, stack["topo"], stack["seg_starts"], stack["seg_ends"]] + gang[:5]
            + [pending, narrow_cap, seeds] + gang[5:])
    flags = _flags(stack)
    assert flags["uniform"] == uniform
    assert flags["grouped"] == ("grouped" in case) and flags["pinned"] == ("pinned" in case)
    want = jp.solve_wave_chunk_stack(*[jnp.asarray(a) for a in args], **flags)
    got = tp.solve_wave_chunk_stack(*[_t(a) for a in args], **flags)
    assert np.asarray(want[1]).any()
    for name, g, w in zip(STACK_OUTPUTS, got, want):
        if name == "score":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        else:
            _equal(g.numpy(), w, name)
    # the inert lane: nothing decided, its capacity untouched
    _equal(got[0][-1].numpy(), free[-1], "inert free_after")
    assert not got[1][-1].any() and not got[7][-1].any()
    # every lane equals the port's solo chunk solve on that lane, bit for bit
    by_name = dict(zip(STACK_OUTPUTS, got))
    for lane in range(b):
        solo = tp.solve_wave_chunk(
            *[_t(a[lane]) for a in args[:12]],
            **{name: _t(a[lane]) for name, a in zip(STACK_GANG_FIELDS[5:], args[12:])},
            **flags,
        )
        for name in STACK_OUTPUTS:
            _equal(by_name[name][lane].numpy(), solo[name].numpy(), f"lane {lane} {name}")


def test_fill_launches_once_for_every_lane():
    """The fill's vmap rule folds the lanes into the gang axis: each fill of
    a stacked dispatch is ONE call of the operator over B·C rows."""
    from grove_tpu_torch.ops import fill as fill_mod

    problems = [_lane_problem(("plain",), True, seed, topo)
                for seed, topo in enumerate(LANE_TOPOLOGIES)]
    stack = _stack(problems)
    b, chunk = stack["demand"].shape[0], 8
    rows = []
    real = fill_mod.fill_batch_ref

    def counting(free, mask, demand, count, with_free_after=True):
        rows.append(demand.shape[0])
        return real(free, mask, demand, count, with_free_after)

    sl = slice(0, chunk)
    args = ([stack["capacity"], stack["topo"], stack["seg_starts"], stack["seg_ends"]]
            + [stack[n][:, sl] for n in STACK_GANG_FIELDS[:5]]
            + [np.ones((b, chunk), bool), np.full((b, chunk), 3, np.int32),
               np.zeros((b, chunk), np.int32)]
            + [stack[n][:, sl] for n in STACK_GANG_FIELDS[5:]])
    orig = fill_mod.fill_batch_ref
    fill_mod.fill_batch_ref = counting
    try:
        tp.solve_wave_chunk_stack(*[_t(a) for a in args], **_flags(stack))
    finally:
        fill_mod.fill_batch_ref = orig
    # uniform, no flags: the level fill and the spill/rescue fill
    assert rows == [b * chunk, b * chunk]


# -- (b) the stacked wave loop on partitioned buckets -------------------------------

BUCKET_NODES = (64, dict(STRESS_CAPACITY), 4, 4)  # four slices of 16 hosts


def _partitioned_buckets(kinds, seed):
    """Port and JAX frontier states over one cluster; the gangs assigned and
    every bucket stacked as the frontier stacks it. Returns [(lanes,
    stack)], lanes the port lane problems."""
    nodes = make_nodes(*BUCKET_NODES)
    specs = [dict(s, name=f"default/{s['name']}", gang_name=s["name"], namespace="default")
             for s in flag_specs(48, seed, kinds, True, BUCKET_NODES[0])]
    problem = encode.build_problem(nodes, specs, ClusterTopology())
    enc = encode.NodeEncoding(nodes, ClusterTopology(), problem.resource_names)
    state = frontier.FrontierState(ClusterTopology())
    plan = state.plan_for(enc)
    assert plan.num_partitions == 4
    free = enc.base_capacity.copy()
    part_of = state.assign(plan, enc, free, specs)
    buckets = {}
    for k in sorted({int(k) for k in part_of if k >= 0}):
        idxs = [i for i in range(len(specs)) if part_of[i] == k]
        n_real = int(plan.ends[k] - plan.starts[k])
        key = (encode._next_pow2(max(len(idxs), frontier.MIN_SUB_GANG_BUCKET)),
               encode._next_pow2(max(n_real, 8)))
        lane = state._build_lane(enc, free, plan, k, idxs, specs, key[0], problem.max_groups,
                                 key[1], list(problem.resource_names))
        buckets.setdefault(key, []).append(lane)
    out = [(lanes, state._stack_bucket(lanes)) for lanes in buckets.values()]
    assert any(len(lanes) >= 2 for lanes, _ in out)
    return out


@pytest.mark.parametrize("kinds", [("plain",), ("pinned", "plain"), ("grouped", "plain")],
                         ids=["plain", "pinned", "grouped"])
def test_solve_waves_stacked_matches_jax_and_solo(kinds):
    for lanes, stack in _partitioned_buckets(kinds, seed=len(kinds)):
        want = jax_solve_waves_stacked(stack, chunk_size=8, max_waves=6)
        got = solve_waves_stacked(stack, chunk_size=8, max_waves=6, device="cpu")
        assert got["dispatches"] == want["dispatches"] and got["fill_launches"] == 0
        assert want["admitted"][: len(lanes)].any()
        for name in RESULT_FIELDS + ("free_after",):
            if name == "score":
                np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=0)
            else:
                _equal(got[name], want[name], name)
        for li, lane in enumerate(lanes):
            solo = solve_waves(lane, chunk_size=8, max_waves=6, with_alloc=True, device="cpu")
            for name in RESULT_FIELDS:
                _equal(got[name][li], getattr(solo, name), f"lane {li} {name}")


def test_solve_waves_stacked_needs_a_device_or_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lanes, stack = _partitioned_buckets(("plain",), seed=0)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_waves_stacked(stack)


# -- (c) the assignment ------------------------------------------------------------


def _spec(name, cpu=0.1, count=2, **kw):
    """A gang spec shaped as tests/test_frontier.py's ``_spec`` makes it."""
    spec = {
        "name": f"default/{name}", "gang_name": name, "namespace": "default",
        "groups": [{"name": f"{name}-g0", "demand": {"cpu": cpu}, "count": count,
                    "min_count": count, "partial": False, "required_key": None,
                    "pinned_node": None}],
        "required_key": None, "preferred_key": None, "spread_key": None,
        "spread_min_domains": 2, "spread_required": False, "spread_survivor_nodes": [],
        "gang_pinned_node": None, "priority": 0, "queue": "default",
    }
    spec.update(kw)
    return spec


def _multi():
    spec = _spec("multi")
    spec["groups"][0]["pinned_node"] = "node-0"  # slice 0
    spec["spread_survivor_nodes"] = ["node-31"]  # slice 1
    return spec


def _weird():
    spec = _spec("weird")
    spec["groups"][0]["demand"] = {"quantum-flux": 1.0}
    return spec


ASSIGN_CASES = {
    "multi_domain_pins_residual": lambda: [_multi()],
    "forced_partition_follows_pin": lambda: [_spec("pinned", gang_pinned_node="node-20")],
    "spread_residual": lambda: [_spec("spread", spread_key="kubernetes.io/hostname")],
    "broad_preference_residual": lambda: [
        _spec("broad", preferred_key="topology.kubernetes.io/zone")],
    "oversized_residual": lambda: [_spec("big", cpu=7.0, count=20)],
    "unknown_resource_residual": lambda: [_weird()],
    "balances_and_debits": lambda: [_spec(f"fat-{i}", cpu=7.0, count=14) for i in range(2)],
    "mixed": lambda: [_spec(f"m{i}", cpu=float(i % 4 + 1), count=i % 5 + 1) for i in range(24)]
    + [_multi(), _weird(), _spec("pinned", gang_pinned_node="node-3")],
}
ASSIGN_WANT = {
    "multi_domain_pins_residual": [-1], "spread_residual": [-1],
    "broad_preference_residual": [-1], "oversized_residual": [-1],
    "unknown_resource_residual": [-1],
}


def _assign(state_cls, enc_mod, nodes, specs, topology):
    rset = sorted({r for n in nodes for r in n.capacity})
    enc = enc_mod.NodeEncoding(nodes, topology, rset)
    state = state_cls(topology)
    plan = state.plan_for(enc)
    return state.assign(plan, enc, enc.base_capacity.copy(), specs), plan, enc


@pytest.mark.parametrize("case", list(ASSIGN_CASES))
def test_assign_matches_jax(case):
    specs = ASSIGN_CASES[case]()
    got, plan, enc = _assign(frontier.FrontierState, encode, make_nodes(32), specs,
                             ClusterTopology())
    want, _, _ = _assign(jax_frontier.FrontierState, jax_encode, jax_make_nodes(32), specs,
                         JaxTopology())
    assert plan.num_partitions == 2
    _equal(got, want, case)
    if case in ASSIGN_WANT:
        assert got.tolist() == ASSIGN_WANT[case]
    elif case == "forced_partition_follows_pin":
        s, e = int(plan.starts[got[0]]), int(plan.ends[got[0]])
        assert "node-20" in enc.node_names[s:e]
    elif case == "balances_and_debits":
        assert set(got.tolist()) == {0, 1}


def test_cordon_shifts_partition_as_in_jax():
    spec = _spec("mover", cpu=1.0, count=4)
    sides = []
    for state_cls, enc_mod, nodes, topology in (
        (frontier.FrontierState, encode, make_nodes(32), ClusterTopology()),
        (jax_frontier.FrontierState, jax_encode, jax_make_nodes(32), JaxTopology()),
    ):
        (before,), plan, enc = _assign(state_cls, enc_mod, nodes, [spec], topology)
        s, e = int(plan.starts[before]), int(plan.ends[before])
        cordoned = set(enc.node_names[s:e])
        survivors = [n for n in nodes if n.name not in cordoned]
        (after,), plan2, enc2 = _assign(state_cls, enc_mod, survivors, [spec], topology)
        s2, e2 = int(plan2.starts[after]), int(plan2.ends[after])
        assert after >= 0 and not cordoned & set(enc2.node_names[s2:e2])
        sides.append((int(before), int(after)))
    assert sides[0] == sides[1]


# -- (d)-(h) scheduler worlds --------------------------------------------------------


def _port_scheduler(w, frontier_on=True, selfchecks=True):
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store, make_nodes(*w["nodes"]))
    sched = GangScheduler(store, cluster, w.get("topology") or ClusterTopology(),
                          w["priority_map"], device="cpu")
    assert sched.enable_delta()
    sched.delta_selfcheck = selfchecks
    if frontier_on:
        assert sched.enable_frontier()
        sched.frontier_selfcheck = selfchecks
    return store, cluster, sched


def _jax_scheduler(w):
    store = JaxStore(JaxClock(0.0))
    cluster = JaxCluster(store=store, nodes=jax_make_nodes(*w["nodes"]))
    sched = JaxScheduler(store, cluster, JaxTopology(), w["priority_map"])
    assert sched.enable_delta() and sched.enable_frontier()
    sched.delta_selfcheck = sched.frontier_selfcheck = True
    return store, cluster, sched


def run_with_jax(w):
    """A world through a JAX and a port scheduler, delta, frontier and both
    self-checks on, held round by round. Returns the port scheduler and its
    per-round frontier counters."""
    jax_store, jax_cluster, jax_sched = _jax_scheduler(w)
    store, cluster, sched = _port_scheduler(w)
    for doc in w["queues"] + w["rounds"][0]:
        jax_store.create(jax_decode(doc))
        store.create(decode_object(doc), consume=True)
    history = []
    for index, tick in enumerate([None] + w.get("ticks", [])):
        if tick:
            apply_tick(jax_store, jax_cluster, tick, jax_decode)
            apply_tick(store, cluster, tick, decode_object)
        with EventCapture(JAX_EVENTS) as jax_events:
            jax_bound = jax_sched.schedule_pending()
        with EventCapture(EVENTS) as port_events:
            bound = sched.schedule_pending()
        tag = f"round {index + 1}"
        assert bound == jax_bound, tag
        assert_same_events(port_events.events, jax_events.events)
        want = round_summary(jax_store, jax_cluster, jax_events.events)
        got = round_summary(store, cluster, port_events.events)
        assert np.isclose(got.pop("score_sum"), want.pop("score_sum"), rtol=1e-6), tag
        assert got == want, tag
        assert delta_counters(sched.delta) == delta_counters(jax_sched.delta), tag
        assert sched.delta.state_fingerprint() == jax_sched.delta.state_fingerprint(), tag
        counters = frontier_counters(sched.frontier)
        assert counters == frontier_counters(jax_sched.frontier), tag
        assert_same_world(store, cluster, jax_store, jax_cluster)
        history.append(counters)
    return sched, history


def test_phi_cut_rounds_match_jax():
    """Four slices of 64 nodes, 128 gangs, 16 churn ticks (the cordon at
    tick 8, back at tick 16)."""
    w = scheduler_world("frontier", 256, 128)
    assert len(w["ticks"]) == 16
    sched, history = run_with_jax(w)
    last = history[-1]
    assert set(last) == set(FRONTIER_STAT_FIELDS)
    assert last["solves"] >= 10 and last["subproblems_total"] > last["solves"]
    assert last["residual_gangs_total"] > 0 and last["degenerate_ticks"] == 0
    assert history[0]["subproblems_total"] == 4  # every slice a lane in round 1
    assert sched.delta.solve_reuses >= 1 and sched.delta.full_fallbacks >= 1


def test_one_slice_world_equals_frontier_off():
    """64 nodes are one slice, and the topology stops at the slice level:
    every level is one domain, so every tick is degenerate and takes the
    global path, and frontier on and off bind alike round by round."""
    w = scheduler_world("delta", 64, 64, ticks=9)
    w["topology"] = ClusterTopology(spec=ClusterTopologySpec(levels=[
        TopologyLevel("zone", "topology.kubernetes.io/zone"),
        TopologyLevel("slice", "cloud.google.com/gke-tpu-slice"),
    ]))
    on = _port_scheduler(w, frontier_on=True, selfchecks=False)
    off = _port_scheduler(w, frontier_on=False, selfchecks=False)
    for doc in w["queues"] + w["rounds"][0]:
        for store, _c, _s in (on, off):
            store.create(decode_object(doc), consume=True)
    for index, tick in enumerate([None] + w["ticks"]):
        summaries = []
        for store, cluster, sched in (on, off):
            if tick:
                apply_tick(store, cluster, tick, decode_object)
            with EventCapture(EVENTS) as events:
                sched.schedule_pending()
            summaries.append((round_summary(store, cluster, events.events), events.events))
        assert summaries[0] == summaries[1], f"round {index + 1}"
        assert list(on[1].bindings.items()) == list(off[1].bindings.items())
    stats = on[2].frontier.stats()
    assert stats["solves"] == 0 and stats["degenerate_ticks"] > 0
    assert on[2].frontier.stacked_fill_launches == 0


RESIDUAL_NODES = (48, dict(STRESS_CAPACITY), 4, 4)  # three slices of 16 hosts


def residual_world():
    """One gang of 20 eight-chip pods (160 chips; a slice has 128) and 12
    stress gangs, over two queues."""
    wide = {"name": "wide", "required_key": None, "preferred_key": None, "priority": 0,
            "groups": [{"name": "wide-0", "demand": {"tpu": 8.0, "cpu": 4.0}, "count": 20,
                        "min_count": 20}]}
    specs = [wide] + _renamed(stress_gang_specs(12, seed=9), "small")

    def tenant(i, spec):
        return f"tenant-{i % 2}"

    share = {r: v * RESIDUAL_NODES[0] / 2 for r, v in STRESS_CAPACITY.items()}
    return {"nodes": RESIDUAL_NODES, "priority_map": {},
            "queues": queue_docs({f"tenant-{k}": share for k in range(2)}),
            "rounds": [gang_world_docs(specs, namespace_of=tenant, queue_of=tenant)]}


def test_residual_gang_admitted_as_in_jax():
    w = residual_world()
    sched, history = run_with_jax(w)
    assert history[-1]["residual_gangs_total"] >= 1
    assert history[-1]["residual_overlap_hits"] >= 1  # encoded while the slabs ran
    gang = sched.store.get("PodGang", "tenant-0", "wide-0", readonly=True)
    assert gang.status.placement_score is not None  # admitted


def _run_port(w, devices=None):
    store, cluster, sched = _port_scheduler(w)
    if devices is not None:
        sched.frontier.devices = devices
    for doc in w["queues"] + w["rounds"][0]:
        store.create(decode_object(doc), consume=True)
    with EventCapture(EVENTS) as events:
        sched.schedule_pending()
    return round_summary(store, cluster, events.events), list(cluster.bindings.items()), sched


def test_two_devices_equal_the_single_device_path():
    w = residual_world()
    one = _run_port(w)
    two = _run_port(w, devices=[torch.device("cpu"), torch.device("cpu")])
    assert one[:2] == two[:2]
    assert one[2].frontier.last_devices_used == 1 and two[2].frontier.last_devices_used == 2
    # each device's stack counts its own dispatches, as in the JAX package
    a, b = frontier_counters(one[2].frontier), frontier_counters(two[2].frontier)
    assert b.pop("batched_dispatches_total") >= a.pop("batched_dispatches_total")
    assert a == b


def test_frontier_devices_default_is_the_schedulers_own(monkeypatch):
    monkeypatch.delenv("GROVE_TPU_FRONTIER_DEVICES", raising=False)
    assert frontier.frontier_devices() == [None]
    monkeypatch.setenv("GROVE_TPU_FRONTIER_DEVICES", "all")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert frontier.frontier_devices() == [None]


def _corrupt(out, field):
    """Change `field` of the first admitted gang of a stacked result."""
    admitted = np.argwhere(out["admitted"])
    assert len(admitted), "no admitted gang to corrupt"
    li, gi = admitted[0]
    value = out[field]
    if field == "admitted":
        value[li, gi] = False
    elif field == "score":
        value[li, gi] = np.nextafter(value[li, gi], np.float32(2))
    elif field == "alloc":
        value[li, gi, 0, 0] += 1
    else:
        value[li, gi] = value[li, gi] + 1


@pytest.mark.parametrize("field", RESULT_FIELDS)
def test_corrupted_lane_trips_the_selfcheck(field, monkeypatch):
    real = frontier.solve_waves_stacked

    def corrupted(stack, **kw):
        out = real(stack, **kw)
        _corrupt(out, field)
        return out

    monkeypatch.setattr(frontier, "solve_waves_stacked", corrupted)
    with pytest.raises(AssertionError, match=f"diverged from the solo solve on '{field}'"):
        _run_port(residual_world())


@pytest.mark.parametrize("frontier_on", [True, False], ids=["frontier", "global"])
def test_survivor_on_a_cordoned_node_pins_nothing_as_in_jax(frontier_on):
    """ROADMAP C.4, a reference-side fault the port keeps: the encoder maps
    a recovery pin through the schedulable nodes only, so a gang whose only
    survivor sits on a cordoned node is solved unpinned and can leave its
    required slice (the frontier's assignment, too, finds no partition to
    force). Two slices of two nodes; gang ``g`` (one clique of two 8-chip
    pods, packed in a slice) fills one slice. The node of pod 0 is
    cordoned, pod 1 is replaced while its node shrinks to 4 chips: both
    packages bind the replacement in the other slice, the same way."""
    nodes = (4, {"cpu": 128.0, "tpu": 8.0}, 1, 2)
    specs = [{"name": "g", "required_key": "cloud.google.com/gke-tpu-slice",
              "preferred_key": None, "priority": 0,
              "groups": [{"name": "a", "demand": {"tpu": 8.0, "cpu": 1.0}, "count": 2,
                          "min_count": 2}]}]
    w = {"nodes": nodes, "priority_map": {}, "queues": [], "rounds": [gang_world_docs(specs)]}
    jax_store, jax_cluster, jax_sched = _jax_scheduler(w)
    store, cluster, sched = _port_scheduler(w)
    if not frontier_on:
        jax_sched.frontier = sched.frontier = None
    for doc in w["rounds"][0]:
        jax_store.create(jax_decode(doc))
        store.create(decode_object(doc), consume=True)
    jax_sched.schedule_pending()
    sched.schedule_pending()
    assert list(cluster.bindings.items()) == list(jax_cluster.bindings.items())
    pods = sorted(d["metadata"]["name"] for d in w["rounds"][0] if d["kind"] == "Pod")
    survivor_node = cluster.bindings[("default", pods[0])]
    failed = next(d for d in w["rounds"][0] if d["metadata"]["name"] == pods[1])
    failed_node = cluster.bindings[("default", pods[1])]
    tick = [("delete", "Pod", "default", pods[1]), ("create", failed),
            ("cordon", survivor_node, True)]
    for st, cl, decode in ((jax_store, jax_cluster, jax_decode), (store, cluster, decode_object)):
        apply_tick(st, cl, tick, decode)
        next(n for n in cl.nodes if n.name == failed_node).capacity["tpu"] = 4.0
    with EventCapture(JAX_EVENTS) as jax_events:
        jax_sched.schedule_pending()
    with EventCapture(EVENTS) as port_events:
        sched.schedule_pending()
    assert_same_events(port_events.events, jax_events.events)
    assert list(cluster.bindings.items()) == list(jax_cluster.bindings.items())
    if frontier_on:
        assert frontier_counters(sched.frontier) == frontier_counters(jax_sched.frontier)
        assert sched.frontier.solves == 2
    slices = {n.name: n.labels["cloud.google.com/gke-tpu-slice"] for n in cluster.nodes}
    gang_slices = {slices[node] for (_ns, _pod), node in cluster.bindings.items()}
    assert len(gang_slices) == 2  # the reference's placement: the pack is broken
