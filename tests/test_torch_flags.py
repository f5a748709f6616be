"""The port's static-flag fills (per-group packs, recovery pins, topology
spread) against the JAX package's.

Each per-gang JAX function is ``jax.vmap``-ed over the chunk here; the port
writes the chunk axis out. Inputs come from numpy seeds. Integer, bool and
capacity outputs are compared bit for bit; the PlacementScore with
rtol=1e-6, atol=0 (XLA's CPU backend fuses its multiply-add; see
tests/test_torch_packing.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.api.topology import ClusterTopology as JTopology
from grove_tpu.ops import packing as jp
from grove_tpu.sim.cluster import make_nodes as j_make_nodes
from grove_tpu.solver.encode import build_problem as j_build_problem
from grove_tpu.solver.kernel import dedup_demand, level_widths_of
from grove_tpu.solver.kernel import solve_waves as j_solve_waves
from grove_tpu_torch.convert import problem_from_arrays
from grove_tpu_torch.ops import packing as tp
from grove_tpu_torch.ops.fill import fill_batch
from grove_tpu_torch.solver.kernel import solve_waves

SLICE = "cloud.google.com/gke-tpu-slice"
BLOCK = "cloud.google.com/gke-tpu-ici-block"
HOST = "kubernetes.io/hostname"
EXACT = ("admitted", "placed", "chosen_level", "alloc", "free_after")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _equal(got, want, name=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------------
# _spread_quota
# ---------------------------------------------------------------------------

_J_QUOTA = jax.jit(jax.vmap(jp._spread_quota))


def _quota_rows(case):
    rng = np.random.default_rng({"random": 0, "tied_load": 1, "cnt_above_sum": 2,
                                 "cnt_zero": 3, "k_zero": 4}[case])
    c, d = 12, 37
    K = rng.integers(0, 7, (c, d)).astype(np.int32)
    K[:, rng.random(d) < 0.2] = 0  # empty (padded) domains
    load = rng.integers(0, 4, (c, d)).astype(np.int32)
    cnt = rng.integers(0, 60, (c,)).astype(np.int32)
    if case == "tied_load":
        load[:] = 2  # every water-level domain ties: the index decides
        load[::3, ::2] = 1
    elif case == "cnt_above_sum":
        cnt = K.sum(1).astype(np.int32) + rng.integers(1, 9, (c,)).astype(np.int32)
    elif case == "cnt_zero":
        cnt[:] = 0
    elif case == "k_zero":
        K[:] = 0
    return K, cnt, load


@pytest.mark.parametrize("case", ["random", "tied_load", "cnt_above_sum", "cnt_zero", "k_zero"])
def test_spread_quota_matches(case):
    K, cnt, load = _quota_rows(case)
    want = _J_QUOTA(*_j(K, cnt, load))
    got = tp._spread_quota(_t(K), _t(cnt), _t(load))
    _equal(got, want)
    q = got.numpy()
    assert (q >= 0).all() and (q <= K).all()
    np.testing.assert_array_equal(q.sum(1), np.minimum(cnt, K.sum(1)))


def test_water_level_matches_bisection_edges():
    """The exact water level against the JAX bisection's own answer, with
    counts past 2*_INT_CAP (no level reaches them: the cap comes back)."""
    K = np.array([[0, 0, 0], [5, 1, 3], [1 << 22, 2, 0], [4, 4, 4]], np.int32)
    cnt = np.array([3, 7, (1 << 21) + 5, 12], np.int32)

    def bisect(k, n):
        def body(_, lohi):
            lo, hi = lohi
            mid = (lo + hi) // 2
            ge = jnp.sum(jnp.minimum(k, mid)) >= n
            return jnp.where(ge, lo, mid + 1), jnp.where(ge, mid, hi)
        return jax.lax.fori_loop(0, 22, body, (jnp.int32(0), jnp.int32(2 * jp._INT_CAP)))[1]

    want = jax.vmap(bisect)(*_j(K, cnt))
    _equal(tp._water_level(_t(K), _t(cnt)), want)


# ---------------------------------------------------------------------------
# _fill_spread / _fill_spread_floors_first
# ---------------------------------------------------------------------------


def _topology(n_nodes=64, hosts_per_block=4, blocks_per_slice=4):
    prob = j_build_problem(
        j_make_nodes(n_nodes, {"cpu": 16.0}, hosts_per_block, blocks_per_slice),
        [{"name": "x", "groups": [{"name": "x0", "demand": {"cpu": 1.0},
                                   "count": 1, "min_count": 1}]}],
        JTopology(),
    )
    return prob.topo, prob.seg_starts, prob.seg_ends


def _spread_inputs(seed, c=8, p=3, level=3):
    rng = np.random.default_rng(seed)
    topo, seg_starts, seg_ends = _topology()
    n = topo.shape[0]
    free = rng.integers(0, 12, (n, 2)).astype(np.float32)
    mask = rng.random((c, n)) < 0.8
    demand = rng.integers(0, 4, (c, p, 2)).astype(np.float32)
    demand[:, 0, 1] = -0.0  # the solver's demands hold -0.0
    count = rng.integers(0, 9, (c, p)).astype(np.int32)
    min_count = np.minimum(count, rng.integers(0, 6, (c, p))).astype(np.int32)
    levels = np.full((c,), level, np.int32)
    levels[::2] = 4  # host-level spread on every other gang
    load0 = rng.integers(0, 3, (c, seg_starts.shape[1])).astype(np.int32)
    load0 *= (seg_ends > seg_starts)[levels]  # survivors only in real domains
    return free, mask, demand, count, min_count, levels, load0, topo, seg_starts, seg_ends


def _port_views(levels, topo, seg_starts, seg_ends):
    lv = _t(levels).long()
    return (_t(topo).t()[lv].long(), _t(seg_starts).long()[lv], _t(seg_ends).long()[lv])


@pytest.mark.parametrize("with_load0", [False, True], ids=["no_load0", "load0"])
def test_fill_spread_matches(with_load0):
    free, mask, demand, count, _, levels, load0, topo, ss, se = _spread_inputs(1)
    cols = [np.take(topo, l, axis=1) for l in levels]
    j_views = (jnp.asarray(np.stack(cols)), jnp.asarray(ss[levels]), jnp.asarray(se[levels]))

    def one(m, d, k, col, st, en, ld):
        return jp._fill_spread(jnp.asarray(free), m, d, k, col, st, en, ld if with_load0 else None)

    want = jax.jit(jax.vmap(one))(*_j(mask, demand, count), *j_views, jnp.asarray(load0))
    got = tp._fill_spread(_t(free), _t(mask), _t(demand), _t(count),
                          *_port_views(levels, topo, ss, se),
                          _t(load0) if with_load0 else None)
    assert int(np.asarray(want[1]).sum()) > 0
    for name, g, w in zip(("alloc", "placed", "free_after", "load"), got, want):
        _equal(g, w, name)


@pytest.mark.parametrize("with_load0", [False, True], ids=["no_load0", "load0"])
def test_fill_spread_floors_first_matches(with_load0):
    free, mask, demand, count, min_count, levels, load0, topo, ss, se = _spread_inputs(2)
    cols = np.stack([np.take(topo, l, axis=1) for l in levels])

    def one(m, d, k, mn, col, st, en, ld):
        return jp._fill_spread_floors_first(jnp.asarray(free), m, d, k, mn, col, st, en,
                                            ld if with_load0 else None)

    want = jax.jit(jax.vmap(one))(*_j(mask, demand, count, min_count, cols,
                                      ss[levels], se[levels], load0))
    got = tp._fill_spread_floors_first(
        _t(free), _t(mask), _t(demand), _t(count), _t(min_count),
        *_port_views(levels, topo, ss, se), _t(load0) if with_load0 else None,
    )
    assert int(np.asarray(want[4]).min()) >= 1
    for name, g, w in zip(("alloc", "placed", "placed_min", "free_after", "used"), got, want):
        _equal(g, w, name)


# ---------------------------------------------------------------------------
# _fill_grouped
# ---------------------------------------------------------------------------


def _grouped_inputs(seed, c=10, p=3):
    rng = np.random.default_rng(seed)
    topo, ss, se = _topology()
    n = topo.shape[0]
    free = rng.integers(0, 10, (n, 2)).astype(np.float32)
    mask = rng.random((c, n)) < 0.7
    demand = rng.integers(1, 4, (c, p, 2)).astype(np.float32)
    demand[:, 1, 0] = -0.0
    count = rng.integers(1, 9, (c, p)).astype(np.int32)
    min_count = np.minimum(count, rng.integers(1, 6, (c, p))).astype(np.int32)
    group_req = rng.choice(np.array([-1, 2, 3, 4], np.int32), (c, p))
    group_pin = np.full((c, p), -1, np.int32)
    # a pinned group: block 5 at level 3 (and a host pin at level 4)
    group_req[0, 0], group_pin[0, 0] = 3, 5
    free[topo[:, 3] == 5] = 9.0
    mask[0, topo[:, 3] == 5] = True
    group_req[1, 2], group_pin[1, 2] = 4, 17
    # an infeasible group: a floor no domain of its level can hold
    group_req[2, 1], count[2, 1], min_count[2, 1] = 4, 500, 400
    # late-wave seeds: seed * 40503 wraps int32
    seed_arr = (np.arange(c) * 33331 + 10240 + 15 * 7919).astype(np.int32)
    assert (seed_arr.astype(np.int64) * 40503 > 2**31).any()
    return free, mask, demand, count, min_count, group_req, group_pin, topo, ss, se, seed_arr


@pytest.mark.parametrize("with_free_after", [True, False], ids=["free_after", "no_free_after"])
def test_fill_grouped_matches(with_free_after):
    free, mask, demand, count, min_count, grq, gpin, topo, ss, se, seeds = _grouped_inputs(3)

    def one(m, d, k, mn, gr, gp, sd):
        return jp._fill_grouped(jnp.asarray(free), m, d, k, mn, gr, gp, jnp.asarray(topo),
                                jnp.asarray(ss), jnp.asarray(se), sd)

    want = jax.jit(jax.vmap(one))(*_j(mask, demand, count, min_count, grq, gpin, seeds))
    calls = []

    def counting_fill(*args, **kw):
        calls.append((args[0].dim(), args[2].shape[1]))
        return fill_batch(*args, **kw)

    got = tp._fill_grouped(_t(free), _t(mask), _t(demand), _t(count), _t(min_count),
                           _t(grq), _t(gpin), _t(topo), _t(ss).long(), _t(se).long(),
                           _t(seeds), counting_fill, with_free_after=with_free_after)
    p = demand.shape[1]
    # 2P fills of one group each: shared free first, per-gang free after
    assert calls == [(2, 1)] + [(3, 1)] * (2 * p - 1)
    placed_min = np.asarray(want[2])
    assert placed_min[0, 0] > 0 and placed_min[2, 1] < min_count[2, 1]
    for name, g, w in zip(("alloc", "placed", "placed_min"), got[:3], want[:3]):
        _equal(g, w, name)
    if with_free_after:
        _equal(got[3], want[3], "free_after")
    else:
        assert got[3] is None
    # the pinned group lies inside its pin's domain
    assert set(topo[np.asarray(want[0])[0, 0] > 0, 3]) == {5}


# ---------------------------------------------------------------------------
# _gang_pin_mask with the per-gang _aggregate_tables
# ---------------------------------------------------------------------------


def test_gang_pin_mask_and_aggregate_tables_match():
    rng = np.random.default_rng(4)
    topo, _, _ = _topology()
    n, c, p = topo.shape[0], 8, 2
    free = rng.integers(0, 30, (n, 2)).astype(np.float32)
    demand = rng.integers(0, 4, (c, p, 2)).astype(np.float32)
    count = rng.integers(0, 6, (c, p)).astype(np.int32)
    min_count = np.minimum(count, rng.integers(0, 6, (c, p))).astype(np.int32)
    req = np.array([2, 2, 3, -1, 2, 3, -1, 2], np.int32)
    pin = np.array([1, -1, 7, 3, 0, -1, -1, 2], np.int32)  # gang 3: pin but no req

    def one(d, k, mn, rq, gp):
        gang = jp.GangInputs(d, k, mn, rq, rq, gang_pin=gp)
        pin_mask, free_vis = jp._gang_pin_mask(jnp.asarray(free), jnp.asarray(topo), gang, True)
        return (pin_mask, free_vis) + jp._aggregate_tables(free_vis, gang)

    want = jax.jit(jax.vmap(one))(*_j(demand, count, min_count, req, pin))
    gang = tp.GangInputs(_t(demand), _t(count), _t(min_count), _t(req), _t(req), gang_pin=_t(pin))
    pin_mask, free_vis = tp._gang_pin_mask(_t(free), _t(topo), gang, True)
    got = (pin_mask, free_vis) + tp._aggregate_tables(free_vis, gang)
    names = ("pin_mask", "free_vis", "active", "cs_k", "cs_free", "free_tol", "min_demand")
    for name, g, w in zip(names, got, want):
        _equal(g, w, name)
    assert not np.asarray(want[0])[0].all() and np.asarray(want[0])[3].all()
    # unpinned form: all nodes, the shared snapshot itself
    free_t = _t(free)
    mask0, vis0 = tp._gang_pin_mask(free_t, _t(topo), gang, False)
    assert mask0.shape == (n,) and bool(mask0.all()) and vis0 is free_t


# ---------------------------------------------------------------------------
# solve_wave_chunk with the flags
# ---------------------------------------------------------------------------


def flag_specs(n_gangs, seed, kinds, uniform=False, n_nodes=64):
    """Gangs of the given constraint kinds (cycled), each with 1–3 groups:
    grouped — per-group required packs at block/host, some with a recovery
    pin, half inside a required slice; pinned — a required slice with the
    gang pinned to a survivor's slice; spread — the spread-serving form
    (slice pack, hard spread over >= 3 blocks, some with survivors) or a
    soft spread over hosts with no pack; plain — no constraint."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n_gangs):
        kind = kinds[i % len(kinds)]
        groups = []
        for q in range(int(rng.integers(1, 4))):
            count = int(rng.integers(1, 6))
            groups.append({
                "name": f"f{i}-{q}",
                "demand": {"cpu": float(rng.integers(1, 5)), "tpu": float(rng.integers(0, 2))},
                "count": count,
                "min_count": count if uniform else int(rng.integers(1, count + 1)),
            })
        spec = {"name": f"f{i}", "groups": groups, "priority": 0,
                "required_key": None, "preferred_key": None}
        if kind == "grouped":
            for q, grp in enumerate(groups):
                grp["required_key"] = [BLOCK, HOST, None][(i + q) % 3]
                if grp["required_key"] and rng.random() < 0.3:
                    grp["pinned_node"] = f"node-{int(rng.integers(0, n_nodes))}"
            if i % 2:
                spec["required_key"] = SLICE
        elif kind == "pinned":
            spec["required_key"] = SLICE
            if rng.random() < 0.7:
                spec["gang_pinned_node"] = f"node-{int(rng.integers(0, n_nodes))}"
        elif kind == "spread":
            if i % 2:
                spec.update(required_key=SLICE, spread_key=BLOCK, spread_min_domains=3,
                            spread_required=True)
                if rng.random() < 0.4:
                    first = 4 * int(rng.integers(0, n_nodes // 4))
                    spec["spread_survivor_nodes"] = [f"node-{first}", f"node-{first + 1}"]
            else:
                spec.update(spread_key=HOST, spread_min_domains=4, preferred_key=BLOCK)
        specs.append(spec)
    return specs


def _flag_problem(kinds, uniform, seed=0, n_gangs=40, n_nodes=64):
    nodes = j_make_nodes(n_nodes, {"cpu": 16.0, "tpu": 4.0}, 4, 4)
    return j_build_problem(nodes, flag_specs(n_gangs, seed, kinds, uniform, n_nodes), JTopology())


FLAG_KINDS = {
    "grouped": ("grouped", "plain"),
    "pinned": ("pinned", "plain"),
    "spread": ("spread", "plain"),
    "all": ("grouped", "pinned", "spread", "plain"),
}
FIELDS = ("admitted", "retry", "new_cap", "placed", "chosen_level", "alloc", "free_after")


@pytest.mark.parametrize("dedup", [False, True], ids=["nodedup", "dedup"])
@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "nonuniform"])
@pytest.mark.parametrize("flags", list(FLAG_KINDS))
def test_solve_wave_chunk_flags_match(flags, uniform, dedup):
    prob = _flag_problem(FLAG_KINDS[flags], uniform, seed=len(flags))
    grouped = bool((prob.group_req >= 0).any())
    pinned = bool((prob.gang_pin >= 0).any())
    spread = bool((prob.spread_level >= 0).any())
    assert (grouped, pinned, spread) == (flags in ("grouped", "all"),
                                         flags in ("pinned", "all"),
                                         flags in ("spread", "all"))
    assert bool((prob.min_count == prob.count).all()) == uniform
    chunk = 16
    rng = np.random.default_rng(11)
    sl = slice(0, chunk)
    free = prob.capacity - rng.integers(0, 9, prob.capacity.shape).astype(np.float32)
    free = np.maximum(free, 0)
    pending = rng.random(chunk) < 0.9
    narrow_cap = rng.integers(-1, prob.num_levels, chunk).astype(np.int32)
    narrow_cap[::3] = prob.num_levels - 1
    seeds = (np.arange(chunk) + 10240 + 15 * 7919).astype(np.int32)
    args = [free, prob.topo, prob.seg_starts, prob.seg_ends, prob.demand[sl],
            prob.count[sl], prob.min_count[sl], prob.req_level[sl],
            prob.pref_level[sl], pending, narrow_cap, seeds]
    kw = {name: getattr(prob, name)[sl] for name in
          ("group_req", "group_pin", "gang_pin", "spread_level", "spread_min",
           "spread_required", "spread_seed")}
    if dedup:
        pdem, pcnt, pidx = dedup_demand(prob.demand, prob.count, 10**6)
        kw.update(pair_demand=pdem, pair_count=pcnt, pair_idx=pidx[sl])
    static = dict(grouped=grouped, pinned=pinned, spread=spread, uniform=uniform,
                  level_widths=level_widths_of(prob))
    want = jp.solve_wave_chunk(*_j(*args), **{k: jnp.asarray(v) for k, v in kw.items()}, **static)
    got = tp.solve_wave_chunk(*[_t(a) for a in args], **{k: _t(v) for k, v in kw.items()}, **static)
    assert np.asarray(want["admitted"]).any()
    for field in FIELDS:
        _equal(got[field], want[field], field)
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "nonuniform"])
@pytest.mark.parametrize("flags", list(FLAG_KINDS))
def test_solve_waves_flags_match(flags, uniform):
    """Whole solves, encoded once by the JAX package and carried across."""
    prob = _flag_problem(FLAG_KINDS[flags], uniform, seed=7 + len(flags), n_gangs=96, n_nodes=128)
    want = j_solve_waves(prob, chunk_size=16)
    got = solve_waves(problem_from_arrays(prob), chunk_size=16, device="cpu")
    assert 0 < want.admitted.sum()
    for name in EXACT:
        _equal(getattr(got, name), getattr(want, name), name)
    np.testing.assert_allclose(got.score, want.score, rtol=1e-6, atol=0)


def test_pinned_chunk_turns_dedup_off():
    """Under recovery pins each gang sees its own capacity view, so the
    shared dedup table must not be used even when it is passed: a pinned
    gang whose floors are 0 finds every domain feasible, and only its own
    view keeps the domains that hold its full count inside the pin."""
    nodes = j_make_nodes(64, {"cpu": 16.0}, 4, 4)
    specs = [{"name": f"p{i}", "priority": 0, "required_key": SLICE, "preferred_key": None,
              "gang_pinned_node": f"node-{16 + i}",
              "groups": [{"name": f"p{i}-0", "demand": {"cpu": 2.0}, "count": 3, "min_count": 0}]}
             for i in range(8)]
    prob = j_build_problem(nodes, specs, JTopology())
    c = 8
    assert (prob.gang_pin[:c] == 1).all()
    args = [prob.capacity, prob.topo, prob.seg_starts, prob.seg_ends, prob.demand[:c], prob.count[:c],
            prob.min_count[:c], prob.req_level[:c], prob.pref_level[:c], np.ones(c, bool),
            np.full(c, prob.num_levels - 1, np.int32), np.arange(c, dtype=np.int32)]
    pdem, pcnt, pidx = dedup_demand(prob.demand, prob.count, 10**6)
    kw = {"gang_pin": prob.gang_pin[:c], "pair_demand": pdem, "pair_count": pcnt,
          "pair_idx": pidx[:c]}
    want = jp.solve_wave_chunk(*_j(*args), **{k: jnp.asarray(v) for k, v in kw.items()},
                               pinned=True)
    got = tp.solve_wave_chunk(*[_t(a) for a in args], **{k: _t(v) for k, v in kw.items()},
                              pinned=True)
    for field in FIELDS:
        _equal(got[field], want[field], field)
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), rtol=1e-6, atol=0)
    # every pod inside the pinned slice (nodes 16..31)
    placed_nodes = np.nonzero(np.asarray(want["alloc"]).sum((0, 1)))[0]
    assert np.asarray(want["placed"]).sum() == 3 * c
    assert placed_nodes.min() >= 16 and placed_nodes.max() < 32
