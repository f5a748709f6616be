"""The port's wave-solver core (ops/packing.py) against the JAX package's.

Same seeded numpy inputs through JAX on the CPU and through the port with
CPU tensors (where the fill runs its plain version). Integer, bool and
capacity fields are compared bit for bit. The PlacementScore alone uses
rtol=1e-6, atol=0: XLA's CPU backend contracts the score's
``score + w[l] * share`` into a fused multiply-add (a one-ulp difference,
checked against an fma emulation), while the port rounds the product and
the sum separately on both devices.
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
from grove_tpu_torch.ops import packing as tp

BLOCK_KEY = "cloud.google.com/gke-tpu-ici-block"


_J_SEG_CUMSUM = jax.jit(jp._seg_cumsum, static_argnums=1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [256, 96, 64, 37])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_seg_cumsum_matches(n, dtype):
    """Integer tables and integer-valued float tables (the quantized solver
    tensors): exact under both frameworks' associations."""
    rng = np.random.default_rng(n)
    a = rng.integers(0, 1000, (3, n)).astype(dtype)
    for axis in (0, 1):
        want = np.asarray(_J_SEG_CUMSUM(jnp.asarray(a), axis))
        got = tp._seg_cumsum(_t(a), axis).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_seg_cumsum_int32_wraps_like_jax():
    a = np.full((128,), 1 << 26, dtype=np.int32)
    want = np.asarray(jp._seg_cumsum(jnp.asarray(a)))
    np.testing.assert_array_equal(tp._seg_cumsum(_t(a)).numpy(), want)


def test_pods_fit_per_node_matches():
    rng = np.random.default_rng(1)
    free = rng.integers(0, 50, (64, 3)).astype(np.float32)
    free[0] = [1e30, 1e30, 1e30]  # huge fit clips to _INT_CAP
    for demand in (
        rng.integers(0, 4, (3,)).astype(np.float32),
        np.zeros((3,), np.float32),  # no limit: inf clipped to _INT_CAP
        np.array([0.5, 0.0, 3.0], np.float32),
    ):
        want = np.asarray(jp._pods_fit_per_node(jnp.asarray(free), jnp.asarray(demand)))
        got = tp._pods_fit_per_node(_t(free), _t(demand)).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


_J_FLOORS_FIRST = {
    uniform: jax.jit(jax.vmap(
        lambda f, m, d, k, mn, u=uniform: jp._fill_floors_first(f, m, d, k, mn, uniform=u),
        in_axes=(None, 0, 0, 0, 0),
    ))
    for uniform in (True, False)
}


@pytest.mark.parametrize("with_free_after", [True, False], ids=["free_after", "no_free_after"])
@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "nonuniform"])
def test_fill_floors_first_matches(uniform, with_free_after):
    """The floors->extras chain with the flag threaded: only its last fill
    may drop free_after, so alloc, placed and placed_min stay the JAX
    package's."""
    rng = np.random.default_rng(5)
    free = rng.integers(0, 24, (96, 2)).astype(np.float32)
    mask = rng.random((6, 96)) < 0.6
    demand, count, min_count = _gang_arrays(6)
    if uniform:
        min_count = count.copy()
    want = _J_FLOORS_FIRST[uniform](*[jnp.asarray(a) for a in (free, mask, demand, count, min_count)])
    got = tp._fill_floors_first(
        _t(free), _t(mask), _t(demand), _t(count), _t(min_count), uniform,
        tp.fill_batch, with_free_after=with_free_after,
    )
    assert np.asarray(want[1]).sum() > 0
    for name, w, g in zip(("alloc", "placed", "placed_min"), want[:3], got[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if with_free_after:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    else:
        assert got[3] is None


def _gang_arrays(seed, c=6, p=3, r=2):
    rng = np.random.default_rng(seed)
    demand = rng.integers(0, 5, (c, p, r)).astype(np.float32)
    count = rng.integers(0, 5, (c, p)).astype(np.int32)
    min_count = np.minimum(count, rng.integers(0, 5, (c, p))).astype(np.int32)
    return demand, count, min_count


@pytest.mark.parametrize("dedup", [False, True], ids=["no_pair", "cs_pair"])
def test_aggregate_tables_matches(dedup):
    rng = np.random.default_rng(2)
    free = rng.integers(0, 40, (128, 2)).astype(np.float32)
    demand, count, min_count = _gang_arrays(3)
    c, p = count.shape
    cs_pair = uidx = None
    if dedup:
        pdem, pcnt, pidx = dedup_demand(demand, count, 10**6)
        fit = np.stack([
            np.minimum(np.asarray(jp._pods_fit_per_node(jnp.asarray(free), jnp.asarray(d))), k)
            for d, k in zip(pdem, pcnt)
        ])
        cs_pair = np.concatenate(
            [np.zeros((len(pdem), 1), np.int32), np.cumsum(fit, 1, dtype=np.int32)], 1
        )
        uidx = pidx
    zeros = np.zeros((c,), np.int32)

    def one(d, k, m, u):
        gang = jp.GangInputs(d, k, m, 0, 0, uidx=u)
        return jp._aggregate_tables(jnp.asarray(free), gang,
                                    None if cs_pair is None else jnp.asarray(cs_pair))

    u_in = jnp.asarray(uidx) if dedup else jnp.zeros((c, p), jnp.int32)
    active, cs_k, cs_free, free_tol, min_demand = jax.jit(jax.vmap(
        lambda d, k, m, u: one(d, k, m, u if dedup else None)
    ))(jnp.asarray(demand), jnp.asarray(count), jnp.asarray(min_count), u_in)

    gang = tp.GangInputs(_t(demand), _t(count), _t(min_count), _t(zeros), _t(zeros),
                         _t(uidx) if dedup else None)
    t_active, t_cs_k, t_cs_free, t_tol, t_min = tp._aggregate_tables(
        _t(free), gang, None if cs_pair is None else _t(cs_pair)
    )
    np.testing.assert_array_equal(t_active.numpy(), np.asarray(active))
    # cs_free / free_tol are shared by the chunk (one snapshot): one row
    np.testing.assert_array_equal(t_cs_free.numpy(), np.asarray(cs_free)[0])
    np.testing.assert_array_equal(t_tol.numpy(), np.asarray(free_tol)[0])
    np.testing.assert_array_equal(t_min.numpy(), np.asarray(min_demand))
    if dedup:
        assert t_cs_k is None and cs_k is None
    else:
        assert t_cs_k.dtype == torch.int32
        np.testing.assert_array_equal(t_cs_k.numpy(), np.asarray(cs_k))


def _wave_problem(seed, uniform):
    """The shapes of tests/test_solver.py::TestWaveSolver: 32 nodes, 40
    gangs, 1–2 groups, 30% with a block-level required pack."""
    rng = np.random.default_rng(seed)
    nodes = j_make_nodes(32, capacity={"cpu": 16.0}, hosts_per_ici_block=4)
    gangs = []
    for i in range(40):
        groups = []
        for q in range(int(rng.integers(1, 3))):
            count = int(rng.integers(1, 5))
            floor = count if uniform else int(rng.integers(0, count + 1))
            groups.append({"name": f"g{i}-{q}", "demand": {"cpu": float(rng.integers(1, 5))},
                           "count": count, "min_count": floor})
        gangs.append({"name": f"g{i}", "groups": groups, "priority": 0,
                      "required_key": BLOCK_KEY if rng.random() < 0.3 else None,
                      "preferred_key": None})
    return j_build_problem(nodes, gangs, JTopology())


FIELDS = ("admitted", "retry", "new_cap", "placed", "chosen_level", "alloc", "free_after")


# every pair of option values occurs once (each case is one XLA compile)
@pytest.mark.parametrize(
    "dedup,ragged,uniform",
    [(False, False, True), (True, True, True), (False, True, False), (True, False, False)],
    ids=["nodedup-padded-uniform", "dedup-level_widths-uniform",
         "nodedup-level_widths-nonuniform", "dedup-padded-nonuniform"],
)
def test_solve_wave_chunk_matches(dedup, ragged, uniform):
    prob = _wave_problem(0 if uniform else 7, uniform)
    assert bool((prob.min_count == prob.count).all()) == uniform
    chunk = 8
    rng = np.random.default_rng(11)
    sl = slice(0, chunk)
    # pre-commit some usage so the snapshot is contended
    free = prob.capacity - rng.integers(0, 9, prob.capacity.shape).astype(np.float32)
    pending = rng.random(chunk) < 0.85
    narrow_cap = rng.integers(-1, prob.num_levels, chunk).astype(np.int32)
    # late-wave seeds: seed * 40503 wraps int32 (the full-size solve's range)
    seeds = (np.arange(chunk) + 10240 + 15 * 7919).astype(np.int32)
    args = [free, prob.topo, prob.seg_starts, prob.seg_ends, prob.demand[sl],
            prob.count[sl], prob.min_count[sl], prob.req_level[sl],
            prob.pref_level[sl], pending, narrow_cap, seeds]
    kw = {}
    if dedup:
        pdem, pcnt, pidx = dedup_demand(prob.demand, prob.count, 10**6)
        kw = {"pair_demand": pdem, "pair_count": pcnt, "pair_idx": pidx[sl]}
    widths = level_widths_of(prob) if ragged else None
    want = jp.solve_wave_chunk(
        *[jnp.asarray(a) for a in args], **{k: jnp.asarray(v) for k, v in kw.items()},
        uniform=uniform, level_widths=widths,
    )
    got = tp.solve_wave_chunk(
        *[_t(a) for a in args], **{k: _t(v) for k, v in kw.items()},
        uniform=uniform, level_widths=widths,
    )
    assert np.asarray(want["admitted"]).any()
    for field in FIELDS:
        w, g = np.asarray(want[field]), got[field].numpy()
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    # rtol: XLA fuses the score's multiply-add (module docstring)
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), rtol=1e-6, atol=0)


def test_strided_hash_wraps_like_jax():
    """h = (seed * 40503 mod 2^16) / 2^16 with the int32 product wrapping
    (full-size solves reach seeds ~130k, whose product passes 2^31)."""
    seeds = (np.arange(64) * 33331 + 10240 + 15 * 7919).astype(np.int32)
    assert (seeds.astype(np.int64) * 40503 > 2**31).any()
    want = np.asarray(
        jnp.mod(jnp.asarray(seeds) * jnp.int32(40503), 1 << 16).astype(jnp.float32) / (1 << 16)
    )
    np.testing.assert_array_equal(tp._strided_hash(_t(seeds)).numpy(), want)
    with pytest.raises(TypeError):
        tp._strided_hash(_t(seeds.astype(np.int64)))
