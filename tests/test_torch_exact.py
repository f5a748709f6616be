"""The port's exact sequential greedy against the JAX package's and the oracle.

``ops.packing.gang_select_and_fill`` / ``solve_packing`` and
``solver.kernel.solve`` against ``grove_tpu``'s functions of the same
names, and against ``grove_tpu.solver.oracle.solve_oracle``. Problems are
encoded once by the JAX package and carried across with
``problem_from_arrays``. Integer, bool and capacity results are compared
bit for bit (capacity by its bits, so -0.0 and +0.0 differ); the
PlacementScore with rtol=1e-6, atol=0, because XLA's CPU backend fuses the
score's multiply-add (see tests/test_torch_packing.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.api.topology import ClusterTopology as JTopology
from grove_tpu.ops import packing as jp
from grove_tpu.sim.cluster import make_nodes as j_make_nodes
from grove_tpu.solver.encode import build_problem as j_build_problem
from grove_tpu.solver.kernel import solve as j_solve
from grove_tpu.solver.oracle import solve_oracle
from grove_tpu_torch.convert import problem_from_arrays
from grove_tpu_torch.ops import packing as tp
from grove_tpu_torch.ops.fill import fill_batch
from grove_tpu_torch.solver import kernel as tk
from tests.test_solver import BLOCK_KEY, TOPO, gang, group
from tests.test_torch_encode import MEM_CAPACITY, mixed_specs
from tests.test_torch_solve import _flagged_specs

EXACT = ("admitted", "placed", "chosen_level", "alloc")


def assert_same_exact(got, want):
    for name in EXACT:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.free_after.dtype == want.free_after.dtype
    np.testing.assert_array_equal(got.free_after.view(np.int32), want.free_after.view(np.int32))
    assert got.score.dtype == want.score.dtype
    np.testing.assert_allclose(got.score, want.score, rtol=1e-6, atol=0)


def _random_problem(seed):
    """tests/test_solver.py::TestOracleEquivalence's random problem."""
    rng = np.random.default_rng(seed)
    nodes = j_make_nodes(16, capacity={"cpu": float(rng.integers(4, 12))}, hosts_per_ici_block=4)
    gangs = []
    for i in range(12):
        groups = [
            group(f"g{i}-{p}", cpu=float(rng.integers(1, 5)), count=int(rng.integers(1, 6)),
                  min_count=None)
            for p in range(int(rng.integers(1, 4)))
        ]
        req = BLOCK_KEY if rng.random() < 0.3 else None
        for grp in groups:
            if rng.random() < 0.3:
                grp["required_key"] = BLOCK_KEY
        gangs.append(gang(f"g{i}", groups, required_key=req))
    return j_build_problem(nodes, gangs, TOPO)


def _flagged_problem():
    return j_build_problem(j_make_nodes(128, {"cpu": 128.0, "tpu": 8.0}, 8, 8),
                           _flagged_specs(), JTopology())


@pytest.mark.parametrize("with_alloc", [True, False], ids=["alloc", "stats"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_solve_matches_jax_and_oracle(seed, with_alloc):
    problem = _random_problem(seed)
    want = j_solve(problem, with_alloc=with_alloc)
    before = fill_batch.launches
    got = tk.solve(problem_from_arrays(problem), with_alloc=with_alloc, device="cpu")
    assert fill_batch.launches == before  # CPU tensors take the plain fill
    assert_same_exact(got, want)
    assert got.solve_seconds > 0
    oracle = solve_oracle(problem)
    assert list(got.admitted) == list(oracle.admitted)
    np.testing.assert_array_equal(got.placed, oracle.placed)
    np.testing.assert_allclose(got.score, oracle.score, rtol=1e-5, atol=1e-6)
    if with_alloc:
        np.testing.assert_array_equal(got.alloc, oracle.alloc.astype(got.alloc.dtype))


@pytest.fixture(scope="module")
def flagged():
    problem = _flagged_problem()
    return problem, problem_from_arrays(problem), solve_oracle(problem)


@pytest.mark.parametrize("with_alloc", [True, False], ids=["alloc", "stats"])
def test_flagged_solve_matches_jax_and_oracle(flagged, with_alloc):
    """Per-group packs, spreads with survivors and recovery pins in one
    problem. The oracle has no spread fill and places the extras of a
    grouped gang whose floor is below its count elsewhere than both
    kernels do, so it is held to the admissions only."""
    problem, port_problem, oracle = flagged
    want = j_solve(problem, with_alloc=with_alloc)
    got = tk.solve(port_problem, with_alloc=with_alloc, device="cpu")
    assert_same_exact(got, want)
    assert list(got.admitted) == list(oracle.admitted)
    assert 0 < got.admitted.sum() < len(got.admitted)


@pytest.mark.parametrize("with_alloc", [True, False], ids=["alloc", "stats"])
def test_solve_packing_matches_on_byte_scale_memory(with_alloc):
    """solve_packing itself on non-uniform gangs with byte-scale memory
    (capacity prefix sums past 2^24, so the joint check's tolerance and
    the best-fit tie-break see rounded floats)."""
    from grove_tpu.solver.kernel import level_widths_of

    problem = j_build_problem(j_make_nodes(24, MEM_CAPACITY), mixed_specs(40, 5), JTopology())
    args = (problem.capacity, problem.topo, problem.seg_starts, problem.seg_ends, problem.demand,
            problem.count, problem.min_count, problem.req_level, problem.pref_level,
            problem.group_req, problem.group_pin, problem.gang_pin)
    kw = dict(with_alloc=with_alloc, grouped=bool((problem.group_req >= 0).any()),
              uniform=False, level_widths=level_widths_of(problem))
    want = jp.solve_packing(*map(jnp.asarray, args), **kw)
    got = tp.solve_packing(*map(torch.from_numpy, args), **kw)
    assert set(got) == set(want)
    for name in ("admitted", "placed", "chosen_level", "alloc"):
        if want[name] is None:
            assert got[name] is None
            continue
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    np.testing.assert_array_equal(got["free_after"].numpy().view(np.int32),
                                  np.asarray(want["free_after"]).view(np.int32))
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), rtol=1e-6, atol=0)
    assert 0 < int(got["admitted"].sum()) < 40


@partial(jax.jit, static_argnames=("grouped", "pinned", "spread", "uniform"))
def _j_gang_step(free, topo, seg_starts, seg_ends, gang_in, grouped, pinned, spread, uniform):
    return jp.gang_select_and_fill(free, topo, seg_starts, seg_ends, gang_in, grouped=grouped,
                                   pinned=pinned, spread=spread, uniform=uniform)


def test_gang_select_and_fill_matches_step_by_step(flagged):
    """One gang's decision at a time, each against the capacity the JAX
    step before it left: free_new, alloc, placed, ok, chosen level, score.
    The L+1 candidates go through each fill call as its rows (2P one-group
    calls here, as the problem is grouped), then one spill fill."""
    problem = flagged[0]
    flags = dict(grouped=True, pinned=True, spread=True, uniform=False)
    arrays = dict(
        demand=problem.demand, count=problem.count, min_count=problem.min_count,
        req_level=problem.req_level, pref_level=problem.pref_level,
        group_req=problem.group_req, group_pin=problem.group_pin, gang_pin=problem.gang_pin,
        spread_level=problem.spread_level, spread_min=problem.spread_min,
        spread_required=problem.spread_required, spread_seed=problem.spread_seed,
    )
    node = [problem.topo, problem.seg_starts, problem.seg_ends]
    j_node = [jnp.asarray(a) for a in node]
    t_node = [torch.from_numpy(node[0])] + [torch.from_numpy(a).long() for a in node[1:]]
    calls = []

    def recording_fill(free, mask, demand, count, with_free_after=True):
        calls.append((mask.shape[0], demand.shape[1]))
        return fill_batch(free, mask, demand, count, with_free_after=with_free_after)

    free = problem.capacity
    p_dim, n_levels = problem.max_groups, problem.num_levels
    for g in range(8):
        want = _j_gang_step(jnp.asarray(free), *j_node,
                            jp.GangInputs(**{k: jnp.asarray(v[g]) for k, v in arrays.items()}),
                            **flags)
        calls.clear()
        got = tp.gang_select_and_fill(
            torch.from_numpy(free), *t_node,
            tp.GangInputs(**{k: torch.from_numpy(v[g : g + 1]) for k, v in arrays.items()}),
            fill=recording_fill, **flags)
        free_j, alloc_j, placed_j, ok_j, level_j, score_j = (np.asarray(x) for x in want)
        free_t, alloc_t, placed_t, ok_t, level_t, score_t = (x.numpy() for x in got)
        np.testing.assert_array_equal(free_t.view(np.int32), free_j.view(np.int32))
        np.testing.assert_array_equal(alloc_t[0], alloc_j)
        np.testing.assert_array_equal(placed_t[0], placed_j)
        assert ok_t[0] == ok_j and level_t[0] == level_j
        np.testing.assert_allclose(score_t[0], score_j, rtol=1e-6, atol=0)
        # 2P one-group candidate fills, each of the L+1 stacked rows, then
        # the spill fill of the one gang
        assert calls == [(n_levels + 1, 1)] * (2 * p_dim) + [(1, p_dim)]
        free = np.array(free_j)


def test_free_after_keeps_the_jax_signed_zeros():
    """Nodes with -0.0 capacity keep -0.0 through a fill of positive
    demands (a zero take debits +0.0), in every candidate, and XLA's sum of
    the candidates' one-hot products keeps it too (it drops Python's
    leading 0; a reduction from +0.0 would not): the port's capacity bits
    equal JAX's. Single-group gangs, so no padded group's -0.0 demand
    flips the zeros inside the fill instead."""
    gangs = [gang(f"g{i}", [group(f"g{i}-a", cpu=2.0, count=1 + i % 3)]) for i in range(10)]
    problem = j_build_problem(j_make_nodes(16, capacity={"cpu": 8.0}, hosts_per_ici_block=4),
                              gangs, TOPO)
    assert not np.signbit(problem.demand[: len(gangs)]).any()  # padded gangs: -0.0
    problem.capacity[::3] = -0.0
    want = j_solve(problem, with_alloc=False)
    got = tk.solve(problem_from_arrays(problem), with_alloc=False, device="cpu")
    assert_same_exact(got, want)
    assert want.admitted.any()
    assert np.signbit(want.free_after).any()  # the case is live


def test_solve_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tk.solve(problem_from_arrays(_random_problem(0)))
