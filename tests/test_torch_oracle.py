"""The port's NumPy oracle (``grove_tpu_torch/solver/oracle.py``) against the
JAX package's (``grove_tpu/solver/oracle.py``), bit for bit.

Each problem is encoded once by the JAX package and carried across with
``problem_from_arrays``; every field of the two results (admissions, pods
placed, chosen levels, allocations, the float32 scores and the remaining
capacity, by their bits) must be equal. Problems: ``tests/test_solver.py``'s
random oracle-equivalence problems, the stress mix with slice packs, the
non-uniform mix with per-group packs and byte-scale memory, and the
flagged problem (spreads, survivors, recovery pins).
"""

import numpy as np
import pytest

from grove_tpu.api.topology import ClusterTopology as JTopology
from grove_tpu.sim.cluster import make_nodes as j_make_nodes
from grove_tpu.solver.encode import build_problem as j_build_problem
from grove_tpu.solver.oracle import solve_oracle as j_solve_oracle
from grove_tpu_torch.convert import problem_from_arrays
from grove_tpu_torch.models.scenarios import stress_gang_specs
from grove_tpu_torch.solver.oracle import _fill, _level_weights, _pods_fit, solve_oracle
from tests.test_torch_encode import MEM_CAPACITY, mixed_specs
from tests.test_torch_exact import _flagged_problem, _random_problem

FIELDS = ("admitted", "placed", "chosen_level", "alloc")


def assert_same(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("score", "free_after"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=name)


@pytest.mark.parametrize("seed", range(8))
def test_random_problems_match_jax(seed):
    problem = _random_problem(seed)
    got = solve_oracle(problem_from_arrays(problem))
    assert_same(got, j_solve_oracle(problem))
    assert 0 < got.admitted.sum()


@pytest.mark.parametrize("seed", [0, 1])
def test_stress_mix_matches_jax(seed):
    problem = j_build_problem(j_make_nodes(64, {"cpu": 128.0, "tpu": 8.0}),
                              stress_gang_specs(96, seed=seed), JTopology())
    got = solve_oracle(problem_from_arrays(problem))
    assert_same(got, j_solve_oracle(problem))
    assert 0 < got.admitted.sum()


def test_nonuniform_byte_scale_memory_matches_jax():
    problem = j_build_problem(j_make_nodes(24, MEM_CAPACITY), mixed_specs(40, 5), JTopology())
    got = solve_oracle(problem_from_arrays(problem))
    assert_same(got, j_solve_oracle(problem))
    assert 0 < got.admitted.sum() < 40


def test_flagged_problem_matches_jax():
    problem = _flagged_problem()
    got = solve_oracle(problem_from_arrays(problem))
    assert_same(got, j_solve_oracle(problem))


def test_helpers_match_jax():
    from grove_tpu.solver import oracle as jo

    rng = np.random.default_rng(3)
    free = rng.integers(0, 9, size=(12, 2)).astype(np.float64)
    demand = np.array([[2.0, 0.0], [1.0, 3.0]])
    for p in range(2):
        np.testing.assert_array_equal(_pods_fit(free, demand[p]), jo._pods_fit(free, demand[p]))
    mask = rng.random(12) < 0.7
    count = np.array([5, 3])
    for a, b in zip(_fill(free, mask, demand, count), jo._fill(free, mask, demand, count)):
        np.testing.assert_array_equal(a, b)
    for levels in (1, 3, 5):
        np.testing.assert_array_equal(_level_weights(levels), jo._level_weights(levels))
