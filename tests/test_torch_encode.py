"""The port's encoder and problem carry-over against the JAX package's."""

import dataclasses

import numpy as np
import pytest

from grove_tpu.api.topology import ClusterTopology as JTopology
from grove_tpu.models import build_stress_problem as j_build_stress_problem
from grove_tpu.models.scenarios import stress_gang_specs as j_stress_gang_specs
from grove_tpu.sim.cluster import make_nodes as j_make_nodes
from grove_tpu.solver.encode import build_problem as j_build_problem
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.convert import problem_from_arrays, problem_to_device
from grove_tpu_torch.models.scenarios import build_stress_problem, stress_gang_specs
from grove_tpu_torch.sim.cluster import make_nodes
from grove_tpu_torch.solver.encode import ConstraintError, StickyGroupPad, build_problem
from grove_tpu_torch.solver.types import PackingProblem

FIELDS = [f.name for f in dataclasses.fields(PackingProblem)]
SLICE = "cloud.google.com/gke-tpu-slice"
BLOCK = "cloud.google.com/gke-tpu-ici-block"
HOST = "kubernetes.io/hostname"


def assert_same_problem(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def mixed_specs(n_gangs, seed):
    """Non-uniform multi-group gangs with required/preferred keys and a
    byte-scale memory resource (quantized to 2^22 units per node)."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n_gangs):
        groups = []
        for q in range(int(rng.integers(1, 4))):
            count = int(rng.integers(1, 6))
            groups.append({
                "name": f"m{i}-{q}",
                "demand": {"cpu": float(rng.integers(1, 5)),
                           "memory": float(rng.integers(1, 9)) * 2**30 + 12345.0,
                           "tpu": float(rng.integers(0, 2))},
                "count": count,
                "min_count": int(rng.integers(0, count + 1)),
            })
        specs.append({"name": f"m{i}", "groups": groups, "priority": int(i % 3),
                      "required_key": [SLICE, None, None][i % 3],
                      "preferred_key": [None, BLOCK, HOST][i % 3]})
    return specs


MEM_CAPACITY = {"cpu": 16.0, "memory": 64 * 2**30, "tpu": 4.0}


def test_stress_specs_match():
    assert stress_gang_specs(300, seed=5) == j_stress_gang_specs(300, seed=5)


def test_build_problem_stress_matches():
    assert_same_problem(build_stress_problem(256, 400), j_build_stress_problem(256, 400))


def test_build_problem_keys_and_memory_matches():
    specs = mixed_specs(70, seed=3)
    got = build_problem(make_nodes(64, MEM_CAPACITY), specs, ClusterTopology())
    want = j_build_problem(j_make_nodes(64, MEM_CAPACITY), specs, JTopology())
    assert not (want.min_count == want.count).all()
    assert (want.req_level >= 0).any() and (want.pref_level >= 0).any()
    assert "memory" in want.resource_names
    assert_same_problem(got, want)


def test_build_problem_free_capacity_and_sticky_pad_match():
    nodes = make_nodes(32, MEM_CAPACITY)
    free = {f"node-{i}": {"cpu": float(i % 7), "memory": 2.0**33, "tpu": 1.0}
            for i in range(0, 32, 3)}
    pad = StickyGroupPad()
    assert pad.grow(mixed_specs(4, seed=1)) >= 1
    width = pad.grow(stress_gang_specs(5))
    assert width == 3 and pad.grow([]) == width  # sticky: never shrinks
    specs = stress_gang_specs(20, seed=2)
    got = build_problem(nodes, specs, ClusterTopology(), free_capacity=free, pad_groups=width)
    want = j_build_problem(j_make_nodes(32, MEM_CAPACITY), specs, JTopology(),
                           free_capacity=free, pad_groups=width)
    assert_same_problem(got, want)


def test_unknown_required_key_raises():
    spec = mixed_specs(1, seed=0)[0]
    spec["required_key"] = "no/such-level"
    with pytest.raises(ConstraintError):
        build_problem(make_nodes(4), [spec], ClusterTopology())


def test_problem_from_arrays_copies_with_dtypes():
    want = j_build_stress_problem(64, 40)
    for source in (want, dataclasses.asdict(want)):
        got = problem_from_arrays(source)
        assert isinstance(got, PackingProblem)
        assert_same_problem(got, want)
        assert not np.shares_memory(got.capacity, want.capacity)


def test_problem_to_device_keeps_dtypes():
    problem = build_stress_problem(64, 40)
    tensors = problem_to_device(problem, "cpu")
    for name, t in tensors.items():
        np.testing.assert_array_equal(t.numpy(), getattr(problem, name))
        assert t.numpy().dtype == getattr(problem, name).dtype
