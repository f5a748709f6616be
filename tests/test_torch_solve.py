"""The port's wave solver and sidecar solve against the JAX package's.

Problems are encoded once by the JAX package and carried across with
``problem_from_arrays``. Integer, bool and capacity results are compared
bit for bit; the PlacementScore with rtol=1e-6, atol=0, because XLA's CPU
backend fuses the score's multiply-add (see tests/test_torch_packing.py).
"""

import numpy as np
import pytest
import torch

from grove_tpu.api.topology import ClusterTopology as JTopology
from grove_tpu.cluster.grpcsolver import build_request, solve_request
from grove_tpu.models import build_stress_problem as j_build_stress_problem
from grove_tpu.sim.cluster import make_nodes as j_make_nodes
from grove_tpu.solver.encode import build_problem as j_build_problem
from grove_tpu.solver.kernel import solve_waves as j_solve_waves
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.cluster.grpcsolver import solve_decoded
from grove_tpu_torch.convert import problem_from_arrays
from grove_tpu_torch.models.scenarios import stress_gang_specs
from grove_tpu_torch.ops.fill import fill_batch
from grove_tpu_torch.sim.cluster import make_nodes
from grove_tpu_torch.solver.encode import ConstraintError, StickyGroupPad, build_problem
from grove_tpu_torch.solver.kernel import solve_waves
from tests.test_torch_encode import MEM_CAPACITY, mixed_specs

EXACT = ("admitted", "placed", "chosen_level", "alloc", "free_after")


def assert_same_result(got, want):
    for name in EXACT:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.score.dtype == want.score.dtype
    np.testing.assert_allclose(got.score, want.score, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def stress_problem():
    return j_build_stress_problem(512, 1024)


@pytest.mark.parametrize("chunk_size", [8, 32])
def test_solve_waves_stress_matches(stress_problem, chunk_size):
    want = j_solve_waves(stress_problem, chunk_size=chunk_size)
    before = fill_batch.launches
    got = solve_waves(problem_from_arrays(stress_problem), chunk_size=chunk_size, device="cpu")
    assert fill_batch.launches == before  # CPU tensors take the plain fill
    assert want.admitted.sum() > 1000
    assert_same_result(got, want)


def test_solve_waves_nonuniform_memory_matches():
    """Byte-scale memory (2^22 units per node) makes the float capacity
    prefix sums round past 2^24; the joint check's free_tol absorbs the
    association difference and every admission still matches."""
    want_problem = j_build_problem(j_make_nodes(64, MEM_CAPACITY), mixed_specs(96, seed=3), JTopology())
    want = j_solve_waves(want_problem, chunk_size=8)
    got = solve_waves(problem_from_arrays(want_problem), chunk_size=8, device="cpu")
    assert 0 < want.admitted.sum() < 96
    assert_same_result(got, want)


def test_solve_decoded_matches_sidecar_solve_request():
    specs = stress_gang_specs(300, seed=2)
    for spec in specs[::5]:  # non-uniform floors and a preferred pack level
        spec["preferred_key"] = "cloud.google.com/gke-tpu-ici-block"
        for grp in spec["groups"]:
            grp["min_count"] = max(0, grp["count"] - 1)
    capacity = {"cpu": 128.0, "tpu": 8.0}
    request = build_request(j_make_nodes(128, capacity, 8, 8), specs, JTopology())
    want = solve_request(request)
    got = solve_decoded(make_nodes(128, capacity, 8, 8), specs, ClusterTopology(), device="cpu")
    assert len(got["placements"]) == len(want.placements) == len(specs)
    assert got["solve_seconds"] > 0
    for a, b in zip(want.placements, got["placements"]):
        assert b["gang"] == a.gang and b["admitted"] == a.admitted, a.gang
        assert b["chosen_level_key"] == a.chosen_level_key, a.gang
        assert b["assignments"] == [(x.group, x.node, x.count) for x in a.assignments], a.gang
        np.testing.assert_allclose(b["placement_score"], a.placement_score, rtol=1e-6, atol=0)
    assert 0 < sum(p["admitted"] for p in got["placements"]) < len(specs)


def test_solve_waves_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problem = build_problem(make_nodes(8), stress_gang_specs(4), ClusterTopology())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_waves(problem)


@pytest.mark.parametrize(
    "change,feature",
    [
        (lambda s: s[0]["groups"][0].update(required_key="kubernetes.io/hostname"), "grouped"),
        (lambda s: s[0].update(required_key="cloud.google.com/gke-tpu-slice",
                               gang_pinned_node="node-0"), "pinned"),
        (lambda s: s[0].update(spread_key="kubernetes.io/hostname"), "spread"),
    ],
    ids=["grouped", "pinned", "spread"],
)
def test_flag_solve_waves_matches(change, feature):
    """A problem with a per-group pack, a recovery pin or a spread
    constraint solves as the JAX package solves it."""
    specs = stress_gang_specs(4)
    change(specs)
    want_problem = j_build_problem(j_make_nodes(8), specs, JTopology())
    flag_array = {"grouped": want_problem.group_req, "pinned": want_problem.gang_pin,
                  "spread": want_problem.spread_level}[feature]
    assert (flag_array >= 0).any()
    want = j_solve_waves(want_problem)
    got = solve_waves(problem_from_arrays(want_problem), device="cpu")
    assert want.admitted.any()
    assert_same_result(got, want)


def _flagged_specs():
    """One request with all three flags (on different gangs: spread and a
    per-group pack in one gang is a ConstraintError): the disaggregated
    per-group packs, the spread-serving form with survivors, and both
    recovery pins."""
    specs = stress_gang_specs(120, seed=4)
    for i, spec in enumerate(specs):
        kind = i % 4
        if kind == 0:
            for grp in spec["groups"]:
                grp["required_key"] = "cloud.google.com/gke-tpu-ici-block"
                grp["min_count"] = max(1, grp["count"] - 1)
            if i % 8 == 4:
                spec["groups"][0]["pinned_node"] = f"node-{(i * 7) % 128}"
        elif kind == 1:
            spec.update(required_key="cloud.google.com/gke-tpu-slice",
                        spread_key="cloud.google.com/gke-tpu-ici-block",
                        spread_min_domains=3, spread_required=True)
            if i % 8 == 1:
                first = (i * 8) % 128
                spec["spread_survivor_nodes"] = [f"node-{first}", f"node-{first + 1}"]
        elif kind == 2:
            spec.update(required_key="cloud.google.com/gke-tpu-slice",
                        gang_pinned_node=f"node-{(i * 13) % 128}")
    return specs


def test_solve_decoded_matches_sidecar_solve_request_with_flags():
    """A request carrying grouped, pinned and spread gangs through the
    sidecar's solve on both sides. The JAX endpoint's sticky group padding
    is process-wide, so the port's pad is set to the width it will use."""
    from grove_tpu.cluster import grpcsolver as j_grpcsolver

    specs = _flagged_specs()
    capacity = {"cpu": 128.0, "tpu": 8.0}
    request = build_request(j_make_nodes(128, capacity, 8, 8), specs, JTopology())
    width = j_grpcsolver._PAD_GROUPS.grow(specs)
    want = solve_request(request)
    pad = StickyGroupPad()
    pad.grow([{"groups": [None] * width}])
    got = solve_decoded(make_nodes(128, capacity, 8, 8), specs, ClusterTopology(),
                        device="cpu", pad_groups=pad)
    assert len(got["placements"]) == len(want.placements) == len(specs)
    for a, b in zip(want.placements, got["placements"]):
        assert b["gang"] == a.gang and b["admitted"] == a.admitted, a.gang
        assert b["chosen_level_key"] == a.chosen_level_key, a.gang
        assert b["assignments"] == [(x.group, x.node, x.count) for x in a.assignments], a.gang
        np.testing.assert_allclose(b["placement_score"], a.placement_score, rtol=1e-6, atol=0)
    admitted = [p["admitted"] for p in got["placements"]]
    for kind in range(3):  # every flag admits some of its gangs
        assert any(admitted[kind::4]), kind


def test_solve_decoded_constraint_error_surfaces():
    """Spread combined with a per-group pack is the caller's fault: the JAX
    sidecar raises its ValueError for INVALID_ARGUMENT, the port's
    solve_decoded the encoder's ConstraintError (a ValueError), same text."""
    from grove_tpu.cluster.grpcsolver import RequestDecodeError

    specs = stress_gang_specs(4)
    specs[1]["spread_key"] = "kubernetes.io/hostname"
    specs[1]["groups"][0]["required_key"] = "cloud.google.com/gke-tpu-ici-block"
    request = build_request(j_make_nodes(8), specs, JTopology())
    with pytest.raises(RequestDecodeError) as want:
        solve_request(request)
    with pytest.raises(ConstraintError) as got:
        solve_decoded(make_nodes(8), specs, ClusterTopology(), device="cpu")
    assert isinstance(got.value, ValueError)
    assert str(got.value) == str(want.value)
