"""The port's ``sim/scale`` against the JAX package's, on the CPU.

Both packages converge the same multi-tenant population (YAML text and
names, never objects) on their own harness over a ``Store(num_shards=S)``;
the canonical dumps (``store_dump(canonical_uids=True)``, Events left out,
per-object resourceVersions dropped as ``_rv_normalized`` does) must be
equal, and so must the reconcile counts, the scalar resourceVersion, the
shard census, the pod summary and the fold tree. Then ``inert_ab`` and
``frontier_ab`` at small shapes through ``models/scenarios.run_scale_world``
(every retired harness read before release), and the report's blocks.
"""

import pytest

from grove_tpu.sim import scale as js
from grove_tpu.sim.recovery import store_dump as j_store_dump
from grove_tpu_torch.models.scenarios import dump_digest, run_scale_world
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.sim import scale as ts
from grove_tpu_torch.sim.recovery import store_dump
from tests.torch_sim_sides import sim_side

JAX = sim_side("grove_tpu")
PORT = sim_side("grove_tpu_torch", device="cpu")

DETERMINISTIC = ("sets", "nodes", "shards", "tenants", "pods", "all_ready", "reconciles",
                 "pod_summary", "fold_depth_histogram", "shard_census", "workers")


@pytest.fixture(autouse=True)
def _fresh():
    for side in (JAX, PORT):
        side.METRICS.reset()
        side.EVENTS.reset()
    yield
    for side in (JAX, PORT):
        for layer in (side.TRACER, side.EVENTS, side.JOURNEYS, side.FLIGHTREC, side.TIMESERIES):
            layer.clock = None


@pytest.mark.parametrize("num_shards", [1, 3, 8])
def test_converge_population_matches_jax(num_shards):
    jh, jr = js.converge_population(48, 32, num_shards, workers=1)
    th, tr = ts.converge_population(48, 32, num_shards, workers=1, device="cpu")
    assert {k: tr[k] for k in DETERMINISTIC} == {k: jr[k] for k in DETERMINISTIC}
    assert tr["all_ready"] and tr["pods"] == 48 * 8
    assert set(tr) >= set(jr) - {"parallel"}
    want = js._rv_normalized(j_store_dump(jh.store, canonical_uids=True, include_events=False))
    got = ts._rv_normalized(store_dump(th.store, canonical_uids=True, include_events=False))
    assert got == want
    assert dump_digest(got) == dump_digest(want)
    assert th.store.resource_version == jh.store.resource_version
    assert th.store.resource_version_vector() == jh.store.resource_version_vector()
    assert ts.census_spread_problems(tr["shard_census"], num_shards) == []
    ts._close_harness(th)
    js._close_harness(jh)


def test_frontier_converge_matches_jax():
    jh, jr = js.converge_population(48, 64, 3, frontier=True, frontier_selfcheck=True, workers=1)
    th, tr = ts.converge_population(48, 64, 3, frontier=True, frontier_selfcheck=True,
                                    workers=1, device="cpu")
    assert {k: tr[k] for k in DETERMINISTIC} == {k: jr[k] for k in DETERMINISTIC}
    from grove_tpu_torch.models.scenarios import FRONTIER_STAT_FIELDS

    assert {k: tr["frontier"][k] for k in FRONTIER_STAT_FIELDS} == {
        k: jr["frontier"][k] for k in FRONTIER_STAT_FIELDS}
    assert tr["frontier"]["subproblems_total"] > 0
    assert ts._rv_normalized(store_dump(th.store, canonical_uids=True, include_events=False)) \
        == js._rv_normalized(j_store_dump(jh.store, canonical_uids=True, include_events=False))
    ts._close_harness(th)
    js._close_harness(jh)


def test_scale_world_matches_jax():
    """frontier_ab and inert_ab at small shapes, every retired harness."""
    want = run_scale_world(JAX, (64, 64), (48, 32), 3)
    got = run_scale_world(PORT, (64, 64), (48, 32), 3, device="cpu")
    times, jtimes = got.pop("times"), want.pop("times")
    assert got == want
    assert len(got["frontier_arms"]) == 4 and len(got["inert_arms"]) == 3
    assert got["inert_ab"]["identical_content"] and got["inert_ab"]["identical_reconciles"]
    assert got["inert_ab"]["identical_rv_scalar"]
    assert got["frontier_arms"][3]["frontier"]["subproblems_total"] > 0
    assert got["frontier_arms"][2]["frontier"] is None
    assert got["spread_problems"] == []
    assert set(times["frontier_ab"]) == set(jtimes["frontier_ab"])


def test_glassbox_blocks():
    th, tr = ts.converge_population(24, 16, 3, glassbox=True, workers=1, device="cpu")
    for block in ("attribution", "admission_latency", "critical_path"):
        assert block in tr
    att = tr["attribution"]
    assert att["phases"] and 0 < att["coverage"] and "cp_coverage" in att
    from grove_tpu_torch.observability.journey import JOURNEYS
    from grove_tpu_torch.observability.profile import PROFILER

    assert not PROFILER.enabled and not JOURNEYS.enabled
    ts._close_harness(th)


def test_workers_pin():
    """workers=1 keeps the serial drain (what both A/Bs pass); more than one
    arms the parallel drain on a sharded store, and the report carries its
    per-worker block as the JAX package's does."""
    jh, jr = js.converge_population(8, 8, 3, workers=2)
    h, report = ts.converge_population(8, 8, 3, workers=2, device="cpu")
    assert report["workers"] == jr["workers"] == 2 and report["host"]["backend"] == "thread"
    assert report["parallel"]["reconciles_by_worker"] == jr["parallel"]["reconciles_by_worker"]
    assert set(report["parallel"]) == set(jr["parallel"])
    assert {k: report[k] for k in DETERMINISTIC} == {k: jr[k] for k in DETERMINISTIC}
    ts._close_harness(h)
    js._close_harness(jh)
    assert h.engine.workers is None
    h, report = ts.converge_population(8, 8, 1, workers=2, device="cpu")
    assert report["workers"] == 1 and report["host"]["backend"] == "serial"
    ts._close_harness(h)
    assert METRICS.gauges["store_shard_objects@0"] > 0
