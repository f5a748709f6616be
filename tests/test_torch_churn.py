"""The port's ``sim/deltachurn`` against the JAX package's, on the CPU.

The churn world (kappa) cut to 48 sets on 96 nodes: both packages converge
(iota) from the same YAML text, then run their own ``delta_artifact`` on
that harness (``models/scenarios.run_churn_world``), every schedule call's
``round_summary``, delta counters and self-check flag equal, and the
report's counters; once with the bench's 32 comparison ticks and once with
the cut the smoke runs. Then ``churn_loop`` with the A/B self-check on every
tick on a small converged harness, and ``smoke_ab_run``'s two legs (equal
to each other and to the JAX package's).
"""

import pytest

from grove_tpu.sim import deltachurn as jd
from grove_tpu_torch.models.scenarios import run_churn_world, run_operator_world
from grove_tpu_torch.sim import deltachurn as td
from tests.torch_sim_sides import sim_side

JAX = sim_side("grove_tpu")
PORT = sim_side("grove_tpu_torch", device="cpu")


@pytest.fixture(autouse=True)
def _fresh():
    for side in (JAX, PORT):
        side.METRICS.reset()
        side.EVENTS.reset()
    yield
    for side in (JAX, PORT):
        for layer in (side.TRACER, side.EVENTS, side.JOURNEYS, side.FLIGHTREC, side.TIMESERIES):
            layer.clock = None


def _churn(side, ticks, fullpath_ticks):
    kw = {"device": "cpu"} if side is PORT else {}
    rec = run_operator_world(side, 48, 96, **kw, then=lambda h: run_churn_world(
        side, h, ticks=ticks, fullpath_ticks=fullpath_ticks))
    return rec["then"]


def _same_ticks(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = dict(g), dict(w)
        gr, wr = dict(g.pop("round")), dict(w.pop("round"))
        assert gr.pop("score_sum") == pytest.approx(wr.pop("score_sum"), rel=1e-6), i
        assert (g, gr) == (w, wr), i


@pytest.mark.parametrize("ticks,fullpath_ticks", [(16, 32), (33, 8)])
def test_churn_world_matches_jax(ticks, fullpath_ticks):
    want = _churn(JAX, ticks, fullpath_ticks)
    got = _churn(PORT, ticks, fullpath_ticks)
    _same_ticks(got["ticks"], want["ticks"])
    assert got["report"] == want["report"]
    assert got["report"]["ticks"] == ticks and got["report"]["ab_ok"]
    assert got["report"]["drift_detected"] == 0
    assert got["times"]["full_path"]["ticks"] == fullpath_ticks
    assert set(got["times"]) == set(want["times"])
    # the warm-up's nine schedules, the churn's and the comparison's
    assert len(got["ticks"]) == 9 + ticks + fullpath_ticks
    assert sum(t["selfcheck"] for t in got["ticks"]) == got["report"]["ab_ticks"]
    assert all(t["delta"] is None for t in got["ticks"][-fullpath_ticks:])


def _small_harness(side):
    kw = {"device": "cpu"} if side is PORT else {}
    h = side.SimHarness(num_nodes=12, **kw)
    base = side.deltachurn._CHURN_BASE
    for i in range(6):
        pcs = side.deep_copy(base)
        pcs.metadata.name = f"seed-{i}"
        h.apply(pcs)
    h.converge(max_ticks=30)
    return h


def test_churn_loop_selfcheck_every_tick_matches_jax():
    keys = ("ticks", "seed", "ops", "spec_encodes", "reencode_fraction", "warm_start_hit_rate",
            "warm_start_hits", "solve_reuses", "full_fallbacks", "drift_detected", "ab_ticks",
            "ab_ok")
    reports, bindings = [], []
    for side, dc in ((JAX, jd), (PORT, td)):
        side.reset_uid_namespace()
        h = _small_harness(side)
        report = dc.churn_loop(h, ticks=30, seed=5, selfcheck_every=1, flap_every=7)
        reports.append({k: report[k] for k in keys})
        bindings.append(sorted(h.cluster.bindings.items()))
        assert report["ab_ticks"] == 30
    assert reports[0] == reports[1]
    assert bindings[0] == bindings[1]
    assert reports[1]["ops"]["flaps"] >= 3


def test_smoke_ab_legs_match_jax():
    legs = {}
    for name, fn, kw in (("jax", jd.smoke_ab_run, {}), ("port", td.smoke_ab_run,
                                                         {"device": "cpu"})):
        for delta in (True, False):
            legs[(name, delta)] = fn(1, delta, 24, **kw)
    assert legs[("port", True)] == legs[("port", False)]
    assert legs[("port", True)] == legs[("jax", True)]
    assert legs[("port", False)] == legs[("jax", False)]
    assert legs[("port", True)][0]


def test_percentile_is_nearest_rank():
    samples = [0.5, 0.1, 0.9, 0.3]
    for q in (0.0, 0.5, 0.99, 1.0):
        assert td._percentile(samples, q) == jd._percentile(samples, q)
    assert td._percentile([], 0.5) == 0.0
