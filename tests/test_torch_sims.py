"""The port's small sim scenarios against the JAX package's, on the CPU.

``sim/multitenant`` (the contended three-tenant run with reclaim, the
single-queue A/B, the explain scenario's actors), ``sim/voluntary`` (the
drain scenario, the breaker storm, the broker's inert A/B, the drain
artifact), ``sim/demo`` (what it prints, and its entry point with
``--device cpu``), the quota manager's ``warm`` and ``quota_snapshot``, and
``models/scenarios.run_sims_world`` (nu), each from the same YAML text and
seeds in both packages, the port on ``device="cpu"``.
"""

import numpy as np
import pytest

from grove_tpu.quota.manager import quota_snapshot as j_quota_snapshot
from grove_tpu.sim import multitenant as jm
from grove_tpu.sim import voluntary as jv
from grove_tpu_torch.models.scenarios import (
    SAMPLES_DIR,
    doc_digests,
    explain_scenario_docs,
    run_sims_world,
    sims_missing,
)
from grove_tpu_torch.quota.manager import quota_snapshot
from grove_tpu_torch.sim import demo as tdemo
from grove_tpu_torch.sim import multitenant as tm
from grove_tpu_torch.sim import voluntary as tv
from tests.torch_sim_sides import jax_demo_text, sim_side

JAX = sim_side("grove_tpu")
PORT = sim_side("grove_tpu_torch", device="cpu")
TIMES = ("order_seconds", "solver_seconds", "order_overhead_ratio")


@pytest.fixture(autouse=True)
def _fresh():
    for side in (JAX, PORT):
        side.METRICS.reset()
        side.EVENTS.reset()
        side.reset_uid_namespace()
    yield
    for side in (JAX, PORT):
        for layer in (side.TRACER, side.EVENTS, side.JOURNEYS, side.FLIGHTREC, side.TIMESERIES):
            layer.clock = None
        side.EVENTS.reset()


def test_contended_run_matches_jax():
    jh, jr = jm.run_contended()
    th, tr = tm.run_contended(device="cpu")
    assert {k: v for k, v in tr.items() if k not in TIMES} == {
        k: v for k, v in jr.items() if k not in TIMES}
    assert tr["within_one_gang"] and tr["reclaims"] > 0
    assert quota_snapshot(th.store) == j_quota_snapshot(jh.store)
    assert sorted(th.cluster.bindings.items()) == sorted(jh.cluster.bindings.items())
    assert set(tr) == set(jr)


def test_quota_warm_grows_the_padded_shape():
    h, tenants = tm.build_contended_harness((("a", 2.0, 3), ("b", 2.0, 5)), stagger=False,
                                            device="cpu")
    quota = h.scheduler.quota
    assert (quota._pad_q, quota._pad_g, quota._pad_r) == (4, 8, 1)
    quota.warm(5, 20, 3)
    assert (quota._pad_q, quota._pad_g, quota._pad_r) == (8, 32, 4)
    quota.warm(1, 1)  # pads never shrink
    assert (quota._pad_q, quota._pad_g, quota._pad_r) == (8, 32, 4)
    rows = quota_snapshot(h.store)
    assert {r["name"] for r in rows} >= {"a", "b"}
    assert all(set(r) == {"name", "parent", "defined", "deserved", "ceiling", "usage",
                          "dominantShare", "admittedGangs", "pendingGangs"} for r in rows)


def test_single_queue_ab_matches_jax():
    want, got = jm.single_queue_ab(12, 8), tm.single_queue_ab(12, 8, device="cpu")
    assert got["identical_admissions"] and got["admitted_pods"] == want["admitted_pods"] == 12
    assert set(got) == set(want)


def test_explain_scenario_matches_jax():
    jh, jrefs = jm.build_explain_scenario()
    th, trefs = tm.build_explain_scenario(device="cpu")
    assert trefs == jrefs and trefs["bridge_node"]
    got = explain_scenario_docs(th.explain, trefs)
    want = explain_scenario_docs(jh.explain, jrefs)
    assert got == want
    assert doc_digests(got) == doc_digests(want)
    assert got["explain frag"]["detail"] == "topology-fragmentation"
    assert got["explain fits"]["fits_now"] is True
    assert got["whatif drain-node"]["flipped"] is True


def test_drain_scenario_and_breaker_match_jax():
    jh, jr = jv.run_drain_scenario()
    th, tr = tv.run_drain_scenario(device="cpu")
    assert tr == jr
    assert not tr["budget_exceeded"] and tr["pre_placed"] >= 1 and tr["node_drained"]
    assert tv.run_breaker_storm(th) == jv.run_breaker_storm(jh)


def test_drain_artifact_matches_jax():
    want, got = jv.drain_artifact(), tv.drain_artifact(device="cpu")
    assert got == want and got["ok"]
    assert got["ab"]["identical_admissions"]


def test_broker_inert_ab_matches_jax():
    assert tv.inert_ab(3, 10, device="cpu") == jv.inert_ab(3, 10)


@pytest.mark.parametrize("sample", ["simple1.yaml", "agentic-pipeline.yaml"])
def test_demo_prints_what_jax_prints(sample, capsys, tmp_path):
    text = (SAMPLES_DIR / sample).read_text()
    want = jax_demo_text(text)
    assert tdemo.run_demo(text, device="cpu") == want
    path = tmp_path / sample
    path.write_text(text)
    tdemo.main([str(path), "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert want.startswith("applied ") and "virtual ticks" in want


def test_demo_on_the_card_probes_first(monkeypatch, tmp_path):
    """With no --device the demo probes the card first, and an unhealthy
    one raises (the port never falls back to the CPU)."""
    import grove_tpu_torch.utils.platform as platform

    def unhealthy(*a, **k):
        raise RuntimeError("the CUDA device is not healthy: probe failed")

    monkeypatch.setattr(platform, "ensure_healthy_backend", unhealthy)
    path = tmp_path / "m.yaml"
    path.write_text((SAMPLES_DIR / "simple1.yaml").read_text())
    with pytest.raises(RuntimeError, match="not healthy"):
        tdemo.main([str(path)])


def test_sims_world_matches_jax():
    want = run_sims_world(JAX)
    got = run_sims_world(PORT, device="cpu")
    assert set(got.pop("times")) == set(want.pop("times"))
    assert got == want
    assert sims_missing(got) == []
    assert np.isclose(got["contended"]["tenants"]["team-a"]["dominant_share"], 1.0)
