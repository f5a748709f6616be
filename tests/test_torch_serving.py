"""The port's serving and remediation days against the JAX package's, on
the CPU.

``sim/traffic.TrafficModel`` is a pure function of (seed, virtual time):
its demand, flash multiplier and prefill share equal the JAX model's on a
seeded grid, phase offsets included, and an offset is an exact time shift
that leaves the seeded draws untouched. ``serving_artifact`` and
``sim/remediation.remediation_day`` (remediator OFF and ON) run through
both packages' sims at a cut shape (the port's harness with
``device="cpu"``) and give equal documents less their wall fields
(``admission_p99_s``, ``p99_lt_1s``: the metrics registry's wall-clock
admission histogram); ``inert_ab``'s two cluster signatures equal the JAX
run's.
"""

import pytest
import torch

from grove_tpu.sim import remediation as jax_remediation
from grove_tpu.sim import traffic as jax_traffic
from grove_tpu_torch.sim import remediation, traffic
from tests.torch_sim_sides import sim_side

WALL_FIELDS = ("admission_p99_s", "p99_lt_1s")


def _both(run) -> list:
    out = []
    for side in (sim_side("grove_tpu"), sim_side("grove_tpu_torch", device="cpu")):
        side.reset_uid_namespace()
        side.METRICS.reset()
        side.EVENTS.reset()
        out.append(run(side, {"device": "cpu"} if side.root == "grove_tpu_torch" else {}))
    return out


class TestTrafficModel:
    @pytest.mark.parametrize("seed,tenants,offset", [
        (91, 3, 0.0), (91, 3, 437.5), (2026, 2, 200.0), (7, 5, 150.0)])
    def test_demand_equals_jax_on_a_seeded_grid(self, seed, tenants, offset):
        names = [f"t{i}" for i in range(tenants)]
        port = traffic.TrafficModel(seed, names, phase_offset=offset)
        jax = jax_traffic.TrafficModel(seed, names, phase_offset=offset)
        assert port.weights == jax.weights and port.phases == jax.phases
        assert [(c.start, c.duration, c.magnitude) for c in port.crowds] == [
            (c.start, c.duration, c.magnitude) for c in jax.crowds]
        for t in [0.0, 37.0, 299.0, 600.0, 1111.5] + [c.start + 1.0 for c in jax.crowds]:
            assert port.demand(t) == jax.demand(t), t
            assert port.flash_multiplier(t) == jax.flash_multiplier(t), t
            assert port.prefill_share(t) == jax.prefill_share(t), t

    def test_offset_is_exact_time_shift(self):
        tenants = ["t0", "t1", "t2"]
        for dx in (0.0, 150.0, 437.5):
            base = traffic.TrafficModel(91, tenants)
            shifted = traffic.TrafficModel(91, tenants, phase_offset=dx)
            for t in (0.0, 37.0, 299.0, 600.0, 1111.5):
                assert shifted.demand(t) == base.demand(t + dx), (dx, t)
                assert shifted.flash_multiplier(t) == base.flash_multiplier(t + dx)
                assert shifted.prefill_share(t) == base.prefill_share(t + dx)

    def test_default_slos_equal_jax(self):
        assert traffic.default_slos() == jax_traffic.default_slos()
        assert traffic.FAULT_NODES == jax_traffic.FAULT_NODES
        assert remediation.EFFECT_SLO == jax_remediation.EFFECT_SLO


def test_serving_artifact_equal_less_walls():
    def run(side, kw):
        doc = side.traffic.serving_artifact(seed=2026, tenants=2, num_nodes=16, duration=300.0,
                                            **kw)
        assert doc["admission_p99_s"] >= 0
        return {k: v for k, v in doc.items() if k not in WALL_FIELDS}

    jax, port = _both(run)
    assert port == jax
    assert port["fault_injected"] and port["scale_ups"] > 0


@pytest.mark.parametrize("remediate", [False, True], ids=["off", "on"])
def test_remediation_day_equal(remediate):
    jax, port = _both(lambda side, kw: side.remediation.remediation_day(
        seed=2026, remediate=remediate, tenants=3, num_nodes=24, duration=300.0, warm=False,
        **kw))
    assert port == jax
    assert port["budget_violations"] == []
    if remediate:
        assert port["ledger"]["recorded_total"] > 0


def test_inert_ab_signatures_equal():
    jax, port = _both(lambda side, kw: side.remediation.inert_ab(**kw))
    assert port == jax
    assert port[0] == port[1]


def test_serving_artifact_without_a_device_raises_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traffic.serving_artifact()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        remediation.remediation_day()
