"""The port's chaos harness against the JAX package's, on the CPU.

Each case runs one seeded chaos scenario through both packages' own
``sim/chaos`` (the port's harnesses with ``device="cpu"``) and compares
the reports: ``run_chaos`` for seed 1234, seed 7 with the control-plane
crash (WAL recovery from a torn tail) and seed 2026 with the fail-slow
node, each ``as_dict()`` less its wall field (``recovery_wall_seconds``)
equal and free of invariant violations; the fault schedule that
``build_schedule`` draws for every seed of the chaos matrix with its arm;
and ``resource_signature``, which both packages keep in ``sim/chaos``.
"""

import random
import shutil

import pytest
import torch

from tests.torch_sim_sides import sim_side

# the chaos matrix's seeds with their arms (the sanitized seed 42 is
# tests/test_torch_sanitize.py's)
MATRIX = {1234: {}, 7: {"controlplane_crash": True}, 42: {}, 99: {"remediator": True},
          2026: {"failslow": True}}


def _both(run) -> list:
    out = []
    for side in (sim_side("grove_tpu"), sim_side("grove_tpu_torch", device="cpu")):
        side.reset_uid_namespace()
        side.METRICS.reset()
        side.EVENTS.reset()
        out.append(run(side, {"device": "cpu"} if side.root == "grove_tpu_torch" else {}))
    return out


def _report(report) -> dict:
    doc = report.as_dict()
    doc.pop("recovery_wall_seconds")
    return doc


@pytest.mark.parametrize("seed", [1234, 7, 2026])
def test_run_chaos_report_equal(seed):
    jax, port = _both(lambda side, kw: _report(side.chaos.run_chaos(seed=seed, **MATRIX[seed],
                                                                    **kw)))
    assert port == jax
    assert port["invariant_violations"] == []
    assert port["ok"]
    if seed == 7:
        assert port["recoveries"] == 1 and port["torn_tails"] == 1
    if seed == 2026:
        assert port["failslow_degraded"] >= 1 and port["failslow_recovered"] >= 1


@pytest.mark.parametrize("seed", sorted(MATRIX))
def test_build_schedule_equal(seed):
    def run(side, kw):
        runner = side.chaos.ChaosRunner(seed=seed, **MATRIX[seed], **kw)
        try:
            runner.harness.converge(max_ticks=120)
            faults = [f.as_dict() for f in runner.build_schedule(random.Random(seed))]
            return faults, runner.report.require_worker_crashes
        finally:
            runner.harness.engine.close()
            if runner.harness.durability is not None:
                runner.harness.durability.close()
            if runner._own_durability_dir:
                shutil.rmtree(runner.durability_dir, ignore_errors=True)

    jax, port = _both(run)
    assert port == jax
    kinds = {f["kind"] for f in port[0]}
    assert {"crash", "restart", "outage_begin", "drain", "leader_crash"} <= kinds
    assert ("controlplane_crash" in kinds) == bool(MATRIX[seed].get("controlplane_crash"))
    assert ("failslow_begin" in kinds) == bool(MATRIX[seed].get("failslow"))


def test_resource_signature_lives_in_chaos_and_equals_jax():
    import inspect

    from grove_tpu_torch.sim import recovery

    # one definition: the recovery round trip imports it from sim/chaos
    assert "def resource_signature" not in inspect.getsource(recovery)

    def run(side, kw):
        h = side.SimHarness(num_nodes=16, **kw)
        for pcs in side.chaos.chaos_workload(n_each=2):
            h.apply(pcs)
        h.converge(max_ticks=120)
        h.engine.close()
        return side.resource_signature(h.store)

    jax, port = _both(run)
    assert port == jax and port


def test_run_chaos_without_a_device_raises_where_cuda_is_absent(monkeypatch):
    from grove_tpu_torch.sim.chaos import run_chaos

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_chaos()
