"""The port's federation tier against the JAX package's, on the CPU.

Each case runs the same seeded scenario through both packages' own
``federation/router.FederationRouter`` (the port's regions with
``device="cpu"``), built from the same YAML text and seeds (no object
crosses packages), and compares what the routers report: the level-3 quota
fold (``GlobalQuotaFold``), the decision ledger of the seeded placement
storms, the spill decisions against the home region's explain verdicts,
the federation and partition chaos reports, ``federation_artifact`` less
its wall, ROADMAP C.7 (an explain after an ordinary spill raises
``KeyError`` in both packages at the same converge) and (psi) cut to 64
nodes a region (``models/scenarios.run_federation_world``). The one-region
router is held byte-identical to a bare port harness, as the JAX package
holds its own.
"""

import os
import random

import numpy as np
import pytest
import torch

from grove_tpu_torch.models.scenarios import run_federation_world, strip_timing
from tests.torch_sim_sides import sim_side

_TIGHT_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: job
spec:
  replicas: 1
  template:
    cliques:
      - name: worker
        spec:
          roleName: worker
          replicas: 2
          minAvailable: 2
          podSpec:
            containers:
              - name: w
                image: busybox:stable
                resources:
                  requests:
                    cpu: 6
"""


def _sides():
    return sim_side("grove_tpu"), sim_side("grove_tpu_torch", device="cpu")


def _kw(side) -> dict:
    return {"device": "cpu"} if side.root == "grove_tpu_torch" else {}


def _close(router) -> None:
    for cl in router.clusters():
        if cl.harness is not None:
            cl.harness.engine.close()


def _both(run) -> list:
    out = []
    for side in _sides():
        side.reset_uid_namespace()
        side.METRICS.reset()
        side.EVENTS.reset()
        out.append(run(side))
    return out


def tight_pcs(side, name: str, home: str):
    pcs = side.load_podcliquesets(_TIGHT_YAML)[0]
    pcs.metadata.name = name
    pcs.metadata.labels[side.router.namegen.LABEL_FEDERATION_HOME] = home
    return pcs


class TestGlobalQuotaFold:
    @pytest.mark.parametrize("clusters,fan_in", [(1, 16), (3, 16), (5, 2), (17, 4), (40, 3)])
    def test_folds_and_depths_equal(self, clusters, fan_in):
        from grove_tpu.federation.quota import GlobalQuotaFold as JaxFold
        from grove_tpu_torch.federation.quota import GlobalQuotaFold as PortFold

        rng = np.random.default_rng(clusters * 100 + fan_in)
        partials = [{f"tenant-{q}": {r: float(rng.integers(0, 64)) / 4 for r in ("cpu", "tpu")}
                     for q in range(int(rng.integers(0, 4)))} for _ in range(clusters)]
        jax, port = JaxFold(clusters, fan_in), PortFold(clusters, fan_in)
        for fold in (jax, port):
            fold.refold(partials)
        assert port.levels == jax.levels
        assert port.depth == jax.depth
        assert port.fold_depth_histogram() == jax.fold_depth_histogram()
        moved = {"tenant-9": {"cpu": 2.5}}
        jax.update_leaf(clusters - 1, moved)
        port.update_leaf(clusters - 1, moved)
        assert port.root() == jax.root()
        assert port.levels == jax.levels


class TestK1Inertness:
    def test_single_region_byte_identical_to_bare_harness(self, tmp_path):
        from grove_tpu_torch.federation import FederationRouter
        from grove_tpu_torch.runtime.clock import VirtualClock
        from grove_tpu_torch.runtime.store import Store
        from grove_tpu_torch.sim.chaos import chaos_workload
        from grove_tpu_torch.sim.harness import SimHarness
        from grove_tpu_torch.sim.parallel import _dump, durable_state_normalized

        fed_root, bare_dir = str(tmp_path / "fed"), str(tmp_path / "bare")
        router = FederationRouter(["solo"], num_nodes=8, durability_root=fed_root, device="cpu")
        bare = SimHarness(num_nodes=8, store=Store(VirtualClock(), cache_lag=True),
                          durability_dir=bare_dir, device="cpu")
        solo = router.cluster("solo").harness
        try:
            for rnd in range(2):
                for pcs_f, pcs_b in zip(chaos_workload(n_each=1), chaos_workload(n_each=1)):
                    pcs_f.metadata.name += f"-{rnd}"
                    pcs_b.metadata.name += f"-{rnd}"
                    router.apply(pcs_f)
                    bare.apply(pcs_b)
                assert router.converge(max_ticks=80) == bare.converge(max_ticks=80)
                assert _dump(solo) == _dump(bare), f"round {rnd}"
                assert solo.store.resource_version == bare.store.resource_version
            assert router.spillovers == 0
            assert durable_state_normalized(os.path.join(fed_root, "solo")) == (
                durable_state_normalized(bare_dir))
        finally:
            solo.engine.close()
            bare.engine.close()


def _storm(side, seed: int):
    """tests/test_federation.py's seeded 3-region placement storm with a
    mid-run crash and rejoin."""
    regions = ["us", "eu", "ap"]
    router = side.router.FederationRouter(
        regions, num_nodes=4, phase_offsets=[i * 200.0 for i in range(3)], spill_after=5.0,
        **_kw(side))
    rng = random.Random(seed)
    serial = 0
    try:
        for rnd in range(2):
            for _ in range(4):
                home = rng.choice(regions)
                router.apply(tight_pcs(side, f"s-{serial:02d}", home))
                serial += 1
            router.converge(max_ticks=60)
            if rnd == 0:
                victim = rng.choice(regions)
                router.crash_cluster(victim)
                router.converge(max_ticks=60)
                router.rejoin_cluster(victim)
                router.converge(max_ticks=40)
        return router.decisions(), router.placements(), router.status()
    finally:
        _close(router)


class TestRoutingDeterminism:
    @pytest.mark.parametrize("seed", [11, 22, 33])
    def test_storm_decision_ledger_equal(self, seed):
        jax, port = _both(lambda side: _storm(side, seed))
        assert port[0] == jax[0]
        assert port[1] == jax[1]
        assert port[2] == jax[2]


class TestSpilloverVerdicts:
    def test_spill_decision_matches_home_explain_verdict(self):
        def run(side):
            router = side.router.FederationRouter(["a", "b"], num_nodes=4, spill_after=5.0,
                                                  **_kw(side))
            try:
                for i in range(3):  # two fit in `a`, the third pends
                    router.apply(tight_pcs(side, f"p-{i}", "a"))
                router.converge(max_ticks=3)
                home = router.cluster("a").harness
                verdicts = {g.metadata.name: strip_timing(home.explain.explain(
                    g.metadata.namespace, g.metadata.name))
                    for g in home.store.list("PodGang") if g.metadata.name.startswith("p-")}
                router.converge(max_ticks=60)
                moved = router.explain("default", "p-2-0")
                return (router.decisions(), verdicts, router.spillovers,
                        strip_timing(moved))
            finally:
                _close(router)

        jax, port = _both(run)
        assert port == jax
        decisions, verdicts, spillovers, moved = port
        spills = [d for d in decisions if d["kind"] == "spill"]
        assert spills and spillovers == len(spills)
        for d in spills:
            pre = verdicts[f"{d['name']}-0"]
            assert pre["fits_now"] is False and d["home_verdict"]["fits_now"] is False
            assert d["home_verdict"]["detail"] == pre["detail"]
            assert d["home_verdict"]["binding_constraint"] == pre["binding_constraint"]
        pre0 = verdicts[f"{spills[0]['name']}-0"]
        assert pre0["funnel"][0]["stage"] == "cluster"
        assert "cluster a of 2" in pre0["funnel"][0]["detail"]
        assert moved["cluster"] == spills[0]["to"]


class TestFederationChaos:
    def test_federation_chaos_report_equal(self):
        jax, port = _both(lambda side: side.chaos.run_federation_chaos(4242, **_kw(side))
                          .as_dict())
        assert port == jax
        assert port["ok"] and port["invariant_violations"] == []

    def test_partition_chaos_report_equal(self):
        jax, port = _both(lambda side: side.chaos.run_partition_chaos(4242, **_kw(side))
                          .as_dict())
        assert port == jax
        assert port["ok"] and port["invariant_violations"] == []

    def test_federation_artifact_equal_less_wall(self):
        def run(side):
            doc = side.router.federation_artifact(2026, 3, 8, **_kw(side))
            assert doc.pop("wall_s") >= 0
            return doc

        jax, port = _both(run)
        assert port == jax
        assert port["crash"]["stranded"] == 0


class TestReferenceFaultC7:
    def test_explain_after_a_spill_raises_as_in_jax(self):
        """ROADMAP C.7: an ordinary spill records no ``from``, and the
        explain stage the router installs reads ``d['from']`` for every
        spill, so once the home region is lost the next spill pass raises
        ``KeyError: 'from'``. The port keeps the reference's behaviour."""
        def run(side):
            router = side.router.FederationRouter(
                ["r0", "r1", "r2"], num_nodes=64, phase_offsets=[0, 200, 400], spill_after=5.0,
                **_kw(side))
            try:
                for pcs in side.chaos.chaos_workload(n_each=32):
                    pcs.metadata.labels[side.router.namegen.LABEL_FEDERATION_HOME] = "r0"
                    router.apply(pcs)
                first = router.converge(max_ticks=40)
                spills = router.spillovers
                crash = router.crash_cluster("r0")
                with pytest.raises(KeyError) as err:
                    router.converge(max_ticks=40)
                return (first, spills, {k: len(v) for k, v in crash.items() if k != "region"},
                        err.value.args, router.decisions())
            finally:
                _close(router)

        jax, port = _both(run)
        assert port == jax
        assert port[1] == 36 and port[3] == ("from",)


class TestFederationWorld:
    def test_psi_cut_to_64_nodes_equal(self):
        """(psi) at 64 nodes a region: every step's counters, ledger
        (length, kinds, sha256 of the whole ledger), fold and global usage."""
        def run(side):
            out = run_federation_world(side, n_nodes=64, stage1_each=2, stage2_each=32,
                                       **_kw(side))
            out.pop("walls")
            return out

        jax, port = _both(run)
        assert port == jax
        assert port["stage2 converge"]["spillovers"] > port["stage2 apply"]["spillovers"]
        assert port["stage1 crash result"]["stranded"] == 0
        assert port["stage1 converge"]["foldDepthHistogram"] == [3, 1]


class TestScoreInputs:
    def test_federation_score_inputs_equal(self):
        def run(side):
            h = side.SimHarness(num_nodes=16, **_kw(side))
            for i in range(3):
                h.apply(tight_pcs(side, f"p-{i}", "a"))
            h.converge(max_ticks=40)
            out = [side.introspect.federation_score_inputs(h.scheduler, floor)
                   for floor in ({"cpu": 12.0}, {"cpu": 3.0, "tpu": 1.0}, {}, {"cpu": 500.0})]
            h.engine.close()
            return out

        jax, port = _both(run)
        assert [{k: v for k, v in d.items() if not isinstance(v, float)} for d in port] == [
            {k: v for k, v in d.items() if not isinstance(v, float)} for d in jax]
        for p, j in zip(port, jax):
            for k, v in j.items():
                if isinstance(v, float):
                    assert np.isclose(p[k], v, rtol=1e-6, atol=0), (k, p[k], v)


class TestFenceAndReasons:
    def test_federation_event_reasons_equal(self):
        from grove_tpu.observability import events as jax_events
        from grove_tpu_torch.observability import events as port_events

        for name in ("REASON_GANG_SPILLED", "REASON_CLUSTER_LOST", "REASON_CLUSTER_REJOINED",
                     "REASON_CLUSTER_PARTITIONED", "REASON_CLUSTER_HEALED"):
            assert getattr(port_events, name) == getattr(jax_events, name)

    def test_fenced_scheduler_admits_nothing_as_in_jax(self):
        def run(side):
            h = side.SimHarness(num_nodes=8, **_kw(side))
            h.scheduler.admission_fenced = True
            h.apply(tight_pcs(side, "fenced", "a"))
            side.TRACER.reset()  # spans an earlier test left behind
            side.TRACER.enable()
            try:
                ticks = h.converge(max_ticks=10)
                spans = sorted({s.name for s in side.TRACER._spans})
            finally:
                side.TRACER.disable()
                side.TRACER.reset()
            bound_fenced = len(h.cluster.bindings)
            h.scheduler.admission_fenced = False
            h.converge(max_ticks=20)
            h.engine.close()
            return ticks, "scheduler.schedule" in spans, bound_fenced, len(h.cluster.bindings)

        jax, port = _both(run)
        assert port == jax
        assert port[1] is False and port[2] == 0 and port[3] == 2


def test_router_without_a_device_raises_where_cuda_is_absent(monkeypatch):
    from grove_tpu_torch.federation import FederationRouter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederationRouter(["us", "eu"], num_nodes=4)
