"""The port's operator against the JAX package's, on the CPU.

Each scenario runs through both packages' own ``SimHarness`` from the same
YAML text (no object crosses: a port ``GroveError`` does not catch the JAX
store's), the port's scheduler on ``device="cpu"``. After each scenario the
two stores must agree: ``tree()``, the census and resourceVersion by kind,
the canonical digest of every kind but Events (``models/scenarios.
store_digest``: wire documents, uids as their creation rank), the bindings
and the virtual clock; each scenario also keeps the JAX test's own asserts
on the port. Mirrored: ``tests/test_controllers.py``,
``tests/test_podgang_compute.py``, ``tests/test_podgang_status_contract.py``,
``tests/test_rolling_update.py`` (with a rolling update a budget-0 set holds
through the broker, as ``tests/test_disruption.py``), the harness's wiring
of the disruption layer (a drain and node crashes in a converged harness,
as ``tests/test_disruption.py`` and ``tests/test_node_failure.py`` drive
them), a converge of each of the ten samples, and the operator world (ι)
(``run_operator_world``) cut to 128 sets on 256 nodes, every tick equal.
"""

from __future__ import annotations

import importlib
import os
import pathlib
import sys
import types

import pytest

from grove_tpu_torch.models.scenarios import (
    SAMPLE_FILES,
    operator_missing,
    run_operator_world,
    run_samples_world,
    store_census,
    store_digest,
)

REPO = pathlib.Path(__file__).resolve().parents[1]


def side_of(root: str, **harness_kw) -> types.SimpleNamespace:
    """One package's names, as ``run_operator_world`` and the scenarios
    below read them."""

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    return types.SimpleNamespace(
        root=root, mod=mod, harness_kw=harness_kw,
        SimHarness=mod("sim.harness").SimHarness,
        load_podcliquesets=mod("api.load").load_podcliquesets,
        load_podcliqueset_file=mod("api.load").load_podcliqueset_file,
        load_manifest_objects=mod("api.load").load_manifest_objects,
        OperatorConfiguration=mod("config.operator").OperatorConfiguration,
        deep_copy=mod("api.meta").deep_copy,
        reset_uid_namespace=mod("api.meta").reset_uid_namespace,
        export_object=mod("api.serialize").export_object,
        is_ready=mod("api.pod").is_ready,
        is_schedule_gated=mod("api.pod").is_schedule_gated,
        get_condition=mod("api.meta").get_condition,
        names=mod("api.names"), types=mod("api.types"),
        METRICS=mod("observability.metrics").METRICS,
        EVENTS=mod("observability.events").EVENTS,
        TRACER=mod("observability.tracing").TRACER,
        JOURNEYS=mod("observability.journey").JOURNEYS,
        FLIGHTREC=mod("observability.flightrec").FLIGHTREC,
        TIMESERIES=mod("observability.timeseries").TIMESERIES,
    )


JAX = side_of("grove_tpu")
PORT = side_of("grove_tpu_torch", device="cpu")
SIDES = (JAX, PORT)


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """The harness sets the process-global recorders' clocks (the newest
    harness wins): start and end every test from a clean slate."""
    for side in SIDES:
        side.EVENTS.reset()
        side.METRICS.reset()
    yield
    for side in SIDES:
        for layer in (side.TRACER, side.EVENTS, side.JOURNEYS, side.FLIGHTREC,
                      side.TIMESERIES):
            layer.clock = None
        side.EVENTS.reset()
        side.METRICS.reset()


def harness(side, **kw):
    return side.SimHarness(**kw, **side.harness_kw)


def sample(side, name="simple1.yaml"):
    return side.load_podcliqueset_file(str(REPO / "samples" / name))


def snapshot(side, h) -> dict:
    return {
        "tree": h.tree(),
        "resource_version": h.store.resource_version,
        "census": store_census(h.store),
        "digest": store_digest(h.store, side.export_object),
        "bindings": sorted(h.cluster.bindings.items()),
        "now": h.clock.now(),
        "events": list(h.ctx.events),
    }


def dual(scenario):
    """Run ``scenario(side) -> (harness, observation)`` on both packages;
    the stores and the observations must be equal. Returns the port's."""
    out = {}
    for side in SIDES:
        side.reset_uid_namespace()
        h, seen = scenario(side)
        out[side.root] = (snapshot(side, h), seen, h)
    (js, jseen, _), (ps, pseen, ph) = out["grove_tpu"], out["grove_tpu_torch"]
    for key in js:
        assert ps[key] == js[key], key
    assert pseen == jseen
    return ph, pseen


def all_ready(side, h) -> bool:
    pods = h.store.list("Pod")
    return bool(pods) and all(side.is_ready(p) for p in pods)


# -- tests/test_controllers.py -------------------------------------------------


class TestControllers:
    def test_simple1_tree_groups_identity_status(self):
        def run(side):
            h = harness(side, num_nodes=32)
            h.apply(sample(side))
            h.converge()
            assert all_ready(side, h) and not any(
                side.is_schedule_gated(p) for p in h.store.list("Pod"))
            gang = h.store.get("PodGang", "default", "simple1-0")
            groups = {g.name: (g.min_replicas, [r.name for r in g.pod_references])
                      for g in gang.spec.pod_groups}
            pod = h.store.get("Pod", "default", "simple1-0-frontend-0")
            env = {e["name"]: e.get("value") for e in pod.spec.containers[0].env}
            pcs = h.store.get("PodCliqueSet", "default", "simple1")
            return h, {
                "pclqs": sorted(p.metadata.name for p in h.store.list("PodClique")),
                "hpas": sorted(x.metadata.name for x in h.store.list("HorizontalPodAutoscaler")),
                "groups": groups, "env": env,
                "available": pcs.status.available_replicas,
                "gang_statuses": [g.name for g in pcs.status.pod_gang_statuses],
            }

        _, seen = dual(run)
        assert seen["pclqs"] == ["simple1-0-frontend", "simple1-0-logger",
                                 "simple1-0-workers-0-compute", "simple1-0-workers-0-prefetch"]
        assert seen["hpas"] == ["simple1-0-frontend", "simple1-0-workers"]
        assert seen["groups"]["simple1-0-frontend"][0] == 3
        assert seen["env"]["GROVE_HEADLESS_SERVICE"] == "simple1-0.default.svc.cluster.local"
        assert seen["available"] == 1 and seen["gang_statuses"] == ["simple1-0"]

    @pytest.mark.parametrize("scale", [(3,), (3, 1)])
    def test_scale_out_and_in(self, scale):
        def run(side):
            h = harness(side, num_nodes=32)
            h.apply(sample(side))
            h.converge()
            for replicas in scale:
                pcsg = h.store.get("PodCliqueScalingGroup", "default", "simple1-0-workers")
                pcsg.spec.replicas = replicas
                h.store.update(pcsg)
                h.converge()
            return h, sorted(g.metadata.name for g in h.store.list("PodGang"))

        h, gangs = dual(run)
        if scale == (3,):
            assert gangs == ["simple1-0", "simple1-0-workers-0", "simple1-0-workers-1"]
            assert len(h.store.list("Pod")) == 17 and all_ready(PORT, h)
        else:
            assert gangs == ["simple1-0"]

    def test_scaled_pods_wait_for_base_gang(self):
        def run(side):
            h = harness(side, num_nodes=2)
            for n in h.cluster.nodes:
                n.cordoned = True
            pcs = sample(side)
            pcs.spec.template.pod_clique_scaling_group_configs[0].replicas = 3
            h.apply(pcs)
            h.converge()
            gated = sorted((p.metadata.name, side.is_schedule_gated(p))
                           for p in h.store.list("Pod"))
            for n in h.cluster.nodes:
                n.cordoned = False
            h.converge()
            return h, {"gated": gated, "ready": all_ready(side, h)}

        _, seen = dual(run)
        assert seen["ready"]
        assert any(g for _, g in seen["gated"]) and not all(g for _, g in seen["gated"])

    def test_explicit_dag_order(self):
        def run(side):
            h = harness(side, num_nodes=32)
            pcs = sample(side)
            pcs.spec.template.startup_type = side.types.STARTUP_EXPLICIT
            pcs.spec.template.cliques[3].spec.starts_after = ["frontend"]
            h.apply(pcs)
            first_ready = {}
            for _ in range(30):
                h.engine.drain()
                h.schedule()
                h.cluster.kubelet_tick()
                h.engine.drain()
                for pod in h.store.list("Pod"):
                    if side.is_ready(pod) and pod.metadata.name not in first_ready:
                        first_ready[pod.metadata.name] = h.clock.now()
                h.advance(1.0)
            waiter = h.store.get("Pod", "default", "simple1-0-logger-0").spec.extra[
                "groveInitWaiter"]
            return h, {"first_ready": first_ready, "waiter": waiter}

        _, seen = dual(run)
        front = [t for n, t in seen["first_ready"].items() if "-frontend-" in n]
        logger = [t for n, t in seen["first_ready"].items() if "-logger-" in n]
        assert front and logger and max(front) < min(logger)
        assert seen["waiter"]["podcliques"] == [{"pclq": "simple1-0-frontend",
                                                 "min_available": 3}]

    def test_breach_terminates_replica_after_delay(self):
        def run(side):
            h = harness(side, num_nodes=32)
            pcs = sample(side)
            pcs.spec.template.termination_delay = 600.0
            h.apply(pcs)
            h.converge()
            h.cluster.fail_pod("default", "simple1-0-logger-0")
            h.cluster.fail_pod("default", "simple1-0-logger-1")
            h.engine.drain()
            pclq = h.store.get("PodClique", "default", "simple1-0-logger")
            cond = side.get_condition(pclq.status.conditions,
                                      side.types.COND_MIN_AVAILABLE_BREACHED)
            uid = pclq.metadata.uid
            h.advance(300.0)
            h.engine.drain()
            kept = h.store.get("PodClique", "default", "simple1-0-logger").metadata.uid == uid
            h.advance(301.0)
            h.converge()
            after = h.store.get("PodClique", "default", "simple1-0-logger").metadata.uid
            return h, {"breached": cond.is_true(), "kept": kept, "recreated": after != uid,
                       "ready": all_ready(side, h)}

        _, seen = dual(run)
        assert seen == {"breached": True, "kept": True, "recreated": True, "ready": True}

    def test_never_scheduled_not_breached_nor_available(self):
        def run(side):
            h = harness(side)
            for n in h.cluster.nodes:
                n.cordoned = True
            h.apply(sample(side))
            h.converge()
            pclq = h.store.get("PodClique", "default", "simple1-0-logger")
            cond = side.get_condition(pclq.status.conditions,
                                      side.types.COND_MIN_AVAILABLE_BREACHED)
            before = h.store.get("PodCliqueSet", "default", "simple1").status.available_replicas
            for n in h.cluster.nodes:
                n.cordoned = False
            h.converge()
            after = h.store.get("PodCliqueSet", "default", "simple1").status.available_replicas
            return h, [cond.is_true(), cond.reason, before, after]

        _, seen = dual(run)
        assert seen == [False, "InsufficientScheduledPods", 0, 1]

    def test_recreated_pod_schedules_on_tight_node(self):
        def run(side):
            h = harness(side, num_nodes=1)
            h.cluster.nodes[0].capacity = {"cpu": 0.1}
            pcs = sample(side)
            pcs.spec.template.termination_delay = 60.0
            h.apply(pcs)
            h.converge()
            h.cluster.fail_pod("default", "simple1-0-logger-0")
            h.cluster.fail_pod("default", "simple1-0-logger-1")
            h.engine.drain()
            h.advance(61.0)
            h.converge()
            return h, all_ready(side, h)

        _, ready = dual(run)
        assert ready

    def test_multinode_disaggregated_and_cascading_delete(self):
        def run(side):
            h = harness(side, num_nodes=32)
            h.apply(sample(side, "multinode-disaggregated.yaml"))
            h.converge()
            gangs = sorted(g.metadata.name for g in h.store.list("PodGang"))
            pods = len(h.store.list("Pod"))
            ready = all_ready(side, h)
            h.delete("multinode-disaggregated")
            h.converge()
            left = {k: len(h.store.list(k)) for k in (
                "PodCliqueSet", "PodClique", "PodCliqueScalingGroup", "PodGang", "Pod",
                "Service", "HorizontalPodAutoscaler")}
            return h, {"gangs": gangs, "pods": pods, "ready": ready, "left": left}

        _, seen = dual(run)
        assert seen["gangs"] == ["multinode-disaggregated-0",
                                 "multinode-disaggregated-0-prefill-0"]
        assert seen["pods"] == 13 and seen["ready"]
        assert not any(seen["left"].values())


# -- tests/test_podgang_compute.py -------------------------------------------


def _expected_gangs(side, h):
    compute = side.mod("controller.podcliqueset.components.podgang").compute_expected_podgangs
    pcs = h.store.get("PodCliqueSet", "default", "simple1")
    return sorted((g.fqn, g.base, g.base_fqn, sorted((p.fqn, p.replicas) for p in g.pclqs))
                  for g in compute(h.ctx, pcs))


class TestPodGangCompute:
    @pytest.mark.parametrize("min_available,initial,scaled", [
        (1, 2, 4), (2, 3, 6), (1, 5, 3), (2, 4, 2)])
    def test_scale_transition(self, min_available, initial, scaled):
        def run(side):
            h = harness(side, num_nodes=32)
            pcs = sample(side)
            sg = pcs.spec.template.pod_clique_scaling_group_configs[0]
            sg.min_available, sg.replicas = min_available, initial
            h.apply(pcs)
            h.converge()
            pcsg = h.store.get("PodCliqueScalingGroup", "default", "simple1-0-workers")
            pcsg.spec.replicas = scaled
            h.store.update(pcsg)
            h.engine.drain()
            return h, _expected_gangs(side, h)

        _, gangs = dual(run)
        assert len(gangs) == 1 + max(scaled - min_available, 0)

    @pytest.mark.parametrize("replicas,min_available", [(2, 1), (3, 1), (3, 2), (5, 3)])
    def test_startup_table(self, replicas, min_available):
        def run(side):
            h = harness(side, num_nodes=32)
            pcs = sample(side)
            sg = pcs.spec.template.pod_clique_scaling_group_configs[0]
            sg.replicas, sg.min_available = replicas, min_available
            h.apply(pcs)
            h.engine.drain()
            return h, _expected_gangs(side, h)

        _, gangs = dual(run)
        assert [g[0] for g in gangs if not g[1]] == [
            f"simple1-0-workers-{i}" for i in range(replicas - min_available)]

    @pytest.mark.parametrize("kind,name,replicas", [
        ("PodCliqueScalingGroup", "simple1-0-workers", 4),
        ("PodClique", "simple1-0-frontend", 5)])
    def test_live_replicas_override_template(self, kind, name, replicas):
        def run(side):
            h = harness(side, num_nodes=32)
            h.apply(sample(side))
            h.converge()
            obj = h.store.get(kind, "default", name)
            obj.spec.replicas = replicas
            h.store.update(obj)
            h.engine.drain()
            return h, _expected_gangs(side, h)

        _, gangs = dual(run)
        base = next(g for g in gangs if g[0] == "simple1-0")
        if kind == "PodClique":
            assert ("simple1-0-frontend", 5) in base[3]
        else:
            assert len(gangs) == 4

    def test_gang_creation_deferred_and_groups_sorted(self):
        def run(side):
            h = harness(side, num_nodes=32)
            h.apply(sample(side))
            h.engine.drain()
            early = h.store.get("PodGang", "default", "simple1-0") is not None
            h.converge()
            gang = h.store.get("PodGang", "default", "simple1-0")
            return h, {"early": early, "groups": [
                (g.name, g.min_replicas, [r.name for r in g.pod_references])
                for g in gang.spec.pod_groups]}

        _, seen = dual(run)
        assert sum(len(g[2]) for g in seen["groups"]) == 9
        assert all(g[2] == sorted(g[2]) for g in seen["groups"])


# -- tests/test_podgang_status_contract.py -----------------------------------


class TestPodGangStatusContract:
    def test_controller_flows_read_only_predicate_visible_fields(self, monkeypatch):
        """The port's controllers read from PodGang.status only the fields
        whose transitions ``podgang_phase_or_spec_changed`` passes."""
        controller_pkg = os.sep + os.path.join("grove_tpu_torch", "controller") + os.sep
        status_cls = PORT.types.PodGangStatus
        seen = {}
        orig = status_cls.__getattribute__

        def spy(self, name):
            if not name.startswith("__"):
                caller = sys._getframe(1).f_code.co_filename
                if controller_pkg in caller:
                    seen.setdefault(name, set()).add(os.path.basename(caller))
            return orig(self, name)

        monkeypatch.setattr(status_cls, "__getattribute__", spy)

        def run(side):
            h = harness(side, num_nodes=4)
            pcs = sample(side)
            pcs.spec.template.pod_clique_scaling_group_configs[0].replicas = 2
            h.apply(pcs)
            h.converge()
            victim = sorted(h.store.list("Pod"), key=lambda p: p.metadata.name)[0]
            h.store.delete("Pod", "default", victim.metadata.name)
            h.converge()
            pcs = h.store.get("PodCliqueSet", "default", "simple1")
            pcs.spec.template.cliques[0].spec.pod_spec.containers[0].image = "busybox:new"
            h.store.update(pcs)
            for _ in range(30):
                h.converge()
                h.advance(2.0)
                prog = h.store.get("PodCliqueSet", "default", "simple1").status.rolling_update_progress
                if prog is not None and prog.update_ended_at is not None:
                    break
            return h, None

        dual(run)
        assert seen
        assert set(seen) <= {"phase", "conditions"}, seen

    def test_predicate_passes_exactly_the_contract_fields(self):
        meta, types_ = PORT.mod("api.meta"), PORT.types
        pred = PORT.mod("controller.register").podgang_phase_or_spec_changed
        store = PORT.mod("runtime.store")

        def gang(phase="Pending", score=None, conds=(), groups=()):
            g = types_.PodGang(metadata=meta.ObjectMeta(name="g"), spec=types_.PodGangSpec(
                pod_groups=[types_.PodGroup(name=n) for n in groups]))
            g.status.phase, g.status.placement_score = phase, score
            g.status.conditions = list(conds)
            return g

        def ev(old, new):
            return store.WatchEvent(type=store.MODIFIED, kind="PodGang", obj=new, old=old)

        def sched(msg):
            return meta.Condition(type="Scheduled", status="True",
                                  reason="AllPodGroupsPlaced", message=msg)

        assert not pred(ev(gang(), gang(score=0.9)))
        assert not pred(ev(gang(conds=[sched("placement score 0.8")]),
                           gang(conds=[sched("placement score 0.9")])))
        assert pred(ev(gang(), gang(phase="Starting")))
        assert pred(ev(gang(), gang(conds=[meta.Condition(type="Unhealthy", status="True")])))
        assert pred(ev(gang(), gang(groups=("a",))))


# -- tests/test_rolling_update.py ----------------------------------------------


def converge_update(h, max_rounds=120) -> bool:
    for _ in range(max_rounds):
        h.engine.drain()
        h.schedule()
        h.cluster.kubelet_tick()
        h.engine.drain()
        progress = h.store.list("PodCliqueSet")[0].status.rolling_update_progress
        if progress is not None and progress.update_ended_at is not None:
            return True
        h.advance(2.0)
    return False


def _new_image(pcs):
    for clique in pcs.spec.template.cliques:
        clique.spec.pod_spec.containers[0].image = "busybox:new"
    return pcs


class TestRollingUpdate:
    @pytest.mark.parametrize("replicas,sg_replicas,nodes", [(1, 1, 32), (2, 1, 32), (1, 3, 64)])
    def test_image_change_replica_by_replica(self, replicas, sg_replicas, nodes):
        def run(side):
            h = harness(side, num_nodes=nodes)

            def pcs():
                p = sample(side)
                p.spec.replicas = replicas
                p.spec.template.pod_clique_scaling_group_configs[0].replicas = sg_replicas
                return p

            h.apply(pcs())
            h.converge()
            old = {p.metadata.uid for p in h.store.list("Pod")}
            h.apply(_new_image(pcs()))
            done = converge_update(h, max_rounds=240)
            h.converge()
            pods = h.store.list("Pod")
            progress = h.store.get("PodCliqueSet", "default", "simple1").status.rolling_update_progress
            sg = h.store.get("PodCliqueScalingGroup", "default", "simple1-0-workers").status
            return h, {
                "done": done, "ready": all_ready(side, h),
                "replaced": not ({p.metadata.uid for p in pods} & old),
                "images": sorted({c.image for p in pods for c in p.spec.containers}),
                "pcsgs": progress.updated_pod_clique_scaling_groups,
                "sg_updated": sg.rolling_update_progress.updated_replica_indices,
                "pcs_events": [e for e in h.ctx.events
                               if e.startswith("PodCliqueSet RollingUpdateReplica")],
            }

        _, seen = dual(run)
        assert seen["done"] and seen["ready"] and seen["replaced"]
        assert seen["images"] == ["busybox:new"]
        assert seen["sg_updated"] == list(range(sg_replicas))
        started = [e for e in seen["pcs_events"] if "Started" in e]
        assert len(started) == replicas
        if replicas == 2:  # replica 0 completed before replica 1 started
            completed = [e for e in seen["pcs_events"] if "Completed" in e]
            assert seen["pcs_events"].index(completed[0]) < seen["pcs_events"].index(started[1])

    def test_update_completes_with_zero_spare_capacity(self):
        def run(side):
            h = harness(side, num_nodes=4)
            h.apply(sample(side))
            h.converge()
            pods = h.store.list("Pod")
            usage = {n.name: {} for n in h.cluster.nodes}
            for p in pods:
                for r, q in p.spec.total_requests().items():
                    usage[p.status.node_name][r] = usage[p.status.node_name].get(r, 0.0) + q
            for n in h.cluster.nodes:
                n.capacity = dict(usage[n.name]) or {"cpu": 0.0}
            before = {p.metadata.name: p.status.node_name for p in pods}
            h.apply(_new_image(sample(side)))
            h.engine.drain()
            hint = h.store.get("PodGang", "default", "simple1-0").spec.reuse_reservation_ref
            done = converge_update(h)
            h.converge()
            after = {p.metadata.name: p.status.node_name for p in h.store.list("Pod")}
            return h, {"hint": hint is not None, "done": done, "same_nodes": after == before,
                       "ready": all_ready(side, h)}

        _, seen = dual(run)
        assert seen == {"hint": True, "done": True, "same_nodes": True, "ready": True}

    def test_availability_kept_during_update(self):
        def run(side):
            h = harness(side, num_nodes=32)
            pcs = sample(side)
            pcs.spec.template.cliques[0].spec.min_available = 2
            h.apply(pcs)
            h.converge()
            updated = _new_image(sample(side))
            updated.spec.template.cliques[0].spec.min_available = 2
            h.apply(updated)
            ready_seen = []
            for _ in range(120):
                h.engine.drain()
                h.schedule()
                h.cluster.kubelet_tick()
                h.engine.drain()
                ready_seen.append(sum(1 for p in h.store.list(
                    "Pod", "default", {side.names.LABEL_PODCLIQUE: "simple1-0-frontend"})
                    if side.is_ready(p)))
                prog = h.store.get("PodCliqueSet", "default", "simple1").status.rolling_update_progress
                if prog is not None and prog.update_ended_at is not None:
                    break
                h.advance(2.0)
            return h, ready_seen

        _, ready_seen = dual(run)
        assert min(ready_seen) >= 2

    @pytest.mark.parametrize("budget", [0, 1])
    def test_disruption_budget_gates_rolling_update(self, budget):
        """A budget-0 set holds its rolling update through the broker
        (``DisruptionThrottled``); budget 1 lets it through."""
        text = (REPO / "tests" / "test_disruption.py").read_text().split('BUDGETED_YAML = """')[1]
        text = text.split('"""')[0]

        def pcs(side):
            p = side.load_podcliquesets(text)[0]
            p.spec.replicas = 1
            p.spec.template.disruption_budget.max_unavailable_gangs = budget
            return p

        def run(side):
            h = harness(side, num_nodes=8)
            h.apply(pcs(side))
            h.converge()
            old = {p.metadata.uid for p in h.store.list("Pod")}
            h.apply(_new_image(pcs(side)))
            done = converge_update(h, max_rounds=12 if budget == 0 else 60)
            h.converge()
            kept = {p.metadata.uid for p in h.store.list("Pod")} == old
            return h, {"done": done, "kept": kept,
                       "throttled": bool(side.EVENTS.list(reason="DisruptionThrottled"))}

        _, seen = dual(run)
        if budget == 0:
            assert seen == {"done": False, "kept": True, "throttled": True}
        else:
            assert seen["done"] and not seen["kept"]


# -- the harness's wiring of the disruption layer ----------------------------

PACKED_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: packed
spec:
  replicas: 1
  template:
    topologyConstraint:
      packDomain: ici-block
    cliques:
      - name: worker
        spec:
          roleName: worker
          replicas: 3
          minAvailable: MIN
          podSpec:
            containers:
              - name: w
                image: busybox:stable
                resources:
                  requests:
                    cpu: 5
"""


class TestHarnessWiring:
    def test_drain_relocates_and_readmits(self):
        def run(side):
            h = harness(side, num_nodes=16)
            h.apply_yaml(PACKED_YAML.replace("MIN", "2"))
            h.converge()
            target = sorted(h.cluster.bindings.values())[0]
            row = h.drainer.request_drain(target)
            h.converge(max_ticks=200)
            return h, {"row": row, "state": h.drainer.drain_state(target),
                       "off": target not in set(h.cluster.bindings.values()),
                       "ready": all_ready(side, h), "drained": len(h.drainer.drained_gangs)}

        _, seen = dual(run)
        assert seen["state"] == "Drained" and seen["off"] and seen["ready"] and seen["drained"]

    @pytest.mark.parametrize("min_available", [2, 3])
    def test_node_crash_rescue_or_requeue(self, min_available):
        """Floor 2 of 3: the monitor rescues the gang in its ici-block;
        floor 3: the gang is torn down, held and re-admitted whole."""

        def run(side):
            h = harness(side, num_nodes=16)
            h.node_monitor.not_ready_after = 5.0
            h.node_monitor.lost_after = 15.0
            h.apply_yaml(PACKED_YAML.replace("MIN", str(min_available)))
            h.converge()
            victim = sorted({p.status.node_name for p in h.store.list("Pod")})[0]
            h.cluster.crash_node(victim)
            h.converge(max_ticks=200)
            return h, {"ready": all_ready(side, h),
                       "off": victim not in {p.status.node_name for p in h.store.list("Pod")},
                       "rescues": len(h.node_monitor.rescues),
                       "requeued": len(side.EVENTS.list(reason="GangRequeued"))}

        _, seen = dual(run)
        assert seen["ready"] and seen["off"]
        assert (seen["rescues"] > 0) == (min_available == 2)
        assert (seen["requeued"] > 0) == (min_available == 3)


# -- the samples and the operator world (iota) --------------------------------


def test_samples_converge_as_jax():
    """Each of the ten samples in a fresh harness: tree, census, digest and
    bindings equal (the topology sample as the harness's topology, the
    Queue sample through apply_queue)."""
    jax_out = run_samples_world(JAX)
    port_out = run_samples_world(PORT, device="cpu")
    assert sorted(port_out) == sorted(SAMPLE_FILES)
    for name in SAMPLE_FILES:
        assert port_out[name] == jax_out[name], name
    assert port_out["multitenant-queues.yaml"]["census"]["Queue"][0] == 2


def test_operator_world_cut_equals_jax():
    """(iota) cut to 128 sets on 256 nodes: every tick's (work, bound,
    started) and round summary, and after each converge the census,
    resourceVersion, reconcile counts, digest, events and bindings equal;
    every pod Ready and a rolling-update step shown."""
    jax_out = run_operator_world(JAX, 128, 256)
    port_out = run_operator_world(PORT, 128, 256, device="cpu")
    jax_out.pop("walls")
    port_out.pop("walls")
    assert port_out["apply"] == jax_out["apply"]
    for got, want in zip(port_out["converges"], jax_out["converges"]):
        assert len(got["ticks"]) == len(want["ticks"])
        for i, (g, w) in enumerate(zip(got["ticks"], want["ticks"])):
            assert g == w, i
        assert got["events"] == want["events"]
        assert got["summary"] == want["summary"]
    assert port_out == jax_out
    assert not operator_missing(port_out)


def test_bindings_index_keeps_the_scan_order():
    """``SimCluster.bindings`` indexes each node's pods: ``keys_on(node)``
    equals a scan of the whole map filtered to the node, under random binds,
    rebinds, deletes and pops (so ``node_free`` keeps the JAX package's
    order of float subtractions)."""
    import random

    from grove_tpu_torch.sim.cluster import Bindings

    rng = random.Random(7)
    got, want = Bindings({("ns", "p0"): "n0"}), {("ns", "p0"): "n0"}
    for step in range(5000):
        key, node = ("ns", f"p{rng.randrange(200)}"), f"n{rng.randrange(12)}"
        op = rng.random()
        if op < 0.6:
            got[key] = want[key] = node
        elif op < 0.8:
            assert got.pop(key, None) == want.pop(key, None)
        elif key in want:
            del got[key], want[key]
        if step % 50 == 0:
            assert list(got.items()) == list(want.items())
            for n in {f"n{i}" for i in range(12)}:
                assert got.keys_on(n) == [k for k, v in want.items() if v == n]


def test_assigned_bindings_keep_the_node_index():
    """A plain map assigned to a converged cluster's ``bindings`` becomes a
    ``Bindings``: ``node_free`` and ``node_free_each`` then give every node
    the free capacity of the JAX package's scan of the same map."""
    from grove_tpu_torch.sim.cluster import Bindings

    frees = {}
    for side in SIDES:
        side.reset_uid_namespace()
        h = harness(side)
        h.apply(sample(side))
        h.converge(max_ticks=40)
        assert all_ready(side, h)
        h.cluster.bindings = dict(reversed(list(h.cluster.bindings.items())))
        frees[side.root] = {n.name: h.cluster.node_free(n) for n in h.cluster.nodes}
        if side is PORT:
            assert isinstance(h.cluster.bindings, Bindings)
            assert h.cluster.node_free_each(h.cluster.nodes) == frees[side.root]
    assert frees["grove_tpu_torch"] == frees["grove_tpu"]
