"""The port's node lifecycle, node-health monitor, remediation controller,
autoscaler and runtime queue against the JAX package's, on the CPU, fed
the same documents and the same seeded operations.

- ``runtime/backoff`` and ``runtime/workqueue``: every delay, and the
  release order of a seeded stream of adds, delayed and rate-limited adds,
  forgets, discards and pops (one shard and four); ``runtime/shards``:
  ``shard_of`` and the summary fold tree.
- ``sim/cluster``: ``heartbeat_tick``, ``crash_node`` / ``restart_node``,
  ``inject_failslow`` / ``heal_failslow`` / ``failslow_lag`` /
  ``failslow_spec`` / ``failslow_names``, ``fail_node`` and ``fail_pod``:
  the same node and pod state.
- ``NodeHealthMonitor``: the grace periods (NotReady, Lost, a flap),
  rescue, terminate-and-requeue, the hold, its release, the probation
  re-arm and the release on recovery; ``hold_gang``, ``resync``,
  ``next_deadline``; the fail-slow EWMA and its hysteresis.
- ``RemediationController``: inert while disabled; a fail-slow node drained
  behind the what-if and the broker; the budget and breaker skips; the
  forecast scale-up through ``HorizontalAutoscaler.scale_target``; the
  autoscaler's own ``tick``.

Worlds and the comparison helpers are ``tests/test_torch_disruption.py``'s.
"""

import random

import numpy as np
import pytest

from grove_tpu.runtime import backoff as jax_backoff
from grove_tpu.runtime import shards as jax_shards
from grove_tpu.runtime import workqueue as jax_workqueue
from grove_tpu_torch.models.scenarios import strip_timing
from grove_tpu_torch.runtime import backoff, shards, workqueue
from tests.test_torch_disruption import (  # noqa: F401  (the autouse fixture)
    assert_same,
    both,
    create,
    fresh_globals,
    gangs_of,
    recreate,
    schedule,
    set_docs,
    state,
    step,
)

# -- the runtime queue ----------------------------------------------------------


@pytest.mark.parametrize("base,cap", [(backoff.BASE_BACKOFF, backoff.MAX_BACKOFF), (1.0, 60.0)])
def test_backoff_delays_equal_jax(base, cap):
    got = backoff.BackoffPolicy(base=base, cap=cap)
    want = jax_backoff.BackoffPolicy(base=base, cap=cap)
    for key in (("PodGang", "tenant-1", "g1-0"), ("Pod", "", "x"), "plain", 7):
        for failures in range(14):
            assert got.jitter_u(key, failures) == want.jitter_u(key, failures)
            assert got.delay(key, failures) == want.delay(key, failures)


def _queue_ops(seed, n=400):
    rng = random.Random(seed)
    keys = [("PodGang", f"ns-{rng.randrange(6)}", f"g{k}") for k in range(12)]
    now = 0.0
    ops = []
    for _ in range(n):
        now += rng.choice((0.0, 0.001, 0.01, 0.5, 1.0))
        key = rng.choice(keys)
        kind = rng.choice(("add", "add_after", "rate", "rate", "forget", "discard", "pop", "pop",
                           "pop", "empty"))
        ops.append((kind, key, now, rng.choice((0.0, 0.002, 0.3, 2.0))))
    return ops


def _drive(queue, ops):
    out = []
    for kind, key, now, delay in ops:
        if kind == "add":
            queue.add(key)
        elif kind == "add_after":
            queue.add_after(key, delay, now)
        elif kind == "rate":
            queue.add_rate_limited(key, now)
        elif kind == "forget":
            queue.forget(key)
        elif kind == "discard":
            out.append(("discard", queue.discard_delayed(key)))
        elif kind == "pop":
            out.append(("pop", queue.pop(now)))
        else:
            out.append(("empty", queue.empty(now)))
        out.append((len(queue), queue.next_delayed_at(), queue.failures(key),
                    queue.has_delayed(key)))
    return out


@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_workqueue_release_order_equals_jax(num_shards, seed):
    ops = _queue_ops(seed)
    got = _drive(workqueue.WorkQueue(base_backoff=1.0, max_backoff=60.0, num_shards=num_shards),
                 ops)
    want = _drive(jax_workqueue.WorkQueue(base_backoff=1.0, max_backoff=60.0,
                                          num_shards=num_shards), ops)
    assert got == want
    assert sum(1 for row in got if row[0] == "pop" and row[1] is not None) > 20


def test_shard_map_and_fold_tree_equal_jax():
    rng = np.random.default_rng(5)
    names = ["", "default", "tenant-0", "filler"] + [f"ns-{int(v)}" for v in
                                                     rng.integers(0, 10**6, 64)]
    for s in (1, 2, 3, 8, 16):
        assert [shards.shard_of(n, s) for n in names] == [jax_shards.shard_of(n, s) for n in names]
    for s, fan_in in ((1, 8), (16, 8), (70, 4)):
        got, want = shards.ShardSummaryTree(s, fan_in), jax_shards.ShardSummaryTree(s, fan_in)
        partials = [(int(a), int(b)) for a, b in rng.integers(0, 50, (s, 2))]
        got.refold(partials)
        want.refold(partials)
        got.update_leaf(s - 1, (7, 3))
        want.update_leaf(s - 1, (7, 3))
        assert (got.levels, got.root(), got.fold_depth_histogram(), got.depth) == (
            want.levels, want.root(), want.fold_depth_histogram(), want.depth)
    assert shards.StoreShard(3, cache_lag=False).object_count() == 0


# -- the node lifecycle -----------------------------------------------------------


def _node_rows(w):
    return [(n.name, n.state, n.cordoned, n.crashed, n.last_heartbeat, n.schedulable)
            for n in w.cluster.nodes]


def _spread_docs():
    """One pod per 8-cpu node: a set whose gang may lose one of three pods,
    a set whose gang may lose none of two."""
    return (set_docs("rescue", 1, cpu=6.0, count=3)
            + set_docs("strict", 1, cpu=6.0, count=2))


def _fix_floor(docs, gang, floor):
    for doc in docs:
        if doc["kind"] == "PodGang" and doc["metadata"]["name"] == gang:
            for group in doc["spec"]["podGroups"]:
                group["minReplicas"] = floor
    return docs


def _placed(docs, **kwargs):
    worlds = both(docs, **kwargs)
    schedule(worlds)
    return worlds


def test_heartbeats_crash_restart_and_failslow_state():
    worlds = _placed(_spread_docs(), n_nodes=6)
    for t in range(6):
        step(worlds, lambda w: w.clock.advance(1.0))
        if t == 1:
            assert step(worlds, lambda w: (w.cluster.crash_node("node-1"),
                                           w.cluster.crash_node("nope"))) == (True, False)
        if t == 2:
            assert step(worlds, lambda w: w.cluster.inject_failslow(
                "node-2", 11, lag_min=2.0, lag_max=4.5)) is True
        if t == 4:
            assert step(worlds, lambda w: w.cluster.restart_node("node-1")) is True
        step(worlds, lambda w: w.cluster.heartbeat_tick())
        assert step(worlds, _node_rows)
    assert step(worlds, lambda w: [w.cluster.failslow_lag(f"node-{k}", w.clock.now() + dt)
                                   for k in range(3) for dt in range(8)])
    assert step(worlds, lambda w: (w.cluster.failslow_spec("node-2"),
                                   sorted(w.cluster.failslow_names())))
    assert step(worlds, lambda w: (w.cluster.heal_failslow("node-2"),
                                   w.cluster.heal_failslow("node-2"))) == (True, False)
    assert_same(worlds)


def test_fail_node_and_fail_pod():
    worlds = _placed(_spread_docs(), n_nodes=6)
    assert step(worlds, lambda w: w.cluster.fail_node("node-0")) == 1
    assert step(worlds, lambda w: w.cluster.fail_node("nope")) == 0
    pod = step(worlds, lambda w: sorted(k for k in w.cluster.bindings
                                        if w.store.get("Pod", *k, readonly=True) is not None)[0])
    step(worlds, lambda w: w.cluster.fail_pod(*pod, exit_code=3))
    assert step(worlds, lambda w: (w.store.get("Pod", *pod).status.phase,
                                   [(c.name, c.ready, c.started, c.exit_code, c.restart_count)
                                    for c in w.store.get("Pod", *pod).status.container_statuses],
                                   [(c.type, c.status, c.reason)
                                    for c in w.store.get("Pod", *pod).status.conditions]))
    assert_same(worlds)


# -- the node-health monitor ---------------------------------------------------------


def _tick(worlds, advance=0.0):
    step(worlds, lambda w: w.clock.advance(advance))
    out = step(worlds, lambda w: w.monitor.tick())
    assert_same(worlds)
    return out


def test_grace_periods_and_a_flap():
    worlds = _placed(_spread_docs(), n_nodes=6)
    step(worlds, lambda w: (w.cluster.crash_node("node-4"), w.cluster.crash_node("node-5")))
    _tick(worlds, 5.0)
    assert step(worlds, lambda w: w.monitor.next_deadline()) == 10.0
    _tick(worlds, 5.0)
    assert step(worlds, lambda w: [n.state for n in w.cluster.nodes][4:]) == ["NotReady"] * 2
    step(worlds, lambda w: w.cluster.restart_node("node-5"))
    _tick(worlds, 10.0)
    assert step(worlds, lambda w: w.side.METRICS.counters.get("node_flaps_total"))
    _tick(worlds, 10.0)
    assert step(worlds, lambda w: [n.state for n in w.cluster.nodes][4:]) == ["Lost", "Ready"]
    assert step(worlds, lambda w: w.monitor.next_deadline()) > 30.0  # a requeued gang's release
    step(worlds, lambda w: w.monitor._export_gauges(w.clock.now()))
    assert step(worlds, lambda w: dict(sorted(w.side.METRICS.gauges.items())))


def _crash_both(worlds):
    """Crash one node of each gang and run the monitor to Lost."""
    nodes = step(worlds, lambda w: [
        w.cluster.bindings[(r.namespace, r.name)]
        for g in gangs_of(w) for r in g.spec.pod_groups[0].pod_references[:1]])
    step(worlds, lambda w: [w.cluster.crash_node(n) for n in nodes])
    _tick(worlds, 10.0)
    _tick(worlds, 20.0)
    return nodes


def test_rescue_requeue_hold_release_and_rearm():
    docs = _fix_floor(_spread_docs(), "rescue-0-0", 2)
    worlds = _placed(docs, n_nodes=6)
    nodes = _crash_both(worlds)
    assert step(worlds, lambda w: sorted(w.monitor._held)) == [("default", "strict-0-0")]
    assert step(worlds, lambda w: sorted(w.monitor._rescue_pending)) == [("default",
                                                                          "rescue-0-0")]
    assert step(worlds, lambda w: (w.monitor.gang_held("default", "strict-0-0"),
                                   w.monitor.holds_epoch))
    for w in worlds:
        recreate(w)
    got = schedule(worlds)  # the held gang's pods stay pending; the rescue places
    assert got["admitted"] == 1
    _tick(worlds, 2.0)  # released; the rescue is complete
    assert step(worlds, lambda w: len(w.monitor.rescues)) == 1
    assert schedule(worlds)["admitted"] == 0  # two lost nodes: no room for it
    _tick(worlds, 2.0)  # still unscheduled: re-held at the next backoff step
    assert step(worlds, lambda w: w.monitor.requeue.failures(("PodGang", "default",
                                                              "strict-0-0"))) == 2
    assert step(worlds, lambda w: w.monitor.next_deadline())
    step(worlds, lambda w: [w.cluster.restart_node(n) for n in nodes])
    _tick(worlds, 1.0)  # capacity returned: every held gang released
    assert step(worlds, lambda w: (sorted(w.monitor._held), sorted(w.monitor._probation))) == (
        [], [("default", "strict-0-0")])
    assert schedule(worlds)["admitted"] == 1


def test_hold_gang_and_resync():
    docs = _fix_floor(_spread_docs(), "rescue-0-0", 2)
    worlds = _placed(docs, n_nodes=6)
    _crash_both(worlds)
    fresh = step(worlds, lambda w: w.side.NodeHealthMonitor(w.store, w.cluster).resync())
    assert fresh >= 1
    for w in worlds:
        w.monitor = w.side.NodeHealthMonitor(w.store, w.cluster)
        w.monitor.drain_states = w.drainer.states
        w.sched.monitor = w.monitor
    assert step(worlds, lambda w: w.monitor.resync()) == fresh
    assert_same(worlds)
    step(worlds, lambda w: w.monitor.hold_gang(("default", "rescue-0-0")))
    assert step(worlds, lambda w: w.monitor.requeue.has_delayed(("PodGang", "default",
                                                                 "rescue-0-0"))) is True
    assert_same(worlds)


def test_failslow_suspicion_and_hysteresis():
    worlds = _placed(_spread_docs(), n_nodes=6,
                     monitor={"failslow_threshold": 1.5, "failslow_recover": 0.75})
    step(worlds, lambda w: w.cluster.inject_failslow("node-3", 77, lag_min=2.0, lag_max=4.5))
    scores = []
    for t in range(30):
        if t == 12:
            step(worlds, lambda w: w.cluster.heal_failslow("node-3"))
        step(worlds, lambda w: w.cluster.heartbeat_tick())
        _tick(worlds)
        scores.append(step(worlds, lambda w: dict(w.monitor._suspicion)))
        step(worlds, lambda w: w.clock.advance(1.0))
    states = [s.get("node-3", 0.0) for s in scores]
    assert max(states) > 1.5 and states[-1] < 0.75
    events = step(worlds, lambda w: [r.reason for r in w.side.EVENTS.list()
                                     if r.name == "node-3"])
    assert events == ["NodeDegraded", "NodeRecovered"]


# -- remediation and the autoscaler -----------------------------------------------------


def _remediation_world(budget):
    docs = (set_docs("calm", 3, budget={"maxUnavailableGangs": 1}, cpu=2.0)
            + set_docs("sick", 1, budget={"maxUnavailableGangs": budget}, cpu=6.0))
    worlds = _placed(docs, n_nodes=6, monitor={"failslow_threshold": 1.5})
    for w in worlds:
        w.remediator = w.side.RemediationController(
            w.store, w.cluster, w.sched, w.drainer, w.broker,
            w.side.HorizontalAutoscaler(w.store, w.side.StaticMetricsProvider()),
            w.side.ExplainEngine(w.sched))
        w.side.LEDGER.enable(clock=w.clock)
    return worlds


def _remediation_rounds(worlds, n):
    node = step(worlds, lambda w: w.cluster.bindings[
        next((r.namespace, r.name) for g in gangs_of(w) if g.metadata.name == "sick-0-0"
             for r in g.spec.pod_groups[0].pod_references)])
    step(worlds, lambda w: w.cluster.inject_failslow(node, 5, lag_min=2.0, lag_max=4.5))
    for _ in range(n):
        step(worlds, lambda w: w.clock.advance(10.0))
        step(worlds, lambda w: (w.monitor.tick(), w.drainer.tick()))
        for w in worlds:
            recreate(w)
        schedule(worlds)
        step(worlds, lambda w: (w.cluster.heartbeat_tick(), w.remediator.tick()))
        assert_same(worlds)
    return node, step(worlds, lambda w: strip_timing(w.side.LEDGER.entries()))


def test_disabled_remediator_is_inert():
    worlds = _remediation_world(1)
    step(worlds, lambda w: w.remediator.disable())
    assert step(worlds, lambda w: (w.remediator.tick(), w.remediator.next_deadline())) == (0, None)
    node, ledger = _remediation_rounds(worlds, 4)
    assert ledger == [] and step(worlds, lambda w: w.drainer.states()) == {}


def test_failslow_node_drained_by_the_remediator():
    worlds = _remediation_world(1)
    step(worlds, lambda w: w.remediator.enable() and None)
    node, ledger = _remediation_rounds(worlds, 7)
    executed = [e for e in ledger if e["outcome"] == "executed"]
    assert [(e["trigger"]["kind"], e["action"]["target"]) for e in executed] == [
        ("fail-slow", node)]
    assert executed[0]["simulation"]["flipped"] is True
    assert step(worlds, lambda w: w.drainer.states()) == {node: "Drained"}
    assert step(worlds, lambda w: w.remediator.next_deadline())


@pytest.mark.parametrize("case", ["budget", "breaker"])
def test_remediator_skips_what_it_may_not_do(case):
    worlds = _remediation_world(0 if case == "budget" else 1)
    step(worlds, lambda w: w.remediator.enable() and None)
    if case == "breaker":
        step(worlds, lambda w: (w.broker.arm(), w.broker._open(w.clock.now(), "test")))
        step(worlds, lambda w: setattr(w.broker, "close_after", 1e9))
    node, ledger = _remediation_rounds(worlds, 4)
    reasons = [e["reason"] for e in ledger]
    assert reasons and all(e["outcome"] == "skipped" for e in ledger)
    want = f"budget-denied for default/sick-0-0" if case == "budget" else "breaker-open"
    assert reasons[0] == want
    assert step(worlds, lambda w: w.drainer.states()) == {}


def _hpa_docs():
    clique = set_docs("web", 1, cpu=1.0, count=2)
    hpa = {"kind": "HorizontalPodAutoscaler", "metadata": {"name": "web", "namespace": "default"},
           "spec": {"targetKind": "PodClique", "targetName": "web-0-0-web-0-w",
                    "minReplicas": 1, "maxReplicas": 5,
                    "metrics": [{"resource": {"target": {"averageUtilization": 50}}}]}}
    return clique + [hpa]


def test_autoscaler_tick_and_scale_target():
    worlds = both(_hpa_docs())
    target = ("PodClique", "default", "web-0-0-web-0-w")
    for w in worlds:
        w.provider = w.side.StaticMetricsProvider()
        w.hpa = w.side.HorizontalAutoscaler(w.store, w.provider, scale_down_stabilization=30.0)
    for util, dt in ((100.0, 1.0), (150.0, 1.0), (10.0, 10.0), (10.0, 25.0), (None, 1.0)):
        step(worlds, lambda w: w.provider.set(*target, util) if util is not None else None)
        step(worlds, lambda w: w.clock.advance(dt))
        assert step(worlds, lambda w: (w.hpa.tick(), w.hpa.next_deadline(),
                                       w.store.get(*target).spec.replicas)) is not None
    assert step(worlds, lambda w: (w.hpa.scale_target(*target, 4), w.hpa.scale_target(*target, 4),
                                   w.hpa.scale_target("PodClique", "default", "nope", 2)))
    assert step(worlds, lambda w: list(w.hpa.scale_log))
    assert step(worlds, lambda w: dict(sorted(w.side.METRICS.gauges.items())))


def test_remediator_forecast_scale_up():
    worlds = both(_hpa_docs())
    target = ("PodClique", "default", "web-0-0-web-0-w")
    for w in worlds:
        w.hpa = w.side.HorizontalAutoscaler(w.store, w.side.StaticMetricsProvider())
        w.remediator = w.side.RemediationController(
            w.store, w.cluster, w.sched, w.drainer, w.broker, w.hpa, w.side.ExplainEngine(w.sched))
        w.remediator.enable(effect_window=5.0)
        w.remediator.add_scale_policy("queue_usage/x", 0.5, *target, max_replicas=3)
        w.side.LEDGER.enable(clock=w.clock)
    forecast = {"peak": {"mean": 0.9, "at_s": 40.0}, "model": "test", "skill": None}
    policy = step(worlds, lambda w: w.remediator._scale_policies[0])
    for dt in (0.0, 10.0, 61.0, 61.0):
        step(worlds, lambda w: w.clock.advance(dt))
        step(worlds, lambda w: w.remediator._scale_up(policy, forecast, w.clock.now()))
        step(worlds, lambda w: w.remediator._measure_effects(w.clock.now()))
    ledger = step(worlds, lambda w: strip_timing(w.side.LEDGER.entries()))
    assert [(e["outcome"], e["reason"]) for e in ledger] == [
        ("executed", ""), ("skipped", "at-max-replicas"), ("skipped", "at-max-replicas")]
    assert step(worlds, lambda w: w.store.get(*target).spec.replicas) == 3
