"""The JAX package's scheduler rounds for the port's check on the card.

Builds each scheduler world of ``grove_tpu_torch.models.scenarios``
(``scheduler_world``: (s) flat, (q) fair-share, (r) preemption + reclaim)
from its wire documents into a ``grove_tpu.runtime.store.Store`` and a
``grove_tpu.sim.cluster.SimCluster`` (documents decoded with
``grove_tpu.api.wire.decode_object``), with a ``VirtualClock`` frozen at 0,
and runs its rounds through the JAX ``GangScheduler`` from scratch (a bare
scheduler: no delta state, no broker, no monitor). For every round it
prints ``round_summary``: admitted gangs, bound pods, the placement score
sum, the sha256 of the sorted ``ns/pod=node`` bindings, the evicted gangs,
admitted gangs per queue and event counts by reason. ``chip_smoke.py``
holds the port's rounds on the card against these numbers (its
``JAX_SCHEDULER_REFERENCE``). Run on the CPU, one world at a time or all:

    JAX_PLATFORMS=cpu python scripts/scheduler_reference.py [s] [q] [r] [delta] [frontier] [observe] [slo] [disruption] [operator] [churn] [scale] [sims] [durability] [parallel] [cluster] [federation] [cli]

``delta`` is the churn world: (q)'s round, then its churn ticks
(``scheduler_world("delta")``, ``apply_tick`` with the JAX decoder), through
a JAX ``GangScheduler`` with ``enable_delta()`` and ``delta_selfcheck`` on
every round. Per round it also prints the delta counters, the crc32 of the
free-capacity matrix (``state_fingerprint()[2]``) and the sha256 of the
whole ``state_fingerprint()``; ``chip_smoke.py`` holds the port's delta
rounds to them (``JAX_DELTA_REFERENCE``).

``frontier`` is (phi), the partitioned frontier's world
(``scheduler_world("frontier")``: the churn world with 16 ticks) through a
JAX ``GangScheduler`` with ``enable_delta()``, ``enable_frontier()``,
``delta_selfcheck`` and ``frontier_selfcheck`` on every round. Per round it
prints what ``delta`` prints and the deterministic fields of the frontier
state's ``stats()`` (``frontier_counters``); ``chip_smoke.py`` holds the
port's frontier rounds to them (``JAX_FRONTIER_REFERENCE``).

``observe`` is (q)'s round with the glass-box layer on: the tracer, the gang
journeys and the wall profiler enabled before the world loads (so every
PodGang's ``created`` is stamped), the metrics registry reset. It prints
``observe_summary`` of the round (the span multiset, counters, gauges,
histogram counts, Prometheus series and completed journeys) and, after the
round, ``explain_burst`` through a JAX ``ExplainEngine``: every pending
gang, one scheduled gang, an unknown name, ``capacity()``, a drain what-if
and a queue what-if, each document less its timing fields as the sha256 of
its canonical JSON (``doc_digest``) beside its verdict fields.
``chip_smoke.py`` holds the port's ``[observe]`` phase to them
(``JAX_OBSERVE_REFERENCE``).

``slo`` is the SLO world (``run_slo_world``): the churn world's (q) round
and its first ``SLO_TICKS`` ticks through a JAX delta scheduler with the
tracer, journeys, time series, SLO engine, forecaster and flight recorder
on, the virtual clock moving ``SLO_STEP_S`` before each round and the
series sampled and the objectives evaluated after it. It prints every
round's ``round_summary`` with the sha256 of its series windows, then the
windows, the SLO status, the forecast and the flight bundle's summary;
``chip_smoke.py`` holds the port's ``[slo]`` phase to them
(``JAX_SLO_REFERENCE``).

``disruption`` is the disruption world (``run_disruption_world``, (omega)):
the (q) world with a PodCliqueSet and a disruption budget per gang through a
JAX delta scheduler with a disruption broker, a node-health monitor, a drain
controller and a remediator, its scripted storm, crash, drains and fail-slow
node on a virtual clock 10 s a round. It asserts that the run showed every
scripted event (``disruption_missing``) before it prints every round's
record and the nodes the script chose; ``chip_smoke.py`` holds the port's
``[disruption]`` phase to them (``JAX_DISRUPTION_REFERENCE``).

``operator`` is the operator world (``run_operator_world``, (iota)):
BASELINE's integrated population, 10,240 PodCliqueSets on 5,120 nodes,
applied to a JAX ``SimHarness`` and converged, then the rolling update of
every simple1 set and a second converge; then each of the ten samples
converged in a fresh harness (``run_samples_world``). It asserts that every
pod is Ready and a rolling-update step happened (``operator_missing``)
before it prints, per tick ``tick_once()``'s (work, bound, started) and
``round_summary`` of the tick's schedule, and per converge the store's
census, resourceVersion, reconcile counts, canonical digest, event counts
and bindings hash; ``chip_smoke.py`` holds the port's ``[operator]`` phase
to them (``JAX_OPERATOR_REFERENCE``). The controllers iterate Python sets
(the store's label index, the kubelet's not-Ready set), so the order of
commits follows the string hash: the script re-runs itself under
``PYTHONHASHSEED=0`` unless that is set, as ``chip_smoke.py`` does.
``--sets N --nodes M`` cuts the world, ``--update-every K`` (a multiple of
16) thins the rolling update.

``churn`` is the churn world (``run_churn_world``, (kappa)): the operator
world (iota) converged and rolled as ``operator`` runs it, then the JAX
``sim/deltachurn.delta_artifact`` on that harness with ``--churn-ticks``
churn ticks (96 in the bench) and ``--fullpath-ticks`` comparison ticks (32),
every schedule call recorded (``round_summary``, the delta counters, the
self-check flag) beside the artifact's report less its times.
``chip_smoke.py`` holds the port's ``[churn]`` phase to it
(``JAX_CHURN_REFERENCE``). ``--sets N --nodes M`` cuts (iota) as for
``operator``.

``scale`` is the sharded A/Bs (``run_scale_world``, (lambda)): the JAX
``sim/scale.frontier_ab`` at ``--frontier-shape SETS NODES`` (4,096 sets on
6,400 nodes: the bench's full-size shape) and ``inert_ab`` at
``--inert-shape SETS NODES`` (192 on 64), both at ``--shards`` (8); every
retired harness is read before it is released (the canonical dump's
digest, census, scalar resourceVersion, reconciles, frontier counters).
``chip_smoke.py``'s ``[scale]`` holds the port to it
(``JAX_SCALE_REFERENCE``).

``sims`` is the small scenarios (``run_sims_world``, (nu)) at the JAX
package's own shapes: the contended quota run, the single-queue A/B, the
explain scenario's documents, the drain artifact, the run-level churn A/B
and the demo on simple1.yaml. ``chip_smoke.py``'s ``[sims]`` holds the port
to it (``JAX_SIMS_REFERENCE``).

``durability`` is (pi) (``run_parallel_world``): the JAX
``sim/scale.converge_population`` at (lambda)'s frontier shape (4,096 sets on
6,400 nodes, 8 shards; ``--frontier-shape`` and ``--shards`` cut it) with the
frontier, the glass-box layer, 4 workers of the process drain
(``GROVE_TPU_CP_BACKEND=process``) and a per-shard WAL attached before the
first commit; then the crash with a torn tail, ``recover_store``, the
acked-prefix audit and a cold restart with the same drain; and the JAX
``sim/parallel.process_codec_ab`` at its own shape (reconciles only). It
asserts that nothing went wrong before it prints the converge's report less
its times, the canonical dump's digest, the per-shard WAL summaries, the
overlap counters and the crash's record. ``parallel`` is the parallel-drain
scenarios (``run_parallel_suite``) at the JAX package's own shapes: the
serial-twin ``parallel_ab`` with per-shard WALs for both backends, workers 2
and 4, seeds 1234 and 7; the worker crash; a boundary-fault run; the worker
sweeps (``--sweep-counts``) and ``durability_artifact``, each less its
times. ``chip_smoke.py`` holds the port's ``[scale]`` and ``[parallel]`` to
them (``JAX_PARALLEL_REFERENCE``).

``cluster`` is the real-cluster world (``run_cluster_world``, (tau)): the
JAX ``cluster/manager.start_operator`` with its TLS webhooks and the
authorizer on 5,120 nodes (``--nodes`` cuts them) under deploy/operator.yaml's
configuration, the first ``--sets`` sets of (iota)'s population (the
world's K, ``CLUSTER_SETS``, by default) POSTed to its apiserver as JSON and
converged over HTTP. It runs the world twice and prints, from the first
run, the census by kind, the gangs by phase, the pods, the ``GET /events``
records by reason and the bindings' sha256, and whether the second run's
bindings repeated it (``bindings_repeat``); its CPU walls go to stderr.
``chip_smoke.py``'s ``[cluster]`` holds the port to it
(``JAX_CLUSTER_REFERENCE``).

``federation`` is the serving, chaos and federation worlds through the JAX
package's ``sim/traffic``, ``sim/remediation``, ``sim/chaos`` and
``federation/router``: (mu) ``run_serving_world`` (``serving_artifact`` at
the bench's shape (2026, 2, 16, 900) and ``remediation_artifact`` at (2026,
3, 24, 1200)), (chi) ``run_chaos_matrix`` (seeds 1234, 7 with the
control-plane crash, 42 sanitized, 99 with the remediator, 2026 with
fail-slow, seed 7 again on a 3-shard store, seed 1234 on 3 shards through 2
process workers, the federation and partition chaos of seed 4242 and
``federation_artifact(2026, 3, 8)``) and (psi) ``run_federation_world``
(three regions of ``--nodes`` nodes, 5,120 by default, stage 1
``--stage1-each`` and stage 2 ``--stage2-each`` sets a shape, stage 2
converged for ``models/scenarios.FEDERATION_STAGE2_TICKS`` ticks).
``--federation-worlds`` picks among ``mu chi psi``. It asserts that every
chaos verdict is ok and that stage 2 spilled, prints each world's CPU wall
to stderr, and prints the reports less their walls; ``chip_smoke.py``'s ``[federation]`` holds the
port to them (``JAX_FEDERATION_REFERENCE``).

``cli`` is the command line (``models/scenarios.run_cli_sim`` and
``run_cli_live``): the JAX ``grove_tpu.cli`` as users run it, each command a
process of its own from the repository root on the CPU, at ``--nodes``
(5,120 by default, ``CLI_NODES``). Sim mode: every sim-backed subcommand
over ``samples/`` and the host-only ones (``cli_sim_commands``). Live mode:
``run --tls --authorizer`` as a child, then apply, get, tree, describe,
scale, nodes, drain, uncordon, queues, explain, whatif, capacity, trace,
profile, journey and delete with ``--apiserver``, the initc waiter for the
gang ``simple1-0`` and SIGINT; live mode runs twice. It asserts that every
command exits 0 and prints, for each, its exit code and the sha256 and
line count of its stdout less the uid's token, the apiserver's address and
(trace, profile, journey) the durations (``cli_digest``); a live command
keeps its exit code only unless it is one of ``CLI_LIVE_STDOUT`` and the
second run repeated its digest.
``chip_smoke.py``'s ``[cli]`` holds the port to it (``JAX_CLI_REFERENCE``).

``operator``, ``churn``, ``scale``, ``sims``, ``durability``, ``parallel``,
``cluster``, ``federation`` and ``cli`` re-run the script under
``PYTHONHASHSEED=0`` unless that is set. A world can be cut for a quick
look: ``--nodes N --gangs G`` (and ``--ticks T --seed S`` for ``delta``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from grove_tpu.api.topology import ClusterTopology  # noqa: E402
from grove_tpu.api.wire import decode_object  # noqa: E402
from grove_tpu.observability import forecast, timeseries  # noqa: E402
from grove_tpu.observability.events import EVENTS  # noqa: E402
from grove_tpu.observability.explain import ExplainEngine  # noqa: E402
from grove_tpu.observability.flightrec import FLIGHTREC, load_bundle  # noqa: E402
from grove_tpu.observability.journey import JOURNEYS  # noqa: E402
from grove_tpu.observability.ledger import LEDGER  # noqa: E402
from grove_tpu.observability.metrics import METRICS  # noqa: E402
from grove_tpu.observability.profile import PROFILER  # noqa: E402
from grove_tpu.observability.slo import SLO, SloSpec  # noqa: E402
from grove_tpu.observability.tracing import TRACER  # noqa: E402
from grove_tpu.runtime.clock import VirtualClock  # noqa: E402
from grove_tpu.runtime.store import Store  # noqa: E402
from grove_tpu.sim.cluster import SimCluster, make_nodes  # noqa: E402
from grove_tpu.solver.scheduler import GangScheduler  # noqa: E402
from grove_tpu.autoscale.hpa import HorizontalAutoscaler, StaticMetricsProvider  # noqa: E402
from grove_tpu.controller.nodehealth import NodeHealthMonitor  # noqa: E402
from grove_tpu.controller.remediate import RemediationController  # noqa: E402
from grove_tpu.disruption import DisruptionBroker, NodeDrainController  # noqa: E402
from grove_tpu.api import meta as jax_meta  # noqa: E402
from grove_tpu.api.load import load_manifest_objects, load_podcliquesets  # noqa: E402
from grove_tpu.api.pod import is_ready  # noqa: E402
from grove_tpu.api.serialize import export_object  # noqa: E402
from grove_tpu.config.operator import OperatorConfiguration  # noqa: E402
from grove_tpu.sim.harness import SimHarness  # noqa: E402
from tests.torch_sim_sides import sim_side  # noqa: E402
from grove_tpu_torch.models.scenarios import (  # noqa: E402
    CLI_LIVE_STDOUT,
    CLI_NODES,
    CLUSTER_CONFIG_YAML,
    CHURN_FULLPATH_TICKS,
    CHURN_TICKS,
    FEDERATION_STAGE1_EACH,
    FEDERATION_STAGE2_EACH,
    SCALE_FRONTIER_SHAPE,
    SCALE_INERT_SHAPE,
    SCALE_SHARDS,
    PARALLEL_SWEEP_COUNTS,
    EventCapture,
    apply_tick,
    delta_counters,
    disruption_missing,
    doc_digests,
    explain_burst,
    frontier_counters,
    observe_summary,
    operator_missing,
    parallel_missing,
    round_summary,
    run_disruption_world,
    run_operator_world,
    run_parallel_suite,
    run_parallel_world,
    run_samples_world,
    run_churn_world,
    run_chaos_matrix,
    run_cluster_world,
    run_federation_world,
    run_scale_world,
    run_serving_world,
    run_sims_world,
    run_slo_world,
    scheduler_world,
    sims_missing,
    chaos_missing,
    cli_digest,
    cli_sim_commands,
    run_cli_live,
    run_cli_sim,
)


def run_world(name: str, n_nodes=None, n_gangs=None) -> list:
    world = scheduler_world(name, n_nodes, n_gangs)
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store=store, nodes=make_nodes(*world["nodes"]))
    scheduler = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"])
    assert scheduler.delta is None and scheduler.broker is None and scheduler.monitor is None
    for doc in world["queues"]:
        store.create(decode_object(doc))
    rounds = []
    for docs in world["rounds"]:
        for doc in docs:
            store.create(decode_object(doc))
        t0 = time.perf_counter()
        with EventCapture(EVENTS) as cap:
            scheduler.schedule_pending()
        summary = round_summary(store, cluster, cap.events)
        summary["seconds"] = time.perf_counter() - t0
        print(f"[{name}] round {len(rounds) + 1}: {json.dumps(summary)}", file=sys.stderr,
              flush=True)
        rounds.append(summary)
    return rounds


def delta_state(delta) -> dict:
    """The delta counters, the free matrix's crc32 and the sha256 of the
    whole state fingerprint after a round."""
    fp = delta.state_fingerprint()
    return {"counters": delta_counters(delta), "free_crc": fp[2],
            "state_sha256": hashlib.sha256(repr(fp).encode()).hexdigest()}


def run_delta(n_nodes=None, n_gangs=None, ticks=None, seed=0, frontier=False) -> list:
    name = "frontier" if frontier else "delta"
    world = scheduler_world(name, n_nodes, n_gangs, ticks, seed)
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store=store, nodes=make_nodes(*world["nodes"]))
    scheduler = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"])
    assert scheduler.enable_delta()
    scheduler.delta_selfcheck = True
    if frontier:
        assert scheduler.enable_frontier()
        scheduler.frontier_selfcheck = True
    for doc in world["queues"] + world["rounds"][0]:
        store.create(decode_object(doc))
    rounds = []
    for tick in [None] + world["ticks"]:
        if tick:
            apply_tick(store, cluster, tick, decode_object)
        t0 = time.perf_counter()
        with EventCapture(EVENTS) as cap:
            scheduler.schedule_pending()
        summary = round_summary(store, cluster, cap.events)
        summary.update(delta_state(scheduler.delta))
        if frontier:
            summary["frontier"] = frontier_counters(scheduler.frontier)
        summary["seconds"] = time.perf_counter() - t0
        print(f"[{name}] round {len(rounds) + 1}: {json.dumps(summary)}", file=sys.stderr,
              flush=True)
        rounds.append(summary)
    return rounds


def run_observe(n_nodes=None, n_gangs=None) -> dict:
    world = scheduler_world("q", n_nodes, n_gangs)
    for layer in (TRACER, JOURNEYS, PROFILER):
        layer.reset()
        layer.enable()
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store=store, nodes=make_nodes(*world["nodes"]))
    scheduler = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"])
    for doc in world["queues"] + world["rounds"][0]:
        store.create(decode_object(doc))
    TRACER.reset()
    PROFILER.reset()
    METRICS.reset()
    t0 = time.perf_counter()
    with EventCapture(EVENTS) as cap:
        scheduler.schedule_pending()
    seconds = time.perf_counter() - t0
    summary = observe_summary(TRACER, METRICS, JOURNEYS)
    for layer in (TRACER, JOURNEYS, PROFILER):
        layer.disable()
    burst = explain_burst(ExplainEngine(scheduler), store, cluster)
    print(f"[observe] round {seconds:.3f} s, explain burst {time.perf_counter() - t0 - seconds:.3f}"
          f" s: {json.dumps(round_summary(store, cluster, cap.events))}", file=sys.stderr,
          flush=True)
    return {"summary": summary, "explain": doc_digests(burst)}


def run_slo(n_nodes=None, n_gangs=None, ticks=None, seed=0) -> dict:
    pkg = types.SimpleNamespace(
        Store=Store, VirtualClock=VirtualClock, SimCluster=SimCluster, make_nodes=make_nodes,
        GangScheduler=GangScheduler, ClusterTopology=ClusterTopology,
        decode_object=decode_object, EVENTS=EVENTS, METRICS=METRICS, TRACER=TRACER,
        JOURNEYS=JOURNEYS, TIMESERIES=timeseries.TIMESERIES, SLO=SLO, SloSpec=SloSpec,
        FORECASTER=forecast.FORECASTER, FLIGHTREC=FLIGHTREC,
        install_serving_collector=timeseries.install_serving_collector, load_bundle=load_bundle)

    def after(index, wall_s, observe_s, summary):
        print(f"[slo] round {index + 1} ({wall_s:.3f} s, observatory {observe_s:.3f} s):"
              f" {json.dumps(summary)}", file=sys.stderr, flush=True)

    with tempfile.TemporaryDirectory() as out_dir:
        return run_slo_world(pkg, n_nodes, n_gangs, ticks, seed, out_dir=out_dir,
                             after_round=after)


def run_disruption(n_nodes=None, n_gangs=None, seed=0) -> dict:
    pkg = types.SimpleNamespace(
        Store=Store, VirtualClock=VirtualClock, SimCluster=SimCluster, make_nodes=make_nodes,
        GangScheduler=GangScheduler, ClusterTopology=ClusterTopology,
        decode_object=decode_object, EVENTS=EVENTS, METRICS=METRICS, LEDGER=LEDGER,
        DisruptionBroker=DisruptionBroker, NodeDrainController=NodeDrainController,
        NodeHealthMonitor=NodeHealthMonitor, RemediationController=RemediationController,
        HorizontalAutoscaler=HorizontalAutoscaler, StaticMetricsProvider=StaticMetricsProvider,
        ExplainEngine=ExplainEngine)

    def after(index, walls, record):
        print(f"[disruption] round {index + 1} ({walls['round_s']:.3f} s, schedule"
              f" {walls['schedule_s']:.3f} s): {json.dumps(record['script'])}"
              f" {json.dumps(record['events_by_reason'])}", file=sys.stderr, flush=True)

    out = run_disruption_world(pkg, n_nodes, n_gangs, seed, after_round=after)
    missing = disruption_missing(out)
    assert not missing, f"the disruption world did not show: {missing}"
    return out


HASHED_WORLDS = ("operator", "churn", "scale", "sims", "durability", "parallel", "cluster",
                 "federation", "cli")


def name_needs_seed() -> bool:
    """True when a world that runs the controllers is asked for and the
    string hash is not pinned to seed 0 (see the module docstring)."""
    return (any(w in sys.argv[1:] for w in HASHED_WORLDS)
            and os.environ.get("PYTHONHASHSEED") != "0")


def run_operator(n_sets=None, n_nodes=None, update_every=None) -> dict:
    pkg = types.SimpleNamespace(
        SimHarness=SimHarness, load_podcliquesets=load_podcliquesets,
        load_manifest_objects=load_manifest_objects,
        OperatorConfiguration=OperatorConfiguration, deep_copy=jax_meta.deep_copy,
        reset_uid_namespace=jax_meta.reset_uid_namespace, export_object=export_object,
        is_ready=is_ready, METRICS=METRICS, EVENTS=EVENTS, TRACER=TRACER, JOURNEYS=JOURNEYS,
        FLIGHTREC=FLIGHTREC, TIMESERIES=timeseries.TIMESERIES)

    def after(step, index, wall_s, tick):
        print(f"[operator] {step} tick {index} ({wall_s:.3f} s): work {tick['work']} bound"
              f" {tick['bound']} started {tick['started']}"
              f" {json.dumps(tick['round']['events_by_reason'])}", file=sys.stderr, flush=True)

    out = run_operator_world(pkg, n_sets, n_nodes, update_every, after_tick=after)
    missing = operator_missing(out)
    assert not missing, f"the operator world did not show: {missing}"
    print(f"[operator] walls {json.dumps(out.pop('walls'))}", file=sys.stderr, flush=True)
    out["samples"] = run_samples_world(pkg)
    return out


def run_churn(n_sets=None, n_nodes=None, update_every=None, ticks=CHURN_TICKS,
              fullpath_ticks=CHURN_FULLPATH_TICKS) -> dict:
    side = sim_side("grove_tpu")

    def after(index, wall_s, tick):
        print(f"[churn] tick {index} ({wall_s:.3f} s): bound {tick['bound']} self-check"
              f" {tick['selfcheck']} {json.dumps(tick['round']['events_by_reason'])}",
              file=sys.stderr, flush=True)

    out = run_operator_world(side, n_sets, n_nodes, update_every, then=lambda h: run_churn_world(
        side, h, ticks=ticks, fullpath_ticks=fullpath_ticks, after_tick=after))
    churn = out["then"]
    print(f"[churn] times {json.dumps(churn.pop('times'))}", file=sys.stderr, flush=True)
    churn["world"] = {**out["world"], "ticks": ticks, "fullpath_ticks": fullpath_ticks}
    return churn


def run_scale(frontier_shape=SCALE_FRONTIER_SHAPE, inert_shape=SCALE_INERT_SHAPE,
              shards=SCALE_SHARDS) -> dict:
    out = run_scale_world(sim_side("grove_tpu"), tuple(frontier_shape), tuple(inert_shape),
                          shards)
    assert not out["spread_problems"], out["spread_problems"]
    print(f"[scale] times {json.dumps(out.pop('times'))}", file=sys.stderr, flush=True)
    return out


def run_sims() -> dict:
    def after(name, wall_s, result):
        print(f"[sims] {name} ({wall_s:.3f} s): {json.dumps(result)[:400]}", file=sys.stderr,
              flush=True)

    out = run_sims_world(sim_side("grove_tpu"), after=after)
    missing = sims_missing(out)
    assert not missing, f"the scenarios did not show: {missing}"
    out.pop("times")
    return out


def run_durability(frontier_shape=SCALE_FRONTIER_SHAPE, shards=SCALE_SHARDS) -> dict:
    side = sim_side("grove_tpu")
    with tempfile.TemporaryDirectory(prefix="grove-pi-") as wal_dir:
        out = run_parallel_world(side, wal_dir, frontier_shape[0], frontier_shape[1], shards)
    assert not out["crash"]["problems"], out["crash"]["problems"]
    assert out["converge"]["all_ready"], "(pi) did not converge to all-Ready"
    print(f"[durability] times {json.dumps(out.pop('times'))}", file=sys.stderr, flush=True)
    side.reset_uid_namespace()
    side.METRICS.reset()
    t0 = time.perf_counter()
    ab = side.parallel.process_codec_ab()
    print(f"[durability] process_codec_ab ({time.perf_counter() - t0:.1f} s):"
          f" {json.dumps(ab)}", file=sys.stderr, flush=True)
    assert ab["reconciles_identical"], ab
    out["process_ab"] = {"shape": ab["shape"], "reconciles": ab["on"]["reconciles"],
                         "reconciles_identical": ab["reconciles_identical"]}
    return out


def run_parallel(sweep_counts=PARALLEL_SWEEP_COUNTS) -> dict:
    def after(name, wall_s, result):
        print(f"[parallel] {name} ({wall_s:.3f} s): {json.dumps(result)[:300]}",
              file=sys.stderr, flush=True)

    with tempfile.TemporaryDirectory(prefix="grove-par-") as tmp:
        out = run_parallel_suite(sim_side("grove_tpu"), tmp, sweep_counts=sweep_counts,
                                 after=after)
    print(f"[parallel] times {json.dumps(out.pop('times'))}", file=sys.stderr, flush=True)
    missing = parallel_missing(out)
    assert not missing, f"the parallel scenarios did not show: {missing}"
    return out


def run_cluster(n_sets=None, n_nodes=None) -> dict:
    side = sim_side("grove_tpu")
    runs = []
    for attempt in (1, 2):
        def after(index, wall_s, work, attempt=attempt):
            print(f"[cluster] run {attempt} round {index} ({wall_s:.3f} s): work {work}",
                  file=sys.stderr, flush=True)

        t0 = time.perf_counter()
        out = run_cluster_world(side, n_sets, n_nodes, after_round=after)
        walls = out.pop("walls")
        print(f"[cluster] run {attempt}: CPU wall {time.perf_counter() - t0:.1f} s,"
              f" walls {json.dumps(walls)}", file=sys.stderr, flush=True)
        assert out["pods"]["ready"] == out["pods"]["total"] > 0, out["pods"]
        runs.append(out)
    first, second = runs
    assert {k: v for k, v in first.items() if k != "bindings_sha256"} == {
        k: v for k, v in second.items() if k != "bindings_sha256"}, "the two runs differ"
    first["bindings_repeat"] = first["bindings_sha256"] == second["bindings_sha256"]
    return first


def run_federation(worlds=("mu", "chi", "psi"), n_nodes=None, stage1_each=FEDERATION_STAGE1_EACH,
                   stage2_each=FEDERATION_STAGE2_EACH) -> dict:
    side = sim_side("grove_tpu")
    out = {}
    if "mu" in worlds:
        t0 = time.perf_counter()
        out["mu"] = run_serving_world(side)
        print(f"[federation] (mu) CPU wall {time.perf_counter() - t0:.1f} s, walls"
              f" {json.dumps(out['mu'].pop('walls'))}", file=sys.stderr, flush=True)
    if "chi" in worlds:
        def after(name, wall_s):
            print(f"[federation] (chi) {name}: {wall_s:.3f} s", file=sys.stderr, flush=True)

        t0 = time.perf_counter()
        out["chi"] = run_chaos_matrix(side, after_run=after)
        out["chi"].pop("walls")
        print(f"[federation] (chi) CPU wall {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
        missing = chaos_missing(out["chi"])
        assert not missing, f"chaos verdicts not ok: {missing}"
    if "psi" in worlds:
        def step(stage, name, wall_s):
            print(f"[federation] (psi) {stage} {name}: {wall_s:.3f} s", file=sys.stderr,
                  flush=True)

        t0 = time.perf_counter()
        kw = {} if n_nodes is None else {"n_nodes": n_nodes}
        out["psi"] = run_federation_world(side, stage1_each=stage1_each, stage2_each=stage2_each,
                                          after_step=step, **kw)
        print(f"[federation] (psi) CPU wall {time.perf_counter() - t0:.1f} s, walls"
              f" {json.dumps(out['psi'].pop('walls'))}", file=sys.stderr, flush=True)
        assert out["psi"]["stage2 converge"]["spillovers"] > out["psi"]["stage2 apply"][
            "spillovers"], "stage 2 did not spill"
    return out


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a JAX CLI process: jax imported first under JAX_PLATFORMS=cpu, so the
# CLI's backend probe finds the CPU pinned and starts no child
JAX_CLI = "import sys, jax; from grove_tpu.cli import main; sys.exit(main(sys.argv[1:]))"


def run_cli(n_nodes=None) -> dict:
    n_nodes = n_nodes or CLI_NODES
    env = dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu")
    cli = [sys.executable, "-c", JAX_CLI]
    initc = [sys.executable, "-m", "grove_tpu.initc"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        config = os.path.join(tmp, "operator-config.yaml")
        with open(config, "w") as f:
            f.write(CLUSTER_CONFIG_YAML)
        sim = run_cli_sim(cli, cli_sim_commands(n_nodes, config), ROOT, env)
    print(f"[cli] sim mode: CPU wall {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)
    out = {"world": {"nodes": n_nodes}, "sim": {}, "live": {}}
    for name, res in sim.items():
        assert res["rc"] == 0, (name, res["stderr"][-2000:])
        out["sim"][name] = cli_digest(name, res["rc"], res["stdout"])
    runs = []
    for attempt in (1, 2):
        def after(name, res, attempt=attempt):
            print(f"[cli] live run {attempt} {name}: rc {res['rc']}, {res['wall_s']:.3f} s",
                  file=sys.stderr, flush=True)

        runs.append(run_cli_live(cli, initc, n_nodes, ROOT, env, after=after))
    first, second = runs
    for name, res in first.items():
        if name in ("apiserver", "boot"):
            continue
        assert res["rc"] == 0, (name, res["stderr"][-2000:])
        a = cli_digest(name, res["rc"], res["stdout"], first["apiserver"])
        b = cli_digest(name, second[name]["rc"], second[name]["stdout"], second["apiserver"])
        out["live"][name] = a if a == b and name in CLI_LIVE_STDOUT else {"rc": a["rc"]}
    return out


def main() -> int:
    if name_needs_seed():
        os.execve(sys.executable, [sys.executable] + sys.argv,
                  dict(os.environ, PYTHONHASHSEED="0"))
    parser = argparse.ArgumentParser()
    parser.add_argument("worlds", nargs="*", default=["s", "q", "r"])
    parser.add_argument("--nodes", type=int, default=None)
    parser.add_argument("--gangs", type=int, default=None)
    parser.add_argument("--ticks", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sets", type=int, default=None)
    parser.add_argument("--update-every", type=int, default=None)
    parser.add_argument("--churn-ticks", type=int, default=CHURN_TICKS)
    parser.add_argument("--fullpath-ticks", type=int, default=CHURN_FULLPATH_TICKS)
    parser.add_argument("--frontier-shape", type=int, nargs=2, default=SCALE_FRONTIER_SHAPE)
    parser.add_argument("--inert-shape", type=int, nargs=2, default=SCALE_INERT_SHAPE)
    parser.add_argument("--shards", type=int, default=SCALE_SHARDS)
    parser.add_argument("--sweep-counts", type=int, nargs="+", default=PARALLEL_SWEEP_COUNTS)
    parser.add_argument("--federation-worlds", nargs="+", default=["mu", "chi", "psi"])
    parser.add_argument("--stage1-each", type=int, default=FEDERATION_STAGE1_EACH)
    parser.add_argument("--stage2-each", type=int, default=FEDERATION_STAGE2_EACH)
    args = parser.parse_args()
    out = {"jax": jax.__version__, "backend": jax.default_backend()}
    for name in args.worlds:
        if name == "operator":
            out[name] = run_operator(args.sets, args.nodes, args.update_every)
        elif name == "churn":
            out[name] = run_churn(args.sets, args.nodes, args.update_every, args.churn_ticks,
                                  args.fullpath_ticks)
        elif name == "scale":
            out[name] = run_scale(args.frontier_shape, args.inert_shape, args.shards)
        elif name == "sims":
            out[name] = run_sims()
        elif name == "durability":
            out[name] = run_durability(args.frontier_shape, args.shards)
        elif name == "parallel":
            out[name] = run_parallel(args.sweep_counts)
        elif name == "cluster":
            out[name] = run_cluster(args.sets, args.nodes)
        elif name == "cli":
            out[name] = run_cli(args.nodes)
        elif name == "federation":
            out[name] = run_federation(args.federation_worlds, args.nodes, args.stage1_each,
                                       args.stage2_each)
        elif name == "observe":
            out[name] = run_observe(args.nodes, args.gangs)
        elif name == "slo":
            out[name] = run_slo(args.nodes, args.gangs, args.ticks, args.seed)
        elif name == "disruption":
            out[name] = run_disruption(args.nodes, args.gangs, args.seed)
        elif name in ("delta", "frontier"):
            out[name] = run_delta(args.nodes, args.gangs, args.ticks, args.seed,
                                  frontier=name == "frontier")
        else:
            out[name] = run_world(name, args.nodes, args.gangs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
