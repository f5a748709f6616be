"""The steady-state churn loop over the delta round.

Counterpart of ``grove_tpu/sim/deltachurn.py``: a seeded churn storm on a
converged harness (a few gangs arrive, a few depart, bound pods fail and are
recreated, a node now and then leaves the schedulable set and comes back),
the schedule slice of every tick timed apart, the delta counters reported.

- ``churn_loop``: the storm; ``selfcheck_every`` arms the scheduler's
  per-round A/B (a from-scratch encode and solve of the same round, bit for
  bit, or the round raises) on every n-th tick;
- ``fullpath_comparison``: the same storm with the delta state detached, so
  every tick pays the from-scratch bindings pass and node encode;
- ``compile_warmup``: the churn-sized solves at N and N-1 schedulable nodes
  before the measured window (the JAX package compiles them there; here the
  fill kernel builds and loads, and launches at those shapes);
- ``delta_artifact``: warm-up, the storm with the A/B every 16th tick, the
  comparison segment, ``p99_lt_1s`` and ``speedup_mean`` (BASELINE's
  steady-state admission gate), on an already converged harness;
- ``smoke_ab_run``: one leg of the run-level A/B (the same storm from a
  fresh harness with and without the delta state must end in the same
  bindings and gang phases).

With a durability layer attached (``SimHarness(durability_dir=...)``) a
tick group-commits the WAL at its end, as the harness's own tick does.
"""

from __future__ import annotations

import random
import time
from typing import List, Optional

from grove_tpu_torch.api.load import load_podcliquesets
from grove_tpu_torch.api.meta import deep_copy

# small standalone gang - the dominant shape of the integrated bench mix,
# cheap enough that arrivals never overcommit the smoke cluster
_CHURN_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: churn
spec:
  replicas: 1
  template:
    cliques:
      - name: server
        spec:
          roleName: role-server
          replicas: 1
          podSpec:
            containers:
              - name: s
                image: busybox:stable
                resources:
                  requests:
                    cpu: 10m
      - name: worker
        spec:
          roleName: role-worker
          replicas: 2
          podSpec:
            containers:
              - name: w
                image: busybox:stable
                resources:
                  requests:
                    cpu: 10m
"""

_CHURN_BASE = load_podcliquesets(_CHURN_YAML)[0]


def _percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile (the bench's tail-honesty convention: never
    report an interpolated value below an observed one)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    k = min(len(s) - 1, max(0, int(round(q * (len(s) - 1) + 0.5)) - 1))
    return s[max(k, int(q * (len(s) - 1)))]


def _tick(h, timings: Optional[List[float]] = None) -> None:
    """One harness tick, converge-shaped, with the scheduler slice timed
    separately - the churn p99 is the ADMISSION hot path's latency, not
    the kubelet's or the reconcilers'."""
    h.engine.drain()
    h.autoscaler.tick()
    h.node_monitor.tick()
    h.drainer.tick()
    t0 = time.perf_counter()
    h.schedule()
    if timings is not None:
        timings.append(time.perf_counter() - t0)
    h.cluster.kubelet_tick()
    h.engine.drain()
    if h.durability is not None:
        h.durability.pump()
    h.clock.advance(1.0)


def churn_loop(
    h,
    ticks: int = 64,
    seed: int = 8,
    selfcheck_every: int = 0,
    flap_every: int = 24,
    namespace: str = "default",
) -> dict:
    """Run a seeded steady-state churn storm on a (converged) harness and
    report the delta-solve counters + schedule-latency percentiles.

    ``selfcheck_every`` > 0 arms the scheduler's ``delta_selfcheck`` A/B on
    every n-th tick (1 = every tick, the smoke's setting): those ticks
    re-derive the problem from scratch and assert problem tensors AND
    solve results are bit-identical, raising on any divergence.

    Also runs with ``sched.delta`` detached (the run-level A/B's control
    leg): the storm replays identically - same rng, same ops - and the
    delta counters are simply absent from the report.
    """
    sched = h.scheduler
    d = sched.delta
    rng = random.Random(seed)
    base = {
        "warm": d.warm_start_hits if d else 0,
        "reuse": d.solve_reuses if d else 0,
        "fallback": d.full_fallbacks if d else 0,
        "drift": d.drift_detected if d else 0,
    }
    ops = {"arrivals": 0, "departures": 0, "pod_fails": 0, "flaps": 0}
    live: List[str] = []  # churn-created sets, oldest first
    timings: List[float] = []
    reencoded = reused = ab_ticks = 0
    ab_seconds = 0.0
    flapped: Optional[str] = None
    prev_selfcheck = sched.delta_selfcheck
    try:
        for i in range(ticks):
            roll = rng.random()
            if roll < 0.45:
                for _ in range(rng.randrange(1, 3)):
                    pcs = deep_copy(_CHURN_BASE)
                    pcs.metadata.name = f"churn-{seed}-{ops['arrivals']:04d}"
                    h.apply(pcs)
                    live.append(pcs.metadata.name)
                    ops["arrivals"] += 1
            elif roll < 0.65 and live:
                h.delete(live.pop(0), namespace)
                ops["departures"] += 1
            elif roll < 0.8 and h.cluster.bindings:
                # kill a bound pod (recreate + re-admission churn); the
                # bindings map is the cheap authority for who is bound
                keys = list(h.cluster.bindings)
                ns, name = keys[rng.randrange(len(keys))]
                h.cluster.fail_pod(ns, name)
                ops["pod_fails"] += 1
            if flap_every and i and i % flap_every == 0:
                # node flap via cordon toggle: leaves and re-enters the
                # schedulable set → two topology-change full fallbacks
                if flapped is None:
                    node = h.cluster.nodes[
                        rng.randrange(len(h.cluster.nodes))
                    ]
                    node.cordoned = True
                    flapped = node.name
                else:
                    for node in h.cluster.nodes:
                        if node.name == flapped:
                            node.cordoned = False
                    flapped = None
                ops["flaps"] += 1
            if selfcheck_every and d is not None:
                sched.delta_selfcheck = i % selfcheck_every == 0
                ab_ticks += int(sched.delta_selfcheck)
            sched.last_selfcheck_seconds = 0.0
            _tick(h, timings)
            # the A/B selfcheck re-derives the whole problem from scratch
            # and re-runs the full solve INSIDE schedule() - a verification
            # harness, never on in production. Charge it to its own ledger,
            # not the admission path's latency.
            ab_seconds += sched.last_selfcheck_seconds
            timings[-1] = max(
                0.0, timings[-1] - sched.last_selfcheck_seconds
            )
            if d is not None:
                reencoded += d.last_reencoded
                reused += d.last_reused
    finally:
        sched.delta_selfcheck = prev_selfcheck
        if flapped is not None:
            for node in h.cluster.nodes:
                if node.name == flapped:
                    node.cordoned = False
    report = {
        "ticks": ticks,
        "seed": seed,
        "ops": ops,
        "schedule_p50_ms": round(_percentile(timings, 0.5) * 1e3, 1),
        "schedule_p99_ms": round(_percentile(timings, 0.99) * 1e3, 1),
        "schedule_mean_ms": round(sum(timings) / len(timings) * 1e3, 1),
        "schedule_max_ms": round(max(timings) * 1e3, 1),
    }
    if d is not None:
        encodes = reencoded + reused
        report.update(
            {
                "spec_encodes": encodes,
                "reencode_fraction": round(reencoded / max(encodes, 1), 4),
                "warm_start_hit_rate": round(reused / max(encodes, 1), 4),
                "warm_start_hits": d.warm_start_hits - base["warm"],
                "solve_reuses": d.solve_reuses - base["reuse"],
                "full_fallbacks": d.full_fallbacks - base["fallback"],
                "drift_detected": d.drift_detected - base["drift"],
                "ab_ticks": ab_ticks,
                "ab_overhead_ms": round(ab_seconds * 1e3, 1),
                "ab_ok": True,  # a failing A/B raises out of churn_loop
            }
        )
    return report


def fullpath_comparison(h, ticks: int = 32, seed: int = 9) -> dict:
    """Comparison segment: the SAME seeded churn mix on the same harness
    with the delta state detached - every tick pays the from-scratch
    bindings repass + node re-encode - so the artifact carries a
    same-process, same-shape, same-storm measurement of what each
    steady-state tick used to cost."""
    sched = h.scheduler
    d, last = sched.delta, sched._delta_last
    sched.delta, sched._delta_last = None, None
    try:
        report = churn_loop(
            h, ticks=ticks, seed=seed, selfcheck_every=0, flap_every=0
        )
    finally:
        sched.delta = d
        if d is not None:
            # the detached segment's binding churn was still folded (the
            # state stays subscribed), but make the resumption airtight:
            # re-derive everything on the next delta tick
            d.invalidate(reason="fullpath-comparison")
        sched._delta_last = last
    return {
        "ticks": ticks,
        "schedule_p50_ms": report["schedule_p50_ms"],
        "schedule_p99_ms": report["schedule_p99_ms"],
        "schedule_mean_ms": report["schedule_mean_ms"],
    }


def compile_warmup(h, namespace: str = "default") -> dict:
    """Run the steady-state solve shapes once before measurement: the
    churn-sized gang buckets at N schedulable nodes and at N-1 (a flap's
    cordon shrinks the node axis by one, whichever node flapped). The
    kernels build and load on their first launch; a latency measurement
    that bills that to one tick measures process warm-up, not the
    admission path. The warm-up gangs are deleted and drained before
    returning, so the measured population is exactly the caller's."""
    t0 = time.perf_counter()
    names = []
    serial = 0

    def arrive(count: int) -> None:
        nonlocal serial
        for _ in range(count):
            pcs = deep_copy(_CHURN_BASE)
            pcs.metadata.name = f"deltawarm-{serial}"
            serial += 1
            h.apply(pcs)
            names.append(pcs.metadata.name)
        _tick(h)

    # the churn's per-tick pending set is 1-2 fresh gangs: solve both
    # gang buckets at N, then both again while one node is cordoned (N-1)
    arrive(1)
    arrive(2)
    h.cluster.nodes[0].cordoned = True
    arrive(1)
    arrive(2)
    h.cluster.nodes[0].cordoned = False
    _tick(h)
    for name in names:
        h.delete(name, namespace)
    for _ in range(4):
        _tick(h)
    return {"wall_ms": round((time.perf_counter() - t0) * 1e3, 1)}


def delta_artifact(h, ticks: int = 96, seed: int = 8) -> dict:
    """The bench's ``"delta"`` block on an already converged harness (the
    integrated 10k-set x 5k-node steady state): a warm-up, the seeded
    storm with the A/B self-check every 16th tick, then the from-scratch
    comparison segment of 32 ticks. The acceptance gate is ``p99_lt_1s``
    on the delta path's schedule latency."""
    # same GC discipline as the converge measurement (bench.py
    # _run_population_bench): the store population is large, long-lived,
    # and acyclic - churned objects free promptly by refcount, while a
    # cyclic full collection scans the whole live heap and can land a
    # multi-second pause on one arbitrary tick of the percentile window
    import gc

    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        warmup = compile_warmup(h)
        report = churn_loop(
            h, ticks=ticks, seed=seed, selfcheck_every=16, flap_every=32
        )
        report["full_path"] = fullpath_comparison(h, ticks=32, seed=seed + 1)
    finally:
        gc.enable()
        gc.unfreeze()
        gc.collect()
    report["warmup"] = warmup
    report["p99_lt_1s"] = report["schedule_p99_ms"] < 1000.0
    # mean, not p50: the two segments draw different tick counts from the
    # same storm distribution, and a median just reports which tick TYPE
    # (light vs solve-bearing) straddles the 50th slot of each sample -
    # the mean is composition-honest across segment lengths
    report["speedup_mean"] = round(
        report["full_path"]["schedule_mean_ms"]
        / max(report["schedule_mean_ms"], 0.1),
        2,
    )
    return report


def smoke_ab_run(seed: int, enable_delta: bool, ticks: int = 36, device=None) -> tuple:
    """Run-level A/B leg: one seeded storm from a fresh harness on
    ``device``; returns (bindings, gang phases). The two legs must be
    identical: the delta round's admissions equal the full solve's."""
    from grove_tpu_torch.models.scenarios import load_sample
    from grove_tpu_torch.sim.harness import SimHarness

    h = SimHarness(num_nodes=12, device=device)
    if not enable_delta:
        h.scheduler.delta = None  # from-scratch control leg
    for i in range(6):
        pcs = deep_copy(_CHURN_BASE)
        pcs.metadata.name = f"seed-{i}"
        h.apply(pcs)
    for i in range(2):
        # standing pending backlog (unplaceable at 12 nodes): keeps real
        # solves running every tick on both legs
        pcs = deep_copy(load_sample("multinode_disaggregated"))
        pcs.metadata.name = f"backlog-{i}"
        h.apply(pcs)
    h.converge(max_ticks=30)
    churn_loop(h, ticks=ticks, seed=seed, selfcheck_every=1)
    h.converge(max_ticks=60)
    bindings = dict(h.cluster.bindings)
    phases = {
        g.metadata.name: g.status.phase
        for g in h.store.list("PodGang", "default")
    }
    return bindings, phases
