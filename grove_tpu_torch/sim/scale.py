"""The keyspace-sharded control plane at scale: converge a multi-tenant
population, and the two A/Bs that pin what sharding and the frontier may
change.

Counterpart of ``grove_tpu/sim/scale.py``:

- ``converge_population``: apply and converge one population of one-clique,
  eight-pod sets spread over ``n_tenants`` namespaces (set ``i`` lands in
  ``tenant-(i % n_tenants)``: the keyspace map is per namespace, so a
  one-namespace population would load one shard) on a fresh harness over a
  ``Store(num_shards=S)``, with cyclic GC frozen and off over the measured
  window; optionally with the partitioned frontier, or with the wall
  profiler and the gang journeys on (``glassbox_blocks``).
- ``inert_ab``: S=1 against S=``num_shards`` on the same population must
  give the same committed content (the canonical-uid dump, Events left out,
  per-object resourceVersions dropped: per-shard sequences differ from the
  single one by construction), the same reconcile count and the same
  scalar resourceVersion.
- ``frontier_ab``: the same population converged with the global solve and
  with the partitioned frontier, walls and solver times side by side.
- ``scale_artifact``: the big sharded converge (frontier on, the parallel
  drain per ``workers``, the glass-box blocks), then both A/Bs and the
  process drain's codec A/B (``sim/parallel.process_codec_ab``).

The harnesses run their solves on ``device`` (the card unless the caller
passes ``device="cpu"``). ``workers`` pins the drain: 1 (what both A/Bs
pass) is the serial drain; more than 1 arms the parallel drain on a sharded
store (the backend from ``GROVE_TPU_CP_BACKEND``), whose per-worker busy
shares the report adds under ``"parallel"``.
"""

from __future__ import annotations

import gc
import time
from typing import List, Optional, Tuple

from grove_tpu_torch.api.load import load_podcliquesets
from grove_tpu_torch.api.meta import deep_copy
from grove_tpu_torch.api.pod import is_ready
from grove_tpu_torch.observability.hostinfo import host_block
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.runtime.clock import VirtualClock
from grove_tpu_torch.runtime.store import Store
from grove_tpu_torch.sim.harness import SimHarness

# one clique of 8 replicas: the leanest gang that runs the whole pipeline
# (PodCliqueSet, PodClique, PodGang, solve, bind, status)
_SCALE_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: scale
spec:
  replicas: 1
  template:
    cliques:
      - name: serve
        spec:
          roleName: role-serve
          replicas: 8
          podSpec:
            containers:
              - name: serve
                image: busybox:stable
                resources:
                  requests:
                    cpu: 10m
"""

_BASE = load_podcliquesets(_SCALE_YAML)[0]


def tenant_namespaces(n_tenants: int) -> List[str]:
    return [f"tenant-{i:03d}" for i in range(n_tenants)]


def _populate(h: SimHarness, n_sets: int, tenants: List[str]) -> float:
    t0 = time.perf_counter()
    for i in range(n_sets):
        pcs = deep_copy(_BASE)
        pcs.metadata.name = f"svc-{i:06d}"
        pcs.metadata.namespace = tenants[i % len(tenants)]
        h.apply(pcs)
    return time.perf_counter() - t0


def _reconcile_count() -> int:
    return int(sum(v for k, v in METRICS.counters.items() if k.startswith("reconcile_total")))


def _peak_rss_kb() -> int:
    """Process peak RSS in KB (monotone over the process lifetime)."""
    import resource

    return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)


def converge_population(
    n_sets: int,
    n_nodes: int,
    num_shards: int,
    n_tenants: int = 64,
    max_ticks: Optional[int] = None,
    frontier: bool = False,
    frontier_selfcheck: bool = False,
    glassbox: bool = False,
    workers: int = 0,
    device=None,
) -> Tuple[SimHarness, dict]:
    """Apply and converge one multi-tenant population on a fresh harness;
    returns (harness, report).

    Cyclic GC is frozen and off over both measured phases (apply and
    converge), and the wall is read before the closing collection. Peak
    RSS is sampled after each phase. ``frontier=True`` attaches the
    partitioned frontier and reports its counters under ``"frontier"``
    (``frontier_selfcheck`` arms its per-tick A/B); otherwise the global
    path is pinned even where ``GROVE_TPU_FRONTIER`` attached it.
    ``glassbox=True`` arms the wall profiler and the journeys for the
    converge window and adds the ``attribution``, ``admission_latency`` and
    ``critical_path`` blocks. ``workers``: 0 leaves the engine as built
    (``GROVE_TPU_CP_WORKERS``), 1 pins the serial drain, more arms the
    parallel drain; the report's ``workers`` is what ran."""
    tenants = tenant_namespaces(min(n_tenants, max(n_sets, 1)))
    store = Store(VirtualClock(), cache_lag=True, num_shards=num_shards)
    h = SimHarness(num_nodes=n_nodes, store=store, device=device)
    if workers > 0 and (h.engine.workers is None or h.engine.workers.workers != workers):
        h.engine.close()
        if workers > 1:
            h.engine.enable_workers(workers)
    if frontier:
        h.scheduler.enable_frontier()
        h.scheduler.frontier_selfcheck = frontier_selfcheck
    else:
        h.scheduler.frontier = None
        h.scheduler.frontier_selfcheck = False
    solver_s0 = METRICS.hist_sum.get("gang_solve_seconds", 0.0)
    reconciles0 = _reconcile_count()
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        t0 = time.perf_counter()
        applied_s = _populate(h, n_sets, tenants)
        rss_after_apply = _peak_rss_kb()
        if glassbox:
            from grove_tpu_torch.observability.journey import JOURNEYS
            from grove_tpu_torch.observability.profile import PROFILER

            PROFILER.enable()
            PROFILER.reset()
            JOURNEYS.enable()
            JOURNEYS.reset()
            JOURNEYS.clock = h.clock
        # the busy shares cover the converge only, as the attribution does
        busy0 = h.engine.workers.busy_snapshot() if h.engine.workers is not None else None
        t_conv0 = time.perf_counter()
        h.converge(max_ticks=max_ticks or (60 + 8 * n_sets))
        converge_wall = time.perf_counter() - t_conv0
        wall = time.perf_counter() - t0
        glass = None
        if glassbox:
            # freeze the ledger now: the report's store reads below stay
            # out of the attribution window
            solver_glass = METRICS.hist_sum.get("gang_solve_seconds", 0.0) - solver_s0
            glass = glassbox_blocks(
                converge_wall, solver_glass,
                worker_of=h.engine.workers.worker_of if h.engine.workers is not None else None)
    finally:
        gc.enable()
        gc.unfreeze()
        gc.collect()
    rss_after_converge = _peak_rss_kb()
    pods = h.store.list("Pod")
    ready = bool(pods) and all(is_ready(p) for p in pods)
    reconciles = _reconcile_count() - reconciles0
    solver_s = METRICS.hist_sum.get("gang_solve_seconds", 0.0) - solver_s0
    cp_seconds = max(wall - solver_s - applied_s, 0.0)
    total, ready_n = h.store.pod_summary()
    report = {
        "sets": n_sets,
        "nodes": n_nodes,
        "shards": num_shards,
        "tenants": len(tenants),
        "pods": len(pods),
        "all_ready": ready,
        "wall_seconds": round(wall, 2),
        "apply_seconds": round(applied_s, 2),
        "solver_seconds": round(solver_s, 2),
        "solver_share": round(solver_s / wall, 4) if wall else 0.0,
        "control_plane_seconds": round(cp_seconds, 2),
        "reconciles": reconciles,
        "us_per_reconcile": round(1e6 * cp_seconds / max(reconciles, 1), 1),
        # the pod summary off the level-2 tree, and its nodes per level
        "pod_summary": {"total": total, "ready": ready_n},
        "fold_depth_histogram": h.store.fold_depth_histogram(),
        "shard_census": h.store.shard_census(),
        "peak_rss_kb": {"after_apply": rss_after_apply, "after_converge": rss_after_converge},
        # the parallel drain's footprint (1: the serial drain)
        "workers": h.engine.workers.workers if h.engine.workers is not None else 1,
        "host": host_block(
            backend=h.engine.workers.backend if h.engine.workers is not None else "serial"),
    }
    if h.engine.workers is not None:
        stats = h.engine.workers.stats()
        stats["utilization"] = h.engine.workers.utilization(converge_wall, since=busy0)
        report["parallel"] = stats
    if frontier and h.scheduler.frontier is not None:
        report["frontier"] = h.scheduler.frontier.stats()
    if glassbox and glass is not None:
        report.update(glass)
        if h.engine.workers is not None and "by_worker" in report.get("attribution", {}):
            report["parallel"]["attributed_utilization"] = report["attribution"]["by_worker"]
    return h, report


def glassbox_blocks(converge_wall: float, solver_s: float, worker_of=None) -> dict:
    """Freeze the glass-box layer into report blocks and disarm it.

    ``attribution``: the profiler's roll-up with two coverage ratios,
    ``coverage`` (attributed over the converge wall, solver on both sides)
    and ``cp_coverage`` (the same with the solve rows taken off both
    sides). ``admission_latency`` and ``critical_path``: the journeys'
    decomposition and its fold. With ``worker_of`` (a shard -> worker map,
    when the parallel drain ran), ``by_worker``: each shard-scoped row's
    self time summed onto its worker, as a share of the converge wall, over
    every row before the table is cut to its top 24."""
    from grove_tpu_torch.observability.journey import JOURNEYS
    from grove_tpu_torch.observability.profile import PROFILER

    attribution = PROFILER.report(wall_seconds=converge_wall)
    if worker_of is not None:
        by_worker: dict = {}
        for ph in attribution["phases"]:
            shard = ph["shard"]
            if shard is None or shard < 0:
                continue
            w = worker_of(shard)
            by_worker[w] = by_worker.get(w, 0.0) + ph["total_s"]
        attribution["by_worker"] = {
            str(w): round(sec / max(converge_wall, 1e-9), 4) for w, sec in sorted(by_worker.items())
        }
    solve_attr = sum(ph["total_s"] for ph in attribution["phases"] if ph["phase"] == "solve")
    cp_wall = converge_wall - solve_attr
    cp_attr = attribution["attributed_seconds"] - solve_attr
    attribution["cp_wall_seconds"] = round(cp_wall, 6)
    attribution["cp_attributed_seconds"] = round(cp_attr, 6)
    attribution["cp_coverage"] = round(cp_attr / cp_wall, 4) if cp_wall > 0 else 0.0
    attribution["solver_histogram_seconds"] = round(solver_s, 6)
    attribution["phases"] = attribution["phases"][:24]
    blocks = {
        "attribution": attribution,
        "admission_latency": JOURNEYS.decomposition(),
        "critical_path": JOURNEYS.critical_path(),
    }
    PROFILER.disable()
    JOURNEYS.disable()
    return blocks


def _rv_normalized(dump: dict) -> dict:
    """Drop the per-object resourceVersions: per-shard sequences differ
    from the single one by construction; everything else must match."""
    for doc in dump.values():
        doc.get("metadata", {}).pop("resourceVersion", None)
    return dump


def inert_ab(n_sets: int = 192, n_nodes: int = 64, num_shards: int = 5, device=None) -> dict:
    """S=1 against S=``num_shards`` on the same population: the same
    committed content up to the per-object resourceVersions (canonical-uid
    dump, Events left out: their counts follow dedup timing, not routing),
    the same reconcile count, the same scalar resourceVersion. A small
    warm-up converge runs first, so neither arm pays the kernels' build.
    Both arms run the serial drain (``workers=1``)."""
    from grove_tpu_torch.sim.recovery import store_dump

    wh, _wr = converge_population(
        min(n_sets, 16), min(n_nodes, 16), num_shards=1, workers=1, device=device
    )
    _close_harness(wh)
    h1, r1 = converge_population(n_sets, n_nodes, num_shards=1, workers=1, device=device)
    hs, rs = converge_population(
        n_sets, n_nodes, num_shards=num_shards, workers=1, device=device
    )
    dump1 = _rv_normalized(store_dump(h1.store, canonical_uids=True, include_events=False))
    dumps = _rv_normalized(store_dump(hs.store, canonical_uids=True, include_events=False))
    _close_harness(h1)
    _close_harness(hs)
    return {
        "sets": n_sets,
        "shards_b": num_shards,
        "identical_content": dump1 == dumps,
        "objects": len(dump1),
        "reconciles_s1": r1["reconciles"],
        "reconciles_sharded": rs["reconciles"],
        "identical_reconciles": r1["reconciles"] == rs["reconciles"],
        "all_ready_both": r1["all_ready"] and rs["all_ready"],
        "rv_scalar_s1": h1.store.resource_version,
        "rv_scalar_sharded": hs.store.resource_version,
        "identical_rv_scalar": h1.store.resource_version == hs.store.resource_version,
        "wall_s1": r1["wall_seconds"],
        "wall_sharded": rs["wall_seconds"],
    }


def census_spread_problems(census: List[dict], num_shards: int) -> List[str]:
    """The shard-count-aware census gate: at S>=2 the population must land
    on two or more shards (the run exercised routing, not one hot shard);
    at S=1 on exactly one. Returns the problems (empty: ok)."""
    busy = [c for c in census if c["objects"] > 0]
    if num_shards <= 1:
        if len(busy) != 1:
            return [
                f"S=1 run landed objects on {len(busy)} shards — the"
                " unsharded store must have exactly one populated shard"
            ]
        return []
    if len(busy) < 2:
        return [
            f"population landed on {len(busy)} shard(s) — the smoke must"
            " exercise cross-shard routing"
        ]
    return []


def frontier_ab(n_sets: int = 512, n_nodes: int = 512, num_shards: int = 2, device=None) -> dict:
    """The same population converged with the global solve and with the
    partitioned frontier, walls and solver times side by side. Warm-up
    converges of a few sets over the full node axis run first, one per
    arm, so the kernels' build and the first launches at the measured node
    count land outside both arms. Both arms run the serial drain."""
    w1, _r1 = converge_population(
        min(n_sets, 16), n_nodes, num_shards=1, workers=1, device=device
    )
    _close_harness(w1)
    w2, _r2 = converge_population(
        min(n_sets, 16), n_nodes, num_shards=1, frontier=True, workers=1, device=device
    )
    _close_harness(w2)
    off_h, off = converge_population(n_sets, n_nodes, num_shards, workers=1, device=device)
    _close_harness(off_h)
    del off_h
    gc.collect()
    on_h, on = converge_population(
        n_sets, n_nodes, num_shards, frontier=True, workers=1, device=device
    )
    _close_harness(on_h)
    del on_h
    gc.collect()
    return {
        "sets": n_sets,
        "nodes": n_nodes,
        "wall_off": off["wall_seconds"],
        "wall_on": on["wall_seconds"],
        "solver_off": off["solver_seconds"],
        "solver_on": on["solver_seconds"],
        "speedup_wall": round(off["wall_seconds"] / max(on["wall_seconds"], 1e-9), 2),
        "speedup_solver": round(off["solver_seconds"] / max(on["solver_seconds"], 1e-9), 2),
        "all_ready_both": off["all_ready"] and on["all_ready"],
        "frontier": on.get("frontier", {}),
    }


def scale_artifact(
    n_sets: int = 62_500,
    n_nodes: int = 100_000,
    num_shards: int = 8,
    ab_sets: int = 192,
    frontier_ab_shape: Tuple[int, int] = (512, 512),
    workers: int = 0,
    shape_1m: Optional[Tuple[int, int, int]] = None,
    device=None,
) -> dict:
    """The scale report: the big sharded converge (frontier on, the
    glass-box blocks, the parallel drain per ``workers`` or
    ``GROVE_TPU_CP_WORKERS``), then ``inert_ab`` at ``ab_sets``,
    ``frontier_ab`` at ``frontier_ab_shape`` and the process drain's
    ``process_codec_ab``. ``shape_1m`` (sets, nodes, shards): a second,
    dark converge of that shape under ``"shape_1m"``."""
    harness, report = converge_population(
        n_sets, n_nodes, num_shards, frontier=True, glassbox=True, workers=workers,
        device=device,
    )
    # release the big population (its drain and the frontier's pool)
    # before the A/Bs build their harnesses
    _close_harness(harness)
    del harness
    gc.collect()
    report["inert_ab"] = inert_ab(n_sets=ab_sets, num_shards=num_shards, device=device)
    report["frontier_ab"] = frontier_ab(
        n_sets=frontier_ab_shape[0], n_nodes=frontier_ab_shape[1], num_shards=num_shards,
        device=device,
    )
    from grove_tpu_torch.sim.parallel import process_codec_ab

    gc.collect()
    report["process_ab"] = process_codec_ab(device=device)
    if shape_1m is not None:
        m_sets, m_nodes, m_shards = shape_1m
        gc.collect()
        m_harness, m_report = converge_population(
            m_sets, m_nodes, m_shards, frontier=True, workers=workers, device=device
        )
        _close_harness(m_harness)
        del m_harness
        gc.collect()
        report["shape_1m"] = m_report
    return report


def _close_harness(h: SimHarness) -> None:
    """Release a retired harness's executors: the parallel drain's workers
    and the frontier's device pool."""
    h.engine.close()
    if h.scheduler is not None and h.scheduler.frontier is not None:
        h.scheduler.frontier.close()
