"""Parallel-drain scenarios: the serial-twin A/B, the worker sweep and the
process drain's codec A/B.

Counterpart of ``grove_tpu/sim/parallel.py``. The contract of the parallel
drain (``runtime/workers.py``, ``runtime/procworkers.py``): the same event
schedule through the serial drain and the worker drain gives

- the same admissions and store content: canonical-uid wire dumps, Events
  left out (their evt-N names race by design and they are outside the
  durability contract), per-object resourceVersions dropped as the sharded
  inert A/B drops them (Event commits interleave into their shard's
  sequence);
- the same reconcile counts at every converge boundary;
- the same scalar resourceVersion (every commit, Events included);
- the same per-shard WAL acked prefixes (``durable_state_normalized``).

``parallel_ab`` drives both twins in lockstep through a seeded cross-shard
storm (``storm_steps``) and compares at every converge boundary.
``worker_sweep`` converges one population per worker count (µs a reconcile
and the speedup against the serial arm), ``process_codec_ab`` the process
drain with the memoized decode and the overlap pump against both off. The
harnesses solve on ``device`` (the card unless the caller passes
``device="cpu"``).
"""

from __future__ import annotations

import gc
import json
import time
from typing import Callable, Dict, List, Optional, Tuple

from grove_tpu_torch.api.meta import deep_copy
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.runtime.clock import VirtualClock
from grove_tpu_torch.runtime.store import Store
from grove_tpu_torch.sim.harness import SimHarness
from grove_tpu_torch.sim.scale import (
    _BASE,
    _populate,
    _reconcile_count,
    _rv_normalized,
    tenant_namespaces,
)


def _make_harness(
    n_nodes: int,
    num_shards: int,
    workers: int,
    durability_dir: Optional[str] = None,
    backend: str = "thread",
    device=None,
) -> SimHarness:
    """Harness with EXACTLY `workers` drain lanes (1 = the serial drain).

    The engine auto-arms from GROVE_TPU_CP_WORKERS at construction — the
    very opt-in these scenarios exist to validate — so an inherited env
    arming is explicitly torn down: the serial twin must actually be
    serial and each sweep arm must run its labeled worker count, or the
    A/B compares parallel-vs-parallel and the sweep table is fiction."""
    store = Store(VirtualClock(), cache_lag=True, num_shards=num_shards)
    h = SimHarness(
        num_nodes=n_nodes, store=store, durability_dir=durability_dir, device=device
    )
    if h.engine.workers is not None and (
        workers <= 1
        or h.engine.workers.workers != workers
        or h.engine.workers.backend != backend
    ):
        h.engine.close()  # drop the env-armed pool (enable_workers below
        # re-arms fresh when this scenario wants a different count/backend)
    if workers > 1 and h.engine.workers is None:
        armed = h.engine.enable_workers(workers, backend=backend)
        assert armed, "worker arming requires a sharded in-memory store"
    return h


def _dump(h: SimHarness) -> dict:
    from grove_tpu_torch.sim.recovery import store_dump

    return _rv_normalized(
        store_dump(h.store, canonical_uids=True, include_events=False)
    )


def _converge_counted(h: SimHarness, max_ticks: int) -> Tuple[int, int]:
    """(reconciles, ticks) for one converge of one harness (the METRICS
    counter is process-global — the twins run strictly in turn)."""
    r0 = _reconcile_count()
    ticks = h.converge(max_ticks=max_ticks)
    return _reconcile_count() - r0, ticks


def durable_state_normalized(wal_dir: str) -> Dict[int, dict]:
    """Per-shard durable prefix as {shard: {key: envelope-minus-rv}} —
    the WAL half of the serial-twin comparison. resourceVersions are
    stripped for the same reason the store dump normalizes them: Event
    commits (unlogged, best-effort) interleave into a shard's rv
    sequence differently under workers, while the DURABLE CONTENT must
    match exactly."""
    import json as _json

    from grove_tpu_torch.durability.wal import _iter_durable_state, list_shard_dirs

    # sharded layout: one stream per shard-NNN dir; unsharded: the dir
    # itself is shard 0's stream (the legacy layout)
    streams = list_shard_dirs(wal_dir) or [(0, wal_dir)]
    out: Dict[int, dict] = {}
    for shard_index, directory in streams:
        state = {}
        for key, env in _iter_durable_state(directory):
            if env is None:
                state["/".join(key)] = None
                continue
            # a private copy to normalize (envelopes are JSON by
            # construction)
            env = _json.loads(_json.dumps(env))
            env.pop("rv", None)
            env.get("obj", {}).get("metadata", {}).pop(
                "resourceVersion", None
            )
            state["/".join(key)] = env
        out[shard_index] = state
    # canonical uids, exactly like store_dump(canonical_uids=True): the
    # twins share one process-global uid counter and allocate in a
    # different interleave under workers — identity is positional
    mapping: Dict[str, str] = {}
    for shard_index in sorted(out):
        for key in sorted(out[shard_index]):
            env = out[shard_index][key]
            if env is None:
                continue
            uid = env.get("obj", {}).get("metadata", {}).get("uid")
            if uid and uid not in mapping:
                mapping[uid] = f"uid-canonical-{len(mapping)}"
    for state in out.values():
        for env in state.values():
            if env is None:
                continue
            meta = env.get("obj", {}).get("metadata", {})
            if meta.get("uid") in mapping:
                meta["uid"] = mapping[meta["uid"]]
            for ref in meta.get("ownerReferences", []) or []:
                if ref.get("uid") in mapping:
                    ref["uid"] = mapping[ref["uid"]]
    return out


# ---------------------------------------------------------------------------
# seeded cross-shard event storm (the lockstep schedule both twins replay)
# ---------------------------------------------------------------------------


def storm_steps(
    seed: int, n_sets: int, n_tenants: int, rounds: int = 4
) -> List[Callable[[SimHarness], None]]:
    """Deterministic mutation schedule: each step is a pure function of
    (seed, step index) applied identically to both twins — scale-ups,
    deletions, re-applies and replica churn spread across tenant
    namespaces so every round exercises cross-shard interleavings."""
    import random

    rng = random.Random(seed)
    tenants = tenant_namespaces(n_tenants)
    live = {
        (f"svc-{i:06d}", tenants[i % len(tenants)]) for i in range(n_sets)
    }
    steps: List[Callable[[SimHarness], None]] = []
    next_id = n_sets
    for _ in range(rounds):
        ordered = sorted(live)
        victims = rng.sample(ordered, k=max(1, len(ordered) // 6))
        adds = [
            (f"svc-{next_id + j:06d}", tenants[(next_id + j) % len(tenants)])
            for j in range(max(1, len(ordered) // 8))
        ]
        next_id += len(adds)
        survivors = [s for s in ordered if s not in set(victims)]
        scale = rng.sample(
            survivors, k=max(1, len(survivors) // 8)
        ) if survivors else []
        new_replicas = rng.choice([2, 3])

        def step(
            h: SimHarness,
            _victims=tuple(victims),
            _adds=tuple(adds),
            _scale=tuple(scale),
            _replicas=new_replicas,
        ) -> None:
            for name, ns in _victims:
                h.delete(name, namespace=ns)
            for name, ns in _adds:
                pcs = deep_copy(_BASE)
                pcs.metadata.name = name
                pcs.metadata.namespace = ns
                h.apply(pcs)
            for name, ns in _scale:
                # through the sanctioned apply path (defaulting +
                # update validation), exactly like a user scale-out of
                # the SET replica axis (clique template fields are
                # immutable post-create)
                pcs = deep_copy(_BASE)
                pcs.metadata.name = name
                pcs.metadata.namespace = ns
                pcs.spec.replicas = _replicas
                h.apply(pcs)

        steps.append(step)
        live -= set(victims)
        live |= set(adds)
    return steps


# ---------------------------------------------------------------------------
# serial-twin A/B
# ---------------------------------------------------------------------------


def parallel_ab(
    n_sets: int = 48,
    n_nodes: int = 32,
    num_shards: int = 4,
    workers: int = 4,
    seed: int = 1234,
    n_tenants: int = 8,
    storm_rounds: int = 3,
    wal_dirs: Optional[Tuple[str, str]] = None,
    max_ticks: Optional[int] = None,
    backend: str = "thread",
    device=None,
) -> dict:
    """Lockstep serial-vs-workers twin run; compares at EVERY converge
    boundary. Returns the report; ``problems`` empty ⇔ bit-identical.

    ``backend`` picks the worker twin's executor ("thread" |
    "process") — the serial twin is always the single-threaded drain,
    so one scenario pins BOTH executors to the same contract.

    ``wal_dirs=(serial_dir, workers_dir)`` additionally attaches
    per-shard WAL streams to both twins and compares the durable acked
    prefixes shard by shard after the final converge."""
    ticks = max_ticks or (60 + 8 * n_sets)
    serial = _make_harness(
        n_nodes, num_shards, 1, wal_dirs[0] if wal_dirs else None, device=device
    )
    parallel = _make_harness(
        n_nodes,
        num_shards,
        workers,
        wal_dirs[1] if wal_dirs else None,
        backend=backend,
        device=device,
    )
    tenants = tenant_namespaces(n_tenants)
    problems: List[str] = []
    boundaries = 0

    def compare(label: str) -> None:
        nonlocal boundaries
        boundaries += 1
        ds, dp = _dump(serial), _dump(parallel)
        if ds != dp:
            keys = sorted(
                k for k in set(ds) | set(dp) if ds.get(k) != dp.get(k)
            )
            detail = []
            for k in keys[:2]:
                a = json.dumps(ds.get(k), sort_keys=True)
                b = json.dumps(dp.get(k), sort_keys=True)
                off = next(
                    (
                        i
                        for i in range(min(len(a), len(b)))
                        if a[i] != b[i]
                    ),
                    min(len(a), len(b)),
                )
                detail.append(
                    f"{k}: serial[...{a[max(0, off - 60):off + 90]}...]"
                    f" vs parallel[...{b[max(0, off - 60):off + 90]}...]"
                )
            problems.append(
                f"{label}: store content diverged on {len(keys)} key(s):"
                f" {'; '.join(detail)}"
            )
        if (
            serial.store.resource_version
            != parallel.store.resource_version
        ):
            problems.append(
                f"{label}: scalar resourceVersion diverged"
                f" ({serial.store.resource_version} vs"
                f" {parallel.store.resource_version})"
            )

    _populate(serial, n_sets, tenants)
    _populate(parallel, n_sets, tenants)
    r_serial, _ = _converge_counted(serial, ticks)
    r_parallel, _ = _converge_counted(parallel, ticks)
    if r_serial != r_parallel:
        problems.append(
            f"initial converge: reconcile counts diverged"
            f" ({r_serial} vs {r_parallel})"
        )
    compare("initial converge")
    reconciles = [(r_serial, r_parallel)]
    for i, step in enumerate(
        storm_steps(seed, n_sets, n_tenants, rounds=storm_rounds)
    ):
        step(serial)
        step(parallel)
        r_serial, _ = _converge_counted(serial, ticks)
        r_parallel, _ = _converge_counted(parallel, ticks)
        if r_serial != r_parallel:
            problems.append(
                f"storm step {i}: reconcile counts diverged"
                f" ({r_serial} vs {r_parallel})"
            )
        compare(f"storm step {i}")
        reconciles.append((r_serial, r_parallel))
    wal_identical = None
    if wal_dirs is not None:
        serial.durability.pump()
        parallel.durability.pump()
        acked_serial = durable_state_normalized(wal_dirs[0])
        acked_parallel = durable_state_normalized(wal_dirs[1])
        wal_identical = acked_serial == acked_parallel
        if not wal_identical:
            problems.append("per-shard WAL acked prefixes diverged")
    worker_stats = (
        parallel.engine.workers.stats()
        if parallel.engine.workers is not None
        else {}
    )
    serial.engine.close()
    parallel.engine.close()
    return {
        "sets": n_sets,
        "shards": num_shards,
        "workers": workers,
        "backend": backend,
        "seed": seed,
        "boundaries_compared": boundaries,
        "reconciles": reconciles,
        "identical": not problems,
        "problems": problems,
        "wal_acked_identical": wal_identical,
        "worker_stats": worker_stats,
    }


# ---------------------------------------------------------------------------
# worker sweep (the measurement arm)
# ---------------------------------------------------------------------------


def worker_sweep(
    n_sets: int = 192,
    n_nodes: int = 64,
    num_shards: int = 8,
    worker_counts: Tuple[int, ...] = (1, 2, 4, 8),
    backend: str = "thread",
    device=None,
) -> dict:
    """One population converged per worker count; µs/reconcile + speedup
    vs the serial arm. A throwaway warmup converge at the measured node
    count takes the solver's first-call costs (the kernels' build and
    load), so the sweep measures control-plane work and no arm is billed
    them. GC discipline
    matches converge_population (frozen and off over the measured wall)."""
    tenants = tenant_namespaces(min(16, n_sets))
    _warm = _make_harness(n_nodes, num_shards, 1, device=device)
    _populate(_warm, n_sets, tenants)
    _warm.converge(max_ticks=60 + 8 * n_sets)
    _warm.engine.close()
    del _warm
    gc.collect()
    rows = []
    base_wall = None
    for workers in worker_counts:
        h = _make_harness(n_nodes, num_shards, workers, backend=backend, device=device)
        solver0 = METRICS.hist_sum.get("gang_solve_seconds", 0.0)
        r0 = _reconcile_count()
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            t0 = time.perf_counter()
            _populate(h, n_sets, tenants)
            h.converge(max_ticks=60 + 8 * n_sets)
            wall = time.perf_counter() - t0
        finally:
            gc.enable()
            gc.unfreeze()
            gc.collect()
        reconciles = _reconcile_count() - r0
        solver_s = METRICS.hist_sum.get("gang_solve_seconds", 0.0) - solver0
        cp = max(wall - solver_s, 0.0)
        from grove_tpu_torch.api.pod import is_ready

        pods = h.store.list("Pod")
        row = {
            "workers": workers,
            # the drain clamps to the shard count (worker_of = shard % W
            # can never feed more than S workers) — report what ran
            "effective_workers": (
                h.engine.workers.workers
                if h.engine.workers is not None
                else 1
            ),
            "wall_seconds": round(wall, 3),
            "control_plane_seconds": round(cp, 3),
            "reconciles": reconciles,
            "us_per_reconcile": round(1e6 * cp / max(reconciles, 1), 1),
            "all_ready": bool(pods) and all(is_ready(p) for p in pods),
        }
        if base_wall is None:
            base_wall = wall
        row["speedup"] = round(base_wall / max(wall, 1e-9), 2)
        if h.engine.workers is not None:
            row["utilization"] = h.engine.workers.utilization(wall)
        rows.append(row)
        h.engine.close()
        del h
        gc.collect()
    return {
        "sets": n_sets,
        "nodes": n_nodes,
        "shards": num_shards,
        "backend": backend,
        "sweep": rows,
    }


def process_codec_ab(
    n_sets: int = 256,
    n_nodes: int = 256,
    num_shards: int = 4,
    workers: int = 2,
    device=None,
) -> dict:
    """Paired coordinator-overlap and boundary-codec A/B (the JAX
    package's control-plane shape).

    Two process-backend converges of the SAME population, same build:

    - **off**: the pre-shave reflective wire decoder
      (``api/wire.py NO_MEMO``) and the overlap pump unhooked — the
      boundary/coordinator cost profile the process backend had before
      the shave;
    - **on**: memoized per-class decode plans + the scheduler's
      speculative-encode overlap pump (``engine.overlap_hook``).

    Reports µs/reconcile per arm (control-plane time: wall minus solver,
    exactly the worker_sweep metric) and the paired reduction, stamped
    with the ``"host"`` block (cores, backend) it ran on. Both arms must reconcile
    identically (same deterministic schedule) or the comparison is
    meaningless and the row says so."""
    from grove_tpu_torch.api import wire
    from grove_tpu_torch.observability.hostinfo import host_block

    tenants = tenant_namespaces(min(16, n_sets))
    # the warm-up takes the solver's first-call costs at the measured node
    # count, so neither arm is billed them
    _warm = _make_harness(n_nodes, num_shards, 1, device=device)
    _populate(_warm, n_sets, tenants)
    _warm.converge(max_ticks=60 + 8 * n_sets)
    _warm.engine.close()
    del _warm
    gc.collect()

    def _arm(shaved: bool) -> dict:
        h = _make_harness(n_nodes, num_shards, workers, backend="process", device=device)
        wire.NO_MEMO = not shaved
        if not shaved:
            h.engine.overlap_hook = None
        solver0 = METRICS.hist_sum.get("gang_solve_seconds", 0.0)
        r0 = _reconcile_count()
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            t0 = time.perf_counter()
            _populate(h, n_sets, tenants)
            h.converge(max_ticks=60 + 8 * n_sets)
            wall = time.perf_counter() - t0
        finally:
            gc.enable()
            gc.unfreeze()
            gc.collect()
            wire.NO_MEMO = False
        reconciles = _reconcile_count() - r0
        solver_s = METRICS.hist_sum.get("gang_solve_seconds", 0.0) - solver0
        cp = max(wall - solver_s, 0.0)
        stats = h.engine.workers.stats() if h.engine.workers else {}
        h.engine.close()
        del h
        gc.collect()
        return {
            "wall_seconds": round(wall, 3),
            "control_plane_seconds": round(cp, 3),
            "reconciles": reconciles,
            "us_per_reconcile": round(1e6 * cp / max(reconciles, 1), 1),
            "boundary_bytes": stats.get("boundary_bytes"),
        }

    off = _arm(shaved=False)
    on = _arm(shaved=True)
    reduction = 1.0 - (
        on["us_per_reconcile"] / max(off["us_per_reconcile"], 1e-9)
    )
    return {
        "shape": {
            "sets": n_sets,
            "nodes": n_nodes,
            "shards": num_shards,
            "workers": workers,
            "backend": "process",
        },
        "off": off,
        "on": on,
        "reconciles_identical": off["reconciles"] == on["reconciles"],
        "us_per_reconcile_reduction_pct": round(100.0 * reduction, 1),
        "gate_10pct_reduction": reduction >= 0.10
        and off["reconciles"] == on["reconciles"],
        "host": host_block(backend="process"),
    }
