"""On-card smoke test of the PyTorch port (grove_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: CUDA must be available; prints the card's name and power limit.
  2. build: compiles the kernels (csrc/fill.cu, csrc/drf.cu; sm_90a) from the
     sources, one nvcc each, all started together.
  3. kernel vs plain version on the card at the wave solver's fill shape
     (C=32 gangs, P=3 groups, N=5120 nodes, R=2 resources): shared and
     per-gang capacity, masks 0/50/100% dense, zero demands and zero counts;
     alloc, placed and free_after must be equal bit for bit. Times the kernel
     and the plain version (median device time of 50 calls, CUDA events).
  3b. kernel at the main paths' own shapes: fill calls recorded by a
     `fill=` passed to the solvers — from one chunk-wave of the binding
     path, (a)'s level fill (shared free, one-domain masks) and spill fill
     (per-gang free, all nodes, mostly zero counts, no free_after), (c)'s
     floors->extras pair, and (d)'s per-group fills (P=1: a floors fill on
     shared free, one on per-gang free, an extras fill, the rescue's last
     extras fill without free_after); from the stats path, (a)'s slab fill
     of groups 1..P-1 (per-gang free, no free_after); from the exact solve
     of (a), the stacked candidates (C = L+1) and the spill fill (C=1);
     each bit for bit against the plain version, then timed beside its
     bound.
  4. main path at full width: five requests through the sidecar's solve
     (solve_decoded): the 10,240-gang x 5,120-node stress batch, 2,048 more
     stress gangs against the capacity it left, a non-uniform batch of
     multi-group gangs with required/preferred pack keys, a disaggregated
     batch with a per-group ici-block pack on every group (d), and a
     spread + recovery batch (e: hard spread over ici-blocks with
     survivors, soft spread over hosts, gang and group recovery pins).
     Each result must be valid (usage <= capacity, floors met, required
     packs of gangs and of groups in one domain, pinned gangs and groups
     inside their pin's domain, required spreads over enough domains);
     fill launch counts are set to 0 just before each request and read
     just after it.
  5. the stats path (the repo's headline solve): (a) through
     solve_waves_stats, one warm-up and 10 timed runs (median, p99, min,
     max of solve_seconds), its admitted gangs, pods placed, waves and tail
     size equal to the JAX package's on the CPU and its score sum within
     1e-5 (JAX_STATS_REFERENCE); then, for quality_vs_exact, the stats
     and the exact solve (solve) of the first 2,048 gangs, both held
     against the JAX package's. Launch counts are set to 0 just before
     each solve and read just after it.
  6. each solver with the kernel vs the same solver with the plain fill,
     on reduced problems (1,024 nodes; stress and non-uniform at 512
     gangs, grouped, pinned and spread at 256): the binding path, the
     stats path and the exact solve (of the first 128 gangs), every result
     field bit-equal.
  7. [sched] the scheduler round end to end (solver/scheduler.GangScheduler
     over the port's store and simulated cluster, built from wire documents
     by models/scenarios.scheduler_world) on the card: (s) 10,240 stress
     gangs in one namespace on 5,120 nodes, an admission round and an
     upkeep round; (q) the same gangs over eight tenant queues, one round
     with the DRF order; (r) cut to 256 nodes, 512 gangs of one tenant,
     then 264 more of three others (8 of priority 100): reclaim and
     preemption with their trial solves. Every round is held against the
     JAX package's (JAX_SCHEDULER_REFERENCE, from
     scripts/scheduler_reference.py): the
     bindings' hash, admissions, evictions, per-queue counts and event
     counts equal, the score sum at rtol 1e-6; and checked valid (usage <=
     capacity, floors met, required packs in one domain). Prints each
     round's wall time, its split by the tracer's spans, solve_seconds and
     the fill and DRF launches (set to 0 just before each round, read just
     after it).
  8. [drf] the DRF kernels (csrc/drf.cu: the share table, then the merge)
     against their plain twin, bit for bit: every scan step of 200 random
     queue trees (tests/test_quota.py's generator, seed 7), the warp, block
     and owner edges Q=1, 32, 33, 64, 1024, 1025, 2048, 4096, the named
     edge trees (drf_edge_trees), a table too large for shared memory
     (Q=8, G=8192), counts above G at Q=64 and 1025, Q=57,601 and 65,536
     (taken counts in global memory, held to the plain two-phase version),
     and the ordering pass recorded from (q), where each kernel is also
     held to its plain version; times the share table, the merge and the
     whole pass at (q)'s shape, and the merge per step at the unstaged and
     wider shapes and at Q=65,536.
  9. [delta] the delta round (solver/deltastate.py through
     GangScheduler.enable_delta) on the churn world of
     models/scenarios.scheduler_world("delta"): (q)'s round, then 17
     (DELTA_TICKS, cut from 24) seeded churn ticks (arrivals, departures, pod failures with recovery
     pins, a node cordoned and uncordoned, a standing backlog, idle
     ticks), one scheduler and one store throughout, the A/B self-check
     (a from-scratch encode and solve of the same round) on every round.
     Every round is held against the JAX package's (JAX_DELTA_REFERENCE):
     round_summary as in [sched], the delta counters, the free matrix's
     crc32 and the state fingerprint's sha256; and checked valid. Prints
     each round's wall, its solve.delta_encode span, the self-check's time
     and the fill and DRF launches (set to 0 just before the round, read
     just after it), then the p50/p99 tick wall less the self-check. Fails
     unless a round reused the solve, one fell back to a full encode, one
     flap back reused the retired encoding, and the fill and both DRF
     kernels launched during the phase.
 10. [frontier] the partitioned frontier (solver/frontier.py through
     GangScheduler.enable_frontier) on (phi),
     models/scenarios.scheduler_world("frontier"): the churn world's (q)
     round and 6 of its ticks (FRONTIER_TICKS, cut from 16; 80 slices of
     64 nodes, so 80 subproblems in
     round 1), delta and frontier self-checks on every round. Every round
     is held against JAX_FRONTIER_REFERENCE: what [delta] holds and the
     deterministic fields of the frontier's stats(); and checked valid.
     Prints each round's wall, its solve.partition span less the frontier
     self-check, its buckets and stacked dispatches with the host time per
     dispatch, round 1 beside [delta]'s round 1, and the ticks' p50/p99
     wall less the self-checks. Fails unless a stacked dispatch held two or
     more real lanes, a gang went through the residual, the fill kernel
     launched from inside solve_waves_stacked with every launch taking all
     stacked lanes' chunk rows, and both DRF kernels launched. Then the fill
     at round 1's stacked shape (lanes folded into the gang axis) against
     its plain version, timed beside its bound.
 11. [sharded] the multi-GPU tier (grove_tpu_torch/parallel) on the one
     card: (a) (10,240 gangs x 5,120 nodes, chunk 128, 32 waves) through
     solve_stress_sharded in local ranks (parallel.multihost.run_ranks,
     which load the kernels built here): NCCL at world size 1, then 2 and
     4 gloo ranks sharing cuda:0. Every rank's admitted, placed, score,
     chosen_level, free_after, pending and waves must equal the
     single-device solve on the card bit for bit and JAX_SHARDED_REFERENCE
     (scripts/stats_reference.py sharded); at 2 and 4 ranks
     domain_aggregates_ring of gang 0 must equal the single-device
     aggregates, and at 2 ranks the sharded fill's identity cases the
     whole-axis kernel and the plain fill. Every rank must launch the fill
     kernel (its own count, zeroed just before its solve). Prints each
     world's solve time beside the single-device one, collectives per
     wave and fill launches per rank; the ranks share one card, so no
     multi-GPU speed is implied. The rank worlds run in their own
     processes while [operator] and [churn] (16 and 17), which time no
     kernel, run in the process of the chain [sharded] ... [sims]
     (phase_operator_chain, 11 and 16-21), started once [stats] (5) is
     done.
 12. [observe] the glass-box layer (observability/{tracing,metrics,journey,
     profile,explain}.py) on (q) at full width: the tracer, the gang
     journeys and the wall profiler on before the world loads, then round
     1, held to JAX_SCHEDULER_REFERENCE as in [sched] and, by
     models/scenarios.observe_summary, to JAX_OBSERVE_REFERENCE (the span
     multiset "name<parent", counters, gauges, histogram counts, Prometheus
     series, completed journeys; from scripts/scheduler_reference.py
     observe); the Chrome trace must validate, every Prometheus line parse,
     every admitted gang's journey hold all six phases and the profiler
     attribute at least 95 % of the round's wall. Then an explain burst on
     the same store (models/scenarios.explain_burst: every pending gang, a
     scheduled one, an unknown name, capacity(), a drain and a queue
     what-if), every document less its timing fields equal to the JAX
     engine's (sha256 of its canonical JSON) and the store's
     resourceVersion unmoved; the burst's trial solves must launch the fill
     kernel and its order views both DRF kernels (counted apart). Prints
     the traced wall beside [sched]'s (q) round 1, the profiler's top
     phases, explain p50/p99 and the all-off check's cost.
 13. [sidecar] the sidecar's wire layer (cluster/grpcsolver.py), when grpcio
     and protobuf are installed (else one line names the missing package and
     the phase runs nothing): the port's SolverServer on the card inside
     this process; (a) through SolverClient, every placement (admission,
     score, chosen level, assignments) equal to [main]'s solve_decoded
     answer; (q) round 1 through a GangScheduler whose solves (the round's
     and the reclaim trials') go to the sidecar, held to
     JAX_SCHEDULER_REFERENCE with no fallback; a health Check (SERVING) and
     a malformed request (INVALID_ARGUMENT). Prints the request and
     response sizes, the RPC wall beside [main]'s and the launches.
 14. [slo] the SLO observatory (observability/{timeseries,slo,forecast,
     flightrec}.py) on (delta)'s world at full width: round 1 and 6 churn
     ticks with the clock 10 s a round, the tracer, journeys, time series,
     SLO engine (two objectives: one breached, one met), forecaster and
     flight recorder on, the serving collector installed
     (models/scenarios.run_slo_world). Every round's summary and series
     windows, the final windows, the SLO status, the forecast and the
     flight bundle less timing equal to JAX_SLO_REFERENCE. Prints the round
     and tick walls beside [delta]'s, the all-off check and the launches.
 15. [disruption] the disruption layer (disruption/{broker,drain}.py,
     controller/{nodehealth,remediate}.py, autoscale/hpa.py, wired into the
     scheduler's preemption, reclaim and encode) on (omega) at full width
     (models/scenarios.run_disruption_world: (q)'s gangs with a
     PodCliqueSet and a disruption budget each, a delta scheduler with a
     broker and a node-health monitor, a drain controller and a
     remediator, the clock 10 s a round): the admission round, a fill, a
     preemption storm that opens the breaker, its close, two node crashes
     (a rescue and a requeue with a held round), a drain that relocates
     and one held by a budget, a fail-slow node the remediator drains.
     Every round's record (round_summary, trial solves, would_allow calls
     and refusals, broker, monitor, drains, ledger, events) and the
     script's choices equal to JAX_DISRUPTION_REFERENCE, every scripted
     event shown, the world valid at the end; the preemption, drain and
     what-if trials must launch the fill kernel and the phase both DRF
     kernels. Prints each round's walls and launches, the trials by kind
     and the grants, denials, breaker flips, rescues, requeues and drains.
     Runs in a process of its own (_PhaseProcess), started once [stats]
     (5) is done.
 16. [operator] the operator (runtime/engine.py, the PodCliqueSet,
     PodCliqueScalingGroup and PodClique controllers with the rolling
     update, admission, the store's lagged cache, the kubelet) through the
     port's sim/harness.SimHarness on (iota) at full width
     (models/scenarios.run_operator_world: BASELINE's integrated
     population, 10,240 PodCliqueSets on 5,120 nodes, converged with
     cyclic GC off, then the rolling update of the 640 simple1 sets and a
     second converge): every tick's (work, bound, started) and
     round_summary, and after each converge the store's census,
     resourceVersion, reconcile counts, canonical digest (uids as their
     creation rank), event counts and bindings hash equal to
     JAX_OPERATOR_REFERENCE, every pod Ready; then the ten samples
     (run_samples_world), each tree() and digest equal. The fill kernel
     must launch in (iota) and both DRF kernels in the samples (the Queue
     sample). The script runs under PYTHONHASHSEED=0 (it re-runs itself
     so): the controllers iterate sets of strings, and the reference was
     taken under that seed. The first fill calls of (iota), and the
     first of each other shape it gives the kernel (R=3: cpu, memory and
     tpu in the encode's rescaled units), are held against the plain fill
     on the same card tensors, bit for bit. Prints the apply and converge walls and ticks, the
     solver's share, microseconds per reconcile, the rolling update's
     wall and ticks, and the launches.
 17. [churn] (kappa) the sim package's delta churn (sim/deltachurn.
     delta_artifact, models/scenarios.run_churn_world) on (iota)'s harness
     after [operator]'s rolling update, run from [operator]: the warm-up,
     33 churn ticks with the A/B self-check every 16th tick and a cordon
     flap at tick 32, then 8 ticks with the delta state detached (cut from
     the bench's 96 and 32); every schedule call's round_summary, delta
     counters and self-check flag and the report's counters equal to
     JAX_CHURN_REFERENCE; the first 8 fill calls and the first of each
     other shape held against the plain fill bit for bit. Prints schedule
     p50/p99/mean, the full path's, speedup_mean, p99_lt_1s and launches.
 18. [scale] (lambda) the keyspace-sharded store (runtime/store.py,
     num_shards=8) under sim/scale: frontier_ab at the bench's full-size
     shape (4,096 one-clique eight-pod sets over 64 tenant namespaces on
     6,400 nodes; warm-ups, then the global and the partitioned-frontier
     arm) and inert_ab (192 sets on 64 nodes, S=1 against S=8), every
     retired harness's canonical dump digest (rv-normalised, Events left
     out, placement scores summed apart at rtol 1e-6), census, scalar
     resourceVersion, reconciles and frontier counters equal to
     JAX_SCALE_REFERENCE, the inert A/B identical and the sharded arms
     spread over two or more shards; the first two fill launches of each
     solve kind (global, stacked) and the first of each other shape held
     against the plain fill. Prints both walls, both solver times and the
     speedups (reported, not gated). Then (pi), the JAX bench's full-size
     configuration at that shape (models/scenarios.run_parallel_world):
     sim/scale.converge_population(4096, 6400, 8, frontier=True,
     glassbox=True, workers=4) through the process drain
     (runtime/procworkers.py, GROVE_TPU_CP_BACKEND=process: forked worker
     processes over the wire codec while this process holds the card), the
     overlap pump armed and a per-shard WAL (durability/) attached before
     the first commit; the report less times, the scalar rv, the dump
     digest, admissions, frontier counters, overlap hits and stale specs and
     every shard stream's records and durable-state digest equal to
     JAX_PARALLEL_REFERENCE["durability"], and the dump, reconciles and rv
     equal to the frontier arm's above (its serial twin); then the crash
     (a 53-byte torn tail), recover_store, the acked-prefix audit (empty),
     the recovered dump equal to the pre-crash one, and a cold restart with
     the same drain reconverging to the pre-crash resource_signature, with
     0 worker repatriations; then sim/parallel.process_codec_ab at its own
     shape (256 sets, 256 nodes, 4 shards, 2 workers) with its host block.
     The first fill calls of (pi)'s solves are held against the plain fill.
 19. [sims] (nu) sim/multitenant (the contended three-tenant run with
     reclaim, quota.warm, quota_snapshot; the single-queue A/B; the explain
     scenario's actors), sim/voluntary.drain_artifact, the run-level churn
     A/B (deltachurn.smoke_ab_run with and without the delta state) and
     the demo on simple1.yaml (sim/demo.run_demo), each equal to
     JAX_SIMS_REFERENCE; the fill and both DRF kernels must launch.
 20. [parallel] the parallel drain and durability at the JAX package's own
     shapes (models/scenarios.run_parallel_suite): sim/parallel.parallel_ab
     (48 sets, 32 nodes, 4 shards, 3 storm rounds) with per-shard WALs on
     both twins for the thread and the process drain, 2 and 4 workers,
     seeds 1234 and 7; a process drain whose worker is killed after its
     first batch and one with seeded drop, duplicate and delay on its wire,
     each against a serial twin; worker_sweep(192, 64, 8) for both
     backends; sim/recovery.durability_artifact(192, 192). Every report
     less its times equal to JAX_PARALLEL_REFERENCE["parallel"], every
     problems list empty (parallel_missing). The first fill calls are held
     against the plain fill. (pi) (phase_scale_parallel), and [parallel]
     followed by [scale]'s codec A/B (phase_scale_codec), run in two python
     processes of their own (_PhaseProcess: fork and exec, so neither holds
     a thread of this process, each its own CUDA context on the card):
     (pi)'s starts once [sharded]'s rank worlds have ended, beside the rest
     of [operator] and [churn]; the other, niced, starts with [scale],
     beside (lambda) and [sims]; [scale] reads their results after
     (lambda).
 21. [cluster] (tau) the real-cluster tier (cluster/{manager,apiserver,
     client,webhook,cert,extscheduler}.py) on the card: start_operator
     with the HTTP apiserver, TLS admission webhooks (openssl certificates;
     plain HTTP and a printed note where the machine has no openssl), the
     authorizer, the HttpStore, the controllers and the card-side
     GangScheduler on 5,120 nodes under deploy/operator.yaml's
     configuration; the first CLUSTER_SETS sets of (iota) POSTed as JSON and
     converged over HTTP (models/scenarios.run_cluster_world); the census
     by kind, gangs by phase, pods, GET /events records by reason and the
     bindings' sha256 equal to JAX_CLUSTER_REFERENCE, every binding valid,
     the first fill calls equal to the plain fill bit for bit; then the
     external scheduler (cluster/extscheduler.py) in a process of its own on
     the card against an operator without a scheduler (threaded drain),
     over the four BASELINE samples, every gang Running, its launches
     counted. Runs in a process of its own (_PhaseProcess), started with
     (pi)'s.
 22. [federation] the serving, chaos and federation worlds
     (sim/{traffic,remediation,chaos}.py, federation/{quota,router}.py,
     analysis/sanitize.py) on the card: (mu) serving_artifact(2026, 2, 16,
     900) and remediation_artifact(2026, 3, 24, 1200), the bench's shapes
     (models/scenarios.run_serving_world), printing the card's admission
     p99 through the flash crowd (the serving gate, p99 < 1 s); (chi) the
     chaos matrix (run_chaos_matrix: seeds 1234, 7 with the control-plane
     crash, 42 under the sanitizer, 99 with the remediator, 2026 with
     fail-slow, seed 7 on a 3-shard store, seed 1234 on 3 shards through 2
     process workers, the federation and partition chaos of seed 4242,
     federation_artifact(2026, 3, 8)), every verdict ok; (psi) three
     regions of 5,120 nodes with (q)'s eight tenant Queues
     (run_federation_world): a crash and rejoin of "us", then an overflow
     whose pending gangs spill in global DRF order over the level-3 fold.
     Every report less its wall fields equal to JAX_FEDERATION_REFERENCE
     (scripts/scheduler_reference.py federation); stage 2 must spill; (psi)
     must launch the fill and both DRF kernels, its first fill calls equal
     the plain fill and its first global-usage DRF passes the plain order
     twin, bit for bit. Prints each step's walls, counters, ledger length,
     fold and launches. Runs in a process of its own (_PhaseProcess, niced),
     started once the fill's timings (3 and 3b) are taken.
 23. [cli] the entry points (cli.py, __main__.py, initc/__main__.py) as users
     run them, each command a process of its own: every sim-backed
     subcommand at 5,120 nodes (`python -m grove_tpu_torch <sub> ...
     --nodes 5120` over samples/; queues over multitenant-queues.yaml's two
     Queue CRs) and the host-only ones (validate, config-check of
     deploy/operator.yaml's configuration, crds, api-docs,
     detect-topology); then live mode: `run --nodes 5120 --tls
     --authorizer` as a child, apply, get, tree, describe, scale, nodes,
     drain, uncordon, queues, explain, whatif, capacity, trace, profile,
     journey and delete with --apiserver, the initc waiter for the gang
     simple1-0 (exit 0 once its parents are Ready) and SIGINT (exit 0).
     Every exit code, and the stdout of every sim-mode command and of the
     live ones the converged state alone sets (less the uid's token, the
     apiserver's address and the durations of trace, profile and
     journey), equal to JAX_CLI_REFERENCE
     (scripts/scheduler_reference.py cli); cli.main in-process for apply
     and queues must launch the fill and both DRF kernels, their first
     calls equal to the plain versions bit for bit; scripts/torch_lint.py
     --json exits 0 with 0 violations and 9 suppressions. Runs in a process
     of its own (_PhaseProcess, niced), started once [frontier] is done.
 24. prints the kernels line, the card line, and last the ok line.

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def _fail(msg: str) -> None:
    raise RuntimeError(msg)


def phase_device() -> str:
    if not torch.cuda.is_available():
        _fail("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    from grove_tpu_torch.utils.platform import card_info

    line = ", ".join(card_info())  # as nvidia-smi prints name,power.limit
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | nvidia-smi: {line}", flush=True)
    return line


KERNEL_SOURCES = ("fill", "drf")  # grove_tpu_torch/csrc/<name>.cu


def phase_build() -> None:
    from grove_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_all(KERNEL_SOURCES)
    print(f"[build] {', '.join(n + '.cu' for n in KERNEL_SOURCES)} built (one nvcc each, all"
          f" started together) and loaded in {time.perf_counter() - t0:.3f} s", flush=True)
    for name in KERNEL_SOURCES:
        log = _build.BUILD_LOGS.get(name, "(prebuilt library reused)")
        for ln in log.strip().splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build]   {name}: {ln.strip()}", flush=True)


def _fill_inputs(rng, c, p, n, r, shared, density):
    free = rng.integers(0, 129, (n, r) if shared else (c, n, r)).astype(np.float32)
    mask = rng.random((c, n)) < density
    demand = rng.integers(0, 9, (c, p, r)).astype(np.float32)
    demand[rng.random((c, p, r)) < 0.2] = 0.0  # zero demand = no limit
    count = rng.integers(0, 40, (c, p)).astype(np.int32)
    count[rng.random((c, p)) < 0.2] = 0  # zero counts
    return [torch.from_numpy(a).cuda() for a in (free, mask, demand, count)]


def _median_ms(fn, reps=50, warmup=5, tries=4):
    """Median device time of one call of fn, in ms, over `reps` calls. Each
    call is enqueued between a pair of CUDA events while a spin kernel ahead
    of it keeps the card busy, so the pair brackets device work only, not
    the host's launch latency. The spin is sized from the host's own time
    per call, at the card's highest clock (2 GHz bounds an H100). A pair
    whose enqueue outran the spin (a stall of the shared host) is thrown
    away and measured again behind a spin twice as long; only `tries`
    misses in a row fail."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    spin_s = 3.0 * (time.perf_counter() - t0) / warmup + 1e-3
    torch.cuda.synchronize()
    times = []
    misses = 0
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * 2.0e9))
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        enqueue_s = time.perf_counter() - t0
        end.synchronize()
        if enqueue_s <= spin_s:
            times.append(start.elapsed_time(end))
            misses = 0
            continue
        misses += 1
        print(f"[timing] host stall: enqueue {enqueue_s:.4f} s outran the spin"
              f" {spin_s:.4f} s; measuring that call again", flush=True)
        if misses >= tries:
            _fail(f"timing: the host fell behind the card {tries} times in a row")
        spin_s *= 2.0
    return statistics.median(times)


def _fill_bound(args, with_free_after=True):
    """Least time for one fill at these inputs, from what the outputs need:
    the counts; a gang's mask only where one of its counts is nonzero; its
    free and demands only then, or when free_after is asked for (a zero
    take still debits a -0.0 demand) — each read once; alloc and placed,
    and free_after when asked for, written once; over HBM bandwidth.
    Operations (per group with a nonzero count and node inside the gang's
    mask: divide, floor, compare, min, multiply, subtract per resource, plus
    the clip, cap, prefix add and take) over the fp32 rate. Returns
    (ms, by)."""
    free, mask, demand, count = args
    c, p, r = demand.shape
    n = mask.shape[-1]
    active = count != 0  # [C, P]
    gangs = int(active.any(1).sum())  # gangs that take anything
    free_gangs = c if with_free_after else gangs
    if free.dim() == 2:
        free_bytes = n * r * 4 if free_gangs else 0
    else:
        free_bytes = free_gangs * n * r * 4
    demand_bytes = (c * p if with_free_after else int(active.sum())) * r * 4
    read = free_bytes + gangs * n + demand_bytes + count.numel() * 4
    written = c * p * n * 4 + c * p * 4 + (c * n * r * 4 if with_free_after else 0)
    inside = mask.to(torch.bool).sum(1)  # [C]
    ops = int((active.sum(1) * inside).sum()) * (6 * r + 4)
    t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check_equal(tag, out, ref):
    """alloc, placed and free_after (or None on both sides) bit for bit;
    returns the largest absolute difference (0.0 when they are equal)."""
    max_err = 0.0
    for name, a, b in zip(("alloc", "placed", "free_after"), out, ref):
        if a is None or b is None:
            if a is not b:
                _fail(f"fill kernel != plain ({tag}: {name} is None on one side only)")
            continue
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            _fail(f"fill kernel != plain ({tag}: {name})")
        if a.numel():
            max_err = max(max_err, float((a.double() - b.double()).abs().max()))
    return max_err


def phase_kernel_vs_plain() -> dict:
    from grove_tpu_torch.ops.fill import fill_batch, fill_batch_ref

    rng = np.random.default_rng(0)
    c, p, n, r = 32, 3, 5120, 2
    max_err = 0.0
    for shared in (True, False):
        for density in (0.0, 0.5, 1.0):
            args = _fill_inputs(rng, c, p, n, r, shared, density)
            out = fill_batch(*args)
            torch.cuda.synchronize()
            tag = f"shared={shared}, density={density}"
            max_err = max(max_err, _check_equal(tag, out, fill_batch_ref(*args)))
            placed_total = int(out[1].sum())
            print(f"[kernel] shared={shared!s:5} density={density:.1f}: equal bit for bit"
                  f" (placed {placed_total})", flush=True)
    args = _fill_inputs(rng, c, p, n, r, True, 0.5)
    ms = _median_ms(lambda: fill_batch(*args))
    plain_ms = _median_ms(lambda: fill_batch_ref(*args))
    bound_ms, bound_by = _fill_bound(args)
    print(f"[kernel] fill_batch C={c} P={p} N={n} R={r}: kernel {ms * 1e3:.2f} us,"
          f" plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us ({bound_by}),"
          f" {100 * bound_ms / ms:.1f} % of bound"
          " (median device time of 50 calls, CUDA event pairs)", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": max_err}


class _Captured(Exception):
    """Ends a solve once the recording fill holds the calls it was after."""


def capture_fill_calls(run, n_calls):
    """The arguments of the first `n_calls` fill calls of `run(fill)`, a
    solve on the card given a `fill=` that records each call (and still
    runs the kernel, so the solve proceeds as usual)."""
    from grove_tpu_torch.ops.fill import fill_batch

    calls = []

    def recording_fill(free, mask, demand, count, with_free_after=True):
        args = tuple(t.clone() for t in (free, mask, demand, count))
        calls.append((args, {"with_free_after": with_free_after}))
        out = fill_batch(free, mask, demand, count, with_free_after=with_free_after)
        if len(calls) == n_calls:
            raise _Captured
        return out

    try:
        run(recording_fill)
    except _Captured:
        return calls
    _fail(f"the solve made fewer than {n_calls} fill calls")


def path_fill_cases():
    """Fill calls of the main paths at full width: from one chunk-wave of
    the binding path, (a)'s level fill and spill fill, (c)'s floors->extras
    pair, and (d)'s P=1 fills (the first group's floors on shared free, the
    second group's floors on per-gang free, the first group's extras, and
    the rescue pass's last extras fill without free_after); from the stats
    path's first chunk of (a), the slab fill's groups 1..P-1 (per-gang
    free, no free_after); from the exact solve of (a), the first gang's
    stacked candidates (C = L+1 rows) and its spill fill (C=1)."""
    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.models.scenarios import STRESS_CAPACITY, stress_gang_specs
    from grove_tpu_torch.sim.cluster import make_nodes
    from grove_tpu_torch.solver.encode import StickyGroupPad, build_problem
    from grove_tpu_torch.solver.kernel import solve, solve_waves, solve_waves_stats

    topology = ClusterTopology()
    nodes = make_nodes(5120, dict(STRESS_CAPACITY), 8, 8)
    cases = []

    def binding(problem):
        return lambda fill: solve_waves(problem, device="cuda", fill=fill)

    stress = None
    for specs, names in (
        (stress_gang_specs(10240, seed=0), ("a_level", "a_spill")),
        (nonuniform_specs(4096, seed=2), ("c_floors", "c_extras")),
    ):
        problem = build_problem(nodes, specs, topology,
                                pad_groups=StickyGroupPad().grow(specs))
        stress = stress or problem
        for name, call in zip(names, capture_fill_calls(binding(problem), len(names))):
            cases.append((name, *call))
    specs = disagg_specs(4096, seed=5)
    problem = build_problem(nodes, specs, topology, pad_groups=StickyGroupPad().grow(specs))
    p = problem.max_groups  # 2P fills in each of the chunk-wave's two dispatches
    calls = capture_fill_calls(binding(problem), 4 * p)
    for name, index in (("d_floors_g0", 0), ("d_floors_g1", 1), ("d_extras_g0", p),
                        ("d_rescue_extras_last", 4 * p - 1)):
        cases.append((name, *calls[index]))
    (call,) = capture_fill_calls(
        lambda fill: solve_waves_stats(stress, device="cuda", fill=fill), 1)
    cases.append(("a_slab_rest", *call))
    exact = capture_fill_calls(
        lambda fill: solve(stress, with_alloc=False, device="cuda", fill=fill), 2)
    for name, call in zip(("a_exact_candidates", "a_exact_spill"), exact):
        cases.append((name, *call))
    return cases


def phase_path_shapes() -> list:
    """The kernel at the main path's own fill shapes: bit for bit against
    the plain version, then its median device time beside its bound."""
    from grove_tpu_torch.ops.fill import fill_batch, fill_batch_ref

    results = []
    for name, args, kw in path_fill_cases():
        out = fill_batch(*args, **kw)
        torch.cuda.synchronize()
        err = _check_equal(name, out, fill_batch_ref(*args, **kw))
        ms = _median_ms(lambda: fill_batch(*args, **kw))
        bound_ms, bound_by = _fill_bound(args, **kw)
        free, mask, demand, count = args
        c, p, r = demand.shape
        share = bound_ms / ms
        print(f"[shapes] {name}: C={c} P={p} N={mask.shape[-1]} R={r}"
              f" free {'shared' if free.dim() == 2 else 'per-gang'},"
              f" mask {float(mask.float().mean()):.4f} dense,"
              f" nonzero counts {int((count != 0).sum())}/{count.numel()},"
              f" free_after {'yes' if kw['with_free_after'] else 'no'}: equal bit for bit;"
              f" kernel {ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us ({bound_by}),"
              f" {100 * share:.1f} % of bound", flush=True)
        results.append({"case": name, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "share_of_bound": share, "max_abs_err": err})
    return results


def nonuniform_specs(n_gangs: int, seed: int):
    """Multi-group gangs with floors below counts (min_count < count) and
    pack keys: required slice + preferred ici-block, preferred ici-block
    only, preferred host only."""
    rng = np.random.default_rng(seed)
    keys = [
        ("cloud.google.com/gke-tpu-slice", "cloud.google.com/gke-tpu-ici-block"),
        (None, "cloud.google.com/gke-tpu-ici-block"),
        (None, "kubernetes.io/hostname"),
    ]
    specs = []
    for i in range(n_gangs):
        groups = []
        for q in range(int(rng.integers(2, 4))):
            count = int(rng.integers(2, 7))
            groups.append({
                "name": f"n{i}-{q}",
                "demand": {"tpu": float(rng.integers(1, 3)), "cpu": float(rng.integers(1, 9))},
                "count": count,
                "min_count": int(rng.integers(1, count)),
            })
        required, preferred = keys[i % 3]
        specs.append({"name": f"n{i}", "groups": groups, "required_key": required,
                      "preferred_key": preferred, "priority": 0})
    return specs


SLICE = "cloud.google.com/gke-tpu-slice"
BLOCK = "cloud.google.com/gke-tpu-ici-block"
HOST = "kubernetes.io/hostname"


def _groups(rng, prefix, n_groups, count_lo, count_hi):
    """Groups of `count_lo`..`count_hi` pods, 1 <= floor <= count, demand
    {tpu: 1-2, cpu: 1-8}."""
    groups = []
    for q in range(n_groups):
        count = int(rng.integers(count_lo, count_hi + 1))
        groups.append({
            "name": f"{prefix}-{q}",
            "demand": {"tpu": float(rng.integers(1, 3)), "cpu": float(rng.integers(1, 9))},
            "count": count,
            "min_count": int(rng.integers(1, count + 1)),
        })
    return groups


def disagg_specs(n_gangs: int, seed: int):
    """(d) Disaggregated serving: 2-4 scaling groups of 2-6 pods per gang,
    every group packed inside one ici-block (samples/multinode-
    disaggregated.yaml: packDomain ici-block per scaling group); half the
    gangs also pack the whole gang inside one slice."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n_gangs):
        groups = _groups(rng, f"d{i}", int(rng.integers(2, 5)), 2, 6)
        for grp in groups:
            grp["required_key"] = BLOCK
        specs.append({"name": f"d{i}", "groups": groups, "required_key": SLICE if i % 2 else None,
                      "preferred_key": None, "priority": 0})
    return specs


def spread_recovery_specs(n_gangs: int, seed: int, n_nodes: int,
                          kinds=("spread", "soft", "recovery")):
    """(e) Fault-tolerant serving and recovery, the kinds in turn:
    spread — samples/spread-serving.yaml: pack one slice, hard spread over
    >= 3 ici-blocks, 2-3 groups of 2-4 pods; one gang in four carries two
    survivors inside one block. soft — soft spread over >= 4 hosts, no
    pack. recovery — a delta-solve after a node failure: half pin the
    whole gang to a survivor's slice, half pin an ici-block-packed group to
    its survivor's block; pin nodes drawn over the whole cluster."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n_gangs):
        kind = kinds[i % len(kinds)]
        spec = {"name": f"e{i}", "required_key": None, "preferred_key": None, "priority": 0}
        if kind == "spread":
            spec["groups"] = _groups(rng, f"e{i}", int(rng.integers(2, 4)), 2, 4)
            spec.update(required_key=SLICE, spread_key=BLOCK, spread_min_domains=3,
                        spread_required=True)
            if i % 4 == 0:
                first = 8 * int(rng.integers(0, n_nodes // 8))  # 8 hosts per block
                spec["spread_survivor_nodes"] = [f"node-{first}", f"node-{first + 1}"]
        elif kind == "soft":
            spec["groups"] = _groups(rng, f"e{i}", int(rng.integers(1, 4)), 2, 4)
            spec.update(spread_key=HOST, spread_min_domains=4, spread_required=False)
        else:
            spec["groups"] = _groups(rng, f"e{i}", int(rng.integers(1, 4)), 1, 4)
            pin = f"node-{int(rng.integers(0, n_nodes))}"
            if (i // len(kinds)) % 2 == 0:
                spec.update(required_key=SLICE, gang_pinned_node=pin)
            else:
                spec["groups"][0].update(required_key=BLOCK, pinned_node=pin)
        specs.append(spec)
    return specs


def _one_domain(tag, what, labels, nodes_used, key, pin=None):
    domains = {labels[node][key] for node in nodes_used}
    if len(domains) > 1:
        _fail(f"{tag}: {what} spans {len(domains)} domains of {key}")
    if pin is not None and domains and domains != {labels[pin][key]}:
        _fail(f"{tag}: {what} lies outside its pin's domain of {key}")


def check_valid(tag, nodes, specs, capacity, response) -> dict:
    """Usage <= capacity on every node, floors met by every admitted gang;
    every required pack (of a gang or of a group) inside one domain of its
    key, a pinned gang or group inside its pin node's domain there, a
    required spread over at least min(spread_min, live pods) domains of its
    key (survivors counted); scores finite in [0, 1]. Returns the capacity
    left per node."""
    spec_by_name = {s["name"]: s for s in specs}
    left = {name: dict(cap) for name, cap in capacity.items()}
    labels = {nd.name: nd.labels for nd in nodes}
    placements = response["placements"]
    if len(placements) != len(specs):
        _fail(f"{tag}: {len(placements)} placements for {len(specs)} gangs")
    for pl in placements:
        score = pl["placement_score"]
        if not (np.isfinite(score) and 0.0 <= score <= 1.0):
            _fail(f"{tag}: gang {pl['gang']} score {score}")
        if not pl["admitted"]:
            if pl["assignments"]:
                _fail(f"{tag}: rejected gang {pl['gang']} has assignments")
            continue
        spec = spec_by_name[pl["gang"]]
        demand = {g["name"]: g["demand"] for g in spec["groups"]}
        per_group = {}
        for group, node, count in pl["assignments"]:
            per_group[group] = per_group.get(group, 0) + count
            for res, qty in demand[group].items():
                left[node][res] = left[node].get(res, 0.0) - qty * count
        for g in spec["groups"]:
            if per_group.get(g["name"], 0) < g["min_count"]:
                _fail(f"{tag}: gang {pl['gang']} group {g['name']} below its floor")
        used_nodes = [node for _, node, _ in pl["assignments"]]
        if spec.get("required_key"):
            _one_domain(tag, f"gang {pl['gang']}", labels, used_nodes, spec["required_key"],
                        spec.get("gang_pinned_node"))
        for g in spec["groups"]:
            if g.get("required_key"):
                _one_domain(tag, f"group {g['name']}", labels,
                            [node for grp, node, _ in pl["assignments"] if grp == g["name"]],
                            g["required_key"], g.get("pinned_node"))
        if spec.get("spread_required"):
            survivors = spec.get("spread_survivor_nodes") or []
            key = spec["spread_key"]
            spanned = {labels[node][key] for node in used_nodes + survivors}
            live = sum(per_group.values()) + len(survivors)
            if len(spanned) < min(spec.get("spread_min_domains", 2), live):
                _fail(f"{tag}: gang {pl['gang']} spreads over {len(spanned)} domains of {key}")
    for name, res in left.items():
        for r, v in res.items():
            if v < -1e-6 * max(1.0, capacity[name].get(r, 0.0)):
                _fail(f"{tag}: node {name} over capacity on {r} ({v})")
    return left


def phase_main_path() -> dict:
    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.cluster.grpcsolver import solve_decoded
    from grove_tpu_torch.models.scenarios import STRESS_CAPACITY, stress_gang_specs
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.sim.cluster import make_nodes
    from grove_tpu_torch.solver.encode import StickyGroupPad

    topology = ClusterTopology()
    pad = StickyGroupPad()  # the endpoint's sticky group padding
    nodes = make_nodes(5120, dict(STRESS_CAPACITY), 8, 8)
    full = {nd.name: dict(nd.capacity) for nd in nodes}
    requests = [
        ("a: stress 10240 gangs x 5120 nodes", stress_gang_specs(10240, seed=0), None),
        ("b: stress 2048 more gangs on what (a) left", stress_gang_specs(2048, seed=1), "left"),
        ("c: non-uniform 4096 multi-group gangs, pack keys", nonuniform_specs(4096, seed=2), None),
        ("d: disaggregated 4096 gangs, ici-block pack per group", disagg_specs(4096, seed=5), None),
        ("e: spread + recovery 2048 gangs", spread_recovery_specs(2048, seed=6, n_nodes=5120),
         None),
    ]
    summary = {}
    left = None
    counts = []
    for tag, specs, cap_from in requests:
        capacity = left if cap_from == "left" else full
        fill_batch.launches = 0
        t0 = time.perf_counter()
        response = solve_decoded(nodes, specs, topology, device="cuda",
                                 free_capacity=capacity, pad_groups=pad)
        wall = time.perf_counter() - t0
        launches = fill_batch.launches
        counts.append(launches)
        new_left = check_valid(tag, nodes, specs, capacity, response)
        if cap_from is None and left is None:
            left = new_left
        admitted = sum(p["admitted"] for p in response["placements"])
        s = response["solve_seconds"]
        print(f"[main] {tag}: solve_seconds {s:.3f} (wall incl. encode {wall:.3f}),"
              f" admitted {admitted}/{len(specs)}, {len(specs) / s:.1f} gangs/s,"
              f" fill launches {launches}; valid", flush=True)
        summary[tag[0]] = {"solve_seconds": s, "wall_s": wall, "admitted": admitted,
                           "gangs": len(specs), "fill_launches": launches}
        if tag[0] == "a":
            summary["a_response"] = response  # [sidecar] holds its RPC to it
    total = sum(counts)
    if min(counts) == 0:
        _fail(f"main path did not launch the fill kernel (launches {counts})")
    summary["launches"] = total
    return summary


# The JAX package's results for the stress request (a) and its 2,048-gang
# cut, from `JAX_PLATFORMS=cpu python scripts/stats_reference.py` (JAX 0.9.0
# on the CPU): the stats solve's admitted gangs, pods placed, waves, tail
# size and score sum, and (for the cut) the exact solve's admitted gangs
# and score sum.
JAX_STATS_REFERENCE = {
    10240: {"admitted": 10232, "pods_placed": 34828, "waves": 8, "tail": 8,
            "score_sum": 10117.439693391323},
    2048: {"admitted": 2048, "pods_placed": 7048, "waves": 1, "tail": 0,
           "score_sum": 2030.1599200367928, "exact_admitted": 2048,
           "exact_score_sum": 2026.494970858097},
}
STATS_RUNS = 10  # timed stats solves of (a), after one warm-up
# gangs of the stress request whose exact solve gives quality_vs_exact: the
# first 2,048, as the exact solve of all 10,240 took 87.8 s on an H100
# 80GB HBM3 at 700 W (`scripts/torch_solve_profile.py --path exact` times it)
EXACT_GANGS = 2048
# gangs of each reduced problem whose exact solve is held against the plain
# fill (the binding and stats paths take them all): 128, cut with PATH_GANGS
EXACT_PATH_GANGS = 128


class _RecordWaveSolve:
    """Keeps the output dict of the stats path's wave solve
    (``solver.kernel.solve_waves_device``) for reading after the solve."""

    def __enter__(self):
        from grove_tpu_torch.solver import kernel

        self.kernel, self.wrapped, self.out = kernel, kernel.solve_waves_device, None

        def record(*args, **kwargs):
            self.out = self.wrapped(*args, **kwargs)
            return self.out

        kernel.solve_waves_device = record
        return self

    def __exit__(self, *exc):
        self.kernel.solve_waves_device = self.wrapped


def _check_stats(tag, problem, res, ref, waves, tail):
    """The stats solve's result against the JAX package's (counts exactly,
    the score sum at rtol 1e-5), with its scores in [0, 1] and its capacity
    left equal to the capacity less what the placed pods use."""
    admitted, pods = int(res.admitted.sum()), int(res.placed.sum())
    score_sum = float(res.score.astype(np.float64).sum())
    got = {"admitted": admitted, "pods_placed": pods, "waves": waves, "tail": tail}
    for key, value in got.items():
        if value != ref[key]:
            _fail(f"{tag}: {key} {value} != the JAX package's {ref[key]}")
    if not np.isclose(score_sum, ref["score_sum"], rtol=1e-5, atol=0):
        _fail(f"{tag}: score sum {score_sum} != the JAX package's {ref['score_sum']}")
    if not (np.isfinite(res.score).all() and (res.score >= 0).all() and (res.score <= 1).all()):
        _fail(f"{tag}: scores outside [0, 1]")
    used = np.einsum("gp,gpr->r", res.placed.astype(np.float64), problem.demand)
    freed = problem.capacity.sum(0, dtype=np.float64) - res.free_after.sum(0, dtype=np.float64)
    if not np.allclose(used, freed, rtol=1e-6) or (res.free_after < 0).any():
        _fail(f"{tag}: capacity left does not match the pods placed")
    return score_sum


def phase_stats_path() -> dict:
    """The headline solve: (a) through solve_waves_stats, one warm-up and
    STATS_RUNS timed runs, held against the JAX package's results; then the
    stats and the exact solve of the first EXACT_GANGS gangs for
    quality_vs_exact."""
    from grove_tpu_torch.models.scenarios import build_stress_problem
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.solver.kernel import solve, solve_waves_stats

    problem = build_stress_problem(5120, 10240)
    solve_waves_stats(problem, device="cuda")  # warm-up
    times, launches = [], []
    for _ in range(STATS_RUNS):
        fill_batch.launches = 0
        with _RecordWaveSolve() as rec:
            res = solve_waves_stats(problem, device="cuda")
        launches.append(fill_batch.launches)
        times.append(res.solve_seconds)
        waves, tail = int(rec.out["waves"]), int(rec.out["pending"].sum())
        _check_stats("stats (a)", problem, res, JAX_STATS_REFERENCE[10240], waves, tail)
    if min(launches) == 0 or len(set(launches)) != 1:
        _fail(f"stats path: fill launches per run {launches}")
    # quality_vs_exact: the stats and the exact solve of the first
    # EXACT_GANGS gangs on the same nodes
    cut_problem = build_stress_problem(5120, EXACT_GANGS)
    ref = JAX_STATS_REFERENCE[EXACT_GANGS]
    with _RecordWaveSolve() as rec:
        cut = solve_waves_stats(cut_problem, device="cuda")
    cut_sum = _check_stats(f"stats of the first {EXACT_GANGS} gangs", cut_problem, cut, ref,
                           int(rec.out["waves"]), int(rec.out["pending"].sum()))
    fill_batch.launches = 0
    exact = solve(cut_problem, with_alloc=False, device="cuda")
    exact_launches = fill_batch.launches
    exact_sum = float(exact.score.astype(np.float64).sum())
    if int(exact.admitted.sum()) != ref["exact_admitted"] or not np.isclose(
            exact_sum, ref["exact_score_sum"], rtol=1e-5, atol=0):
        _fail(f"exact solve: {int(exact.admitted.sum())} admitted, score sum {exact_sum};"
              f" the JAX package's {ref['exact_admitted']}, {ref['exact_score_sum']}")
    if exact_launches == 0:
        _fail("the exact solve did not launch the fill kernel")
    quality = cut_sum / exact_sum
    times_sorted = sorted(times)
    out = {
        "median_s": float(np.median(times)), "p99_s": float(np.percentile(times, 99)),
        "min_s": times_sorted[0], "max_s": times_sorted[-1], "runs": len(times),
        "waves": waves, "tail": tail, "admitted": int(res.admitted.sum()),
        "pods_placed": int(res.placed.sum()), "fill_launches": launches[0],
        "quality_vs_exact": quality, "quality_eval_gangs": EXACT_GANGS,
        "exact_solve_seconds": exact.solve_seconds, "exact_fill_launches": exact_launches,
    }
    print(f"[stats] (a) solve_waves_stats 10240 gangs x 5120 nodes, {len(times)} runs after a"
          f" warm-up: median {out['median_s']:.4f} s, p99 {out['p99_s']:.4f} s (linear"
          f" interpolation), min {out['min_s']:.4f} s, max {out['max_s']:.4f} s; waves {waves},"
          f" tail {tail}, admitted {out['admitted']}, pods placed {out['pods_placed']}, fill"
          f" launches {launches[0]} per solve; equal to the JAX package's counts, score sum"
          f" within 1e-5", flush=True)
    print(f"[stats] exact solve of the first {EXACT_GANGS} gangs: {exact.solve_seconds:.3f} s,"
          f" admitted {int(exact.admitted.sum())}, fill launches {exact_launches};"
          f" quality_vs_exact {quality:.6f}", flush=True)
    return out


# stress and non-uniform gangs of [path_kernel_vs_plain] (grouped, pinned and
# spread take half): 2,048 until [operator] came, 1,024 with it; 512 (exact
# 128) since [scale]'s (pi) and [parallel] came, to keep the smoke's phases
# near 1,000 s on an H100 80GB HBM3, 700 W (PERF.md section 4)
PATH_GANGS = 512


def phase_path_kernel_vs_plain() -> None:
    """Each solver with the kernel against the same solver with the plain
    fill, on reduced problems (1,024 nodes): the binding path (with
    allocations), the stats path and the exact solve; every result field
    bit-equal (capacity by its bits)."""
    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.models.scenarios import STRESS_CAPACITY, stress_gang_specs
    from grove_tpu_torch.ops.fill import fill_batch, fill_batch_ref
    from grove_tpu_torch.sim.cluster import make_nodes
    from grove_tpu_torch.solver.encode import build_problem
    from grove_tpu_torch.solver.kernel import solve, solve_waves, solve_waves_stats

    def exact(problem, **kw):
        return solve(problem, with_alloc=False, **kw)

    nodes = make_nodes(1024, dict(STRESS_CAPACITY), 8, 8)
    for tag, specs in (("stress", stress_gang_specs(PATH_GANGS, seed=3)),
                       ("non-uniform", nonuniform_specs(PATH_GANGS, seed=4)),
                       ("grouped", disagg_specs(PATH_GANGS // 2, seed=7)),
                       ("pinned", spread_recovery_specs(PATH_GANGS // 2, 8, 1024,
                                                        kinds=("recovery",))),
                       ("spread", spread_recovery_specs(PATH_GANGS // 2, 9, 1024,
                                                        kinds=("spread", "soft")))):
        problem = build_problem(nodes, specs, ClusterTopology())
        flag = {"grouped": problem.group_req, "pinned": problem.gang_pin,
                "spread": problem.spread_level}.get(tag)
        if flag is not None and not (flag >= 0).any():
            _fail(f"the {tag} problem sets no {tag} constraint")
        exact_problem = build_problem(nodes, specs[:EXACT_PATH_GANGS], ClusterTopology())
        for path, run, prob in (("binding", solve_waves, problem),
                                ("stats", solve_waves_stats, problem),
                                ("exact", exact, exact_problem)):
            kern = run(prob, device="cuda", fill=fill_batch)
            plain = run(prob, device="cuda", fill=fill_batch_ref)
            for field in ("admitted", "placed", "score", "chosen_level", "alloc", "free_after"):
                a, b = getattr(kern, field), getattr(plain, field)
                if a is None and b is None:
                    continue
                if a is None or b is None or a.dtype != b.dtype or not np.array_equal(
                        a.view(np.int32) if field == "free_after" else a,
                        b.view(np.int32) if field == "free_after" else b):
                    _fail(f"{path} path with kernel != with plain fill ({tag}: {field})")
            gangs = len(specs[:EXACT_PATH_GANGS] if path == "exact" else specs)
            print(f"[path] {tag} 1024 nodes x {gangs} gangs, {path}: kernel path == plain"
                  f" path on every field (admitted {int(kern.admitted.sum())}; kernel"
                  f" {kern.solve_seconds:.3f} s, plain {plain.solve_seconds:.3f} s)", flush=True)


# The JAX package's scheduler rounds on the worlds of
# models/scenarios.scheduler_world, from `JAX_PLATFORMS=cpu python
# scripts/scheduler_reference.py` (JAX 0.9.0 on the CPU): per round, gangs
# admitted, pods bound, the placement score sum, the sha256 of the sorted
# ns/pod=node bindings, the evicted gangs (count and sha256 of the sorted
# names), admitted gangs per queue and event counts by reason.
_NONE = "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"
JAX_SCHEDULER_REFERENCE = {
    "s": [
        {"admitted": 10235, "bound": 34865, "score_sum": 10116.369945168495,
         "bindings": 34865,
         "bindings_sha256": "c93b1fb1180d523e501e2157bab7489466f6e192c4b60c108aedc04e6e63987f",
         "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"default": 10235},
         "events_by_reason": {"GangAdmitted": 10235, "GangDeferred": 5, "PodBound": 34865}},
        {"admitted": 3, "bound": 16, "score_sum": 1.6911112666130066, "bindings": 34881,
         "bindings_sha256": "1561fdabf3ae514bf795fd28bfabe7354207aa14d665c7167939b214f5506d4f",
         "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"default": 3},
         "events_by_reason": {"GangAdmitted": 3, "GangDeferred": 2, "PodBound": 16}},
    ],
    "q": [
        {"admitted": 10231, "bound": 34833, "score_sum": 10084.246239542961,
         "bindings": 34833,
         "bindings_sha256": "7ff9f94016b74cc5ea0e31eb3c29f4ea4fe0ae8f674ab4586e1f50bd4f7c744a",
         "evicted": 0, "evicted_sha256": _NONE,
         "admitted_per_queue": {"tenant-0": 1271, "tenant-1": 1280, "tenant-2": 1280,
                                "tenant-3": 1280, "tenant-4": 1280, "tenant-5": 1280,
                                "tenant-6": 1280, "tenant-7": 1280},
         "events_by_reason": {"GangAdmitted": 10231, "GangDeferred": 9, "PodBound": 34833}},
    ],
    # (r) cut to SCHED_CUTS["r"]: scheduler_reference.py r --nodes 256 --gangs 512
    "r": [
        {"admitted": 512, "bound": 1754, "score_sum": 505.18571746349335, "bindings": 1754,
         "bindings_sha256": "4e3bf248231e68f5420e35e8b5c287cb9f9e1518752c2a74441e8a9dfc5f1a4f",
         "evicted": 0, "evicted_sha256": _NONE,
         "admitted_per_queue": {"tenant-0": 512},
         "events_by_reason": {"GangAdmitted": 512, "PodBound": 1754}},
        {"admitted": 25, "bound": 83, "score_sum": 19.85740837454796, "bindings": 1837,
         "bindings_sha256": "eeabfe9936935b72c65e783083968ab6fb916bdc86c7f741fdae00e1a53b0be8",
         "evicted": 185,
         "evicted_sha256": "098e44af54e00d725106532e1b7db7a119e332117e5d533b9837336f3103a258",
         "admitted_per_queue": {"tenant-1": 8, "tenant-2": 9, "tenant-3": 8},
         "events_by_reason": {"GangAdmitted": 25, "GangDeferred": 239, "PodBound": 83,
                              "Preempted": 3, "QuotaReclaim": 182}},
    ],
}
SCHED_WORLDS = (("s", "flat"), ("q", "fair-share"), ("r", "preemption + reclaim"))
# (n_nodes, n_gangs) a world is cut to: (r) runs 256 nodes and 512 gangs (182
# reclaims, 742 trial solves) since [scale]'s (pi) and [parallel] came
# (PERF.md section 4)
SCHED_CUTS = {"r": (256, 512)}


def check_world_valid(tag, store, cluster) -> None:
    """Usage <= capacity on every node (live bound pods), every scheduled
    gang's groups at or above their floor, every required pack (of a gang
    or a group) inside one domain of its key."""
    nodes = {n.name: n for n in cluster.nodes}
    used = {}
    live = {}
    for (ns, name), node in cluster.bindings.items():
        pod = store.get("Pod", ns, name, readonly=True)
        if pod is None or pod.metadata.deletion_timestamp is not None or pod.status.node_name != node:
            continue  # an evicted pod's binding goes at the next round's gc
        live[(ns, name)] = node
        acc = used.setdefault(node, {})
        for r, v in pod.spec.total_requests().items():
            acc[r] = acc.get(r, 0.0) + v
    for node, acc in used.items():
        for r, v in acc.items():
            cap = nodes[node].capacity.get(r, 0.0)
            if v > cap + 1e-6 * max(1.0, cap):
                _fail(f"{tag}: node {node} over capacity on {r} ({v} > {cap})")
    for gang in store.scan("PodGang"):
        cond = next((c for c in gang.status.conditions if c.type == "Scheduled"), None)
        if cond is None or cond.status != "True":
            continue
        gang_nodes = []
        for group in gang.spec.pod_groups:
            placed = [live[(r.namespace, r.name)] for r in group.pod_references
                      if (r.namespace, r.name) in live]
            if len(placed) < group.min_replicas:
                _fail(f"{tag}: gang {gang.metadata.name} group {group.name} below its floor")
            tc = group.topology_constraint
            if tc is not None and tc.pack_constraint is not None and tc.pack_constraint.required:
                key = tc.pack_constraint.required
                if len({nodes[n].labels.get(key) for n in placed}) > 1:
                    _fail(f"{tag}: group {group.name} spans domains of {key}")
            gang_nodes += placed
        tc = gang.spec.topology_constraint
        if tc is not None and tc.pack_constraint is not None and tc.pack_constraint.required:
            key = tc.pack_constraint.required
            if len({nodes[n].labels.get(key) for n in gang_nodes}) > 1:
                _fail(f"{tag}: gang {gang.metadata.name} spans domains of {key}")


def _span_split(spans, outside_s: float = 0.0) -> dict:
    """A round's time by the tracer's spans: pending scan (with phase and
    health upkeep) + the round's encode, quota order, the round's solve,
    preemption/reclaim (trial solves included) and commit + status writes.
    Priority preemption opens no span of its own, as in the JAX package:
    its column is the residue of scheduler.schedule after the round's own
    child spans (scan, order, encode or delta encode, solve or partitioned
    solve, commit, status writes) and after ``outside_s``, time the caller
    measured outside them (the delta self-check): quota.reclaim, the
    preemption's trial encodes and solves (children of scheduler.schedule
    too) and the glue between the round's phases. A delta round's own solve
    takes its problem from the delta encode, so a scheduler.encode child
    there is a trial's, and so is every scheduler.solve after it."""
    roots = [sp for sp in spans if sp.name == "scheduler.schedule"]
    children = sorted((sp for sp in spans if sp.parent == "scheduler.schedule"),
                      key=lambda sp: sp.ts_us)
    first = {}
    for sp in children:
        first.setdefault(sp.name, sp)
    if "solve.delta_encode" in first:
        first.pop("scheduler.encode", None)
        solve = first.get("scheduler.solve")
        trial = next((sp for sp in children if sp.name == "scheduler.encode"), None)
        if solve is not None and trial is not None and trial.ts_us < solve.ts_us:
            del first["scheduler.solve"]  # a reuse tick: every solve is a trial's

    def own(name):
        return first[name].dur_us / 1e6 if name in first else 0.0

    own_s = sum(own(n) for n in (
        "scheduler.pending-scan", "scheduler.encode", "solve.delta_encode", "quota.order",
        "scheduler.solve", "solve.partition", "scheduler.commit", "scheduler.status-write"))
    solves = sum(1 for sp in children if sp.name == "scheduler.solve")
    return {
        "scan_encode_s": own("scheduler.pending-scan") + own("scheduler.encode"),
        "quota_order_s": own("quota.order"),
        "solve_s": own("scheduler.solve"),
        "preempt_reclaim_s": sum(sp.dur_us for sp in roots) / 1e6 - own_s - outside_s,
        "commit_status_s": own("scheduler.commit") + own("scheduler.status-write"),
        "trial_solves": solves - ("scheduler.solve" in first) + sum(
            1 for sp in spans if sp.name == "scheduler.solve" and sp.parent == "quota.reclaim"),
    }


class _RecordOrderPass:
    """Keeps the inputs of the quota manager's ordering passes."""

    def __enter__(self):
        from grove_tpu_torch.quota import manager

        self.manager, self.wrapped, self.calls = manager, manager.fair_order, []

        def record(deserved, usage, demand, counts, device=None):
            self.calls.append(tuple(np.array(a) for a in (deserved, usage, demand, counts)))
            return self.wrapped(deserved, usage, demand, counts, device=device)

        manager.fair_order = record
        return self

    def __exit__(self, *exc):
        self.manager.fair_order = self.wrapped


def phase_scheduler() -> dict:
    """The scheduler worlds (s), (q), (r) through the port's GangScheduler
    on the card, every round held against JAX_SCHEDULER_REFERENCE."""
    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.api.wire import decode_object
    from grove_tpu_torch.models.scenarios import EventCapture, round_summary, scheduler_world
    from grove_tpu_torch.observability.events import EVENTS
    from grove_tpu_torch.observability.metrics import METRICS
    from grove_tpu_torch.observability.tracing import TRACER
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda
    from grove_tpu_torch.runtime.clock import VirtualClock
    from grove_tpu_torch.runtime.store import Store
    from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
    from grove_tpu_torch.solver.scheduler import GangScheduler

    TRACER.enable()
    out = {"fill_launches": 0, "drf_shares_launches": 0, "drf_merge_launches": 0, "rounds": {},
           "q_order_inputs": None}
    for name, label in SCHED_WORLDS:
        world = scheduler_world(name, *SCHED_CUTS.get(name, (None, None)))
        store = Store(VirtualClock(0.0))
        cluster = SimCluster(store, make_nodes(*world["nodes"]))
        sched = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"],
                              device="cuda")
        EVENTS.reset()
        EVENTS.clock = store.clock
        for doc in world["queues"]:
            store.create(decode_object(doc), consume=True)
        for index, docs in enumerate(world["rounds"]):
            t0 = time.perf_counter()
            for doc in docs:
                store.create(decode_object(doc), consume=True)
            load_s = time.perf_counter() - t0
            TRACER.reset()
            METRICS.histograms.pop("gang_solve_seconds", None)
            with EventCapture(EVENTS) as cap, _RecordOrderPass() as orders:
                fill_batch.launches = 0
                share_table_cuda.launches = merge_cuda.launches = 0
                t0 = time.perf_counter()
                sched.schedule_pending()
                wall = time.perf_counter() - t0
                fills = fill_batch.launches
                shares, merges = share_table_cuda.launches, merge_cuda.launches
            tag = f"sched ({name}) round {index + 1}"
            got = round_summary(store, cluster, cap.events)
            want = dict(JAX_SCHEDULER_REFERENCE[name][index])
            if not np.isclose(got["score_sum"], want.pop("score_sum"), rtol=1e-6, atol=0):
                _fail(f"{tag}: score sum {got['score_sum']} != the JAX package's")
            for key, value in want.items():
                if got[key] != value:
                    _fail(f"{tag}: {key} {got[key]} != the JAX package's {value}")
            check_world_valid(tag, store, cluster)
            if got["events_by_reason"] and fills == 0:
                _fail(f"{tag}: the round did not launch the fill kernel")
            if world["queues"] and (shares == 0 or merges == 0):
                _fail(f"{tag}: the round did not launch both DRF kernels")
            if name == "q":
                out["q_order_inputs"] = orders.calls[0]
            split = _span_split(TRACER.spans())
            solves = METRICS.histograms.get("gang_solve_seconds", [])
            row = {"wall_s": wall, "load_s": load_s, **split,
                   "solve_seconds": solves[0] if solves else None,
                   "fill_launches": fills, "drf_shares_launches": shares,
                   "drf_merge_launches": merges,
                   **{k: got[k] for k in ("admitted", "bound", "evicted")}}
            out["rounds"][f"{name}{index + 1}"] = row
            out["fill_launches"] += fills
            out["drf_shares_launches"] += shares
            out["drf_merge_launches"] += merges
            print(f"[sched] ({name}) {label} round {index + 1}: wall {wall:.3f} s (world load"
                  f" {load_s:.3f} s before it); scan+encode {split['scan_encode_s']:.3f} s,"
                  f" quota order {split['quota_order_s']:.3f} s, solve {split['solve_s']:.3f} s,"
                  f" preempt/reclaim {split['preempt_reclaim_s']:.3f} s"
                  f" ({split['trial_solves']} trial solves), commit+status"
                  f" {split['commit_status_s']:.3f} s; solve_seconds"
                  f" {row['solve_seconds'] if row['solve_seconds'] is None else round(row['solve_seconds'], 4)};"
                  f" fill launches {fills}, DRF launches {shares} share table + {merges} merge; admitted {got['admitted']},"
                  f" bound {got['bound']}, evicted {got['evicted']}; equal to the JAX package's,"
                  f" valid", flush=True)
    TRACER.disable()
    return out


def random_queue_tree(rng, q_dim=8, g_dim=16, r_dim=4):
    """One random queue tree of tests/test_quota.py (its generator)."""
    n_q = int(rng.integers(1, q_dim + 1))
    n_r = int(rng.integers(1, r_dim + 1))
    deserved = np.zeros((q_dim, r_dim), np.float32)
    usage = np.zeros((q_dim, r_dim), np.float32)
    demand = np.zeros((q_dim, g_dim, r_dim), np.float32)
    counts = np.zeros((q_dim,), np.int32)
    for q in range(n_q):
        if rng.random() > 0.25:
            deserved[q, :n_r] = rng.integers(0, 5, n_r)
        if rng.random() > 0.3:
            usage[q, :n_r] = rng.integers(0, 9, n_r) * rng.choice([0.25, 0.5, 1.0, 2.0])
        counts[q] = rng.integers(0, g_dim + 1)
        demand[q, :, :n_r] = rng.integers(0, 4, (g_dim, n_r)) * rng.choice([0.5, 1.0])
    if n_q >= 2 and rng.random() > 0.5:
        src, dst = rng.choice(n_q, 2, replace=False)
        deserved[dst] = deserved[src]
        usage[dst] = usage[src]
    return deserved, usage, demand, counts


def wide_queue_tree(seed, q_dim, g_dim=6, r_dim=3):
    """A random tree of Q queues (the kernel's warp and block edges), with
    zero-deserved queues, share ties and drained queues."""
    rng = np.random.default_rng(seed)
    deserved = rng.integers(0, 5, (q_dim, r_dim)).astype(np.float32)
    deserved[rng.random(q_dim) < 0.2] = 0.0
    usage = (rng.integers(0, 9, (q_dim, r_dim)) * 0.5).astype(np.float32)
    usage[1::7] = usage[0]
    deserved[1::7] = deserved[0]
    demand = (rng.integers(0, 4, (q_dim, g_dim, r_dim)) * 0.5).astype(np.float32)
    counts = rng.integers(0, g_dim + 1, q_dim).astype(np.int32)
    return deserved, usage, demand, counts


def many_queue_tree(q_dim):
    """wide_queue_tree with more queues than the merge keeps taken counts
    for in shared memory (57,600): G=2, R=2."""
    return wide_queue_tree(q_dim, q_dim, g_dim=2, r_dim=2)


DRF_GLOBAL_COUNT_QUEUES = (57601, 65536)  # past shared memory; 65,536 = 32,769 Queue CRs padded


def past_g_tree(q_dim, g_dim=6):
    """wide_queue_tree with every fifth queue holding more pending gangs
    than G, up to 2G (the merge charges demand row G-1 past the table)."""
    deserved, usage, demand, counts = wide_queue_tree(q_dim + 1, q_dim, g_dim=g_dim)
    counts[::5] += g_dim
    return deserved, usage, demand, counts


def drf_edge_trees() -> dict:
    """Named edge inputs of the DRF order: name -> (deserved, usage, demand,
    counts, steps). Share ties; a -0.0 share at a higher index than a +0.0
    one (a key map that kept the sign would pick queue 1 first); NaN usage
    (NaN shares come first); usage*BIG overflowing to +inf, where the
    lowest queue wins though drained and is charged past its count; zero
    counts between active queues; every queue drained before the last
    step; counts above G (the merge charges demand row G-1 past the
    table); 40 resources (the share table folds them 32 at a time)."""
    f32 = np.float32
    rng = np.random.default_rng(11)
    mixed_d = rng.integers(0, 4, (5, 2)).astype(f32)
    mixed_u = (rng.integers(0, 5, (5, 2)) * 0.5).astype(f32)
    mixed_dem = (rng.integers(0, 3, (5, 4, 2)) * 0.5).astype(f32)
    return {
        "tie": (np.full((2, 1), 2.0, f32), np.zeros((2, 1), f32), np.ones((2, 4, 1), f32),
                np.array([4, 4], np.int32), 8),
        "signed_zero_tie": (np.ones((2, 1), f32), np.array([[0.0], [-0.0]], f32),
                            np.stack([np.zeros((3, 1), f32), np.full((3, 1), -0.0, f32)]),
                            np.array([3, 3], np.int32), 6),
        "nan_usage": (np.ones((3, 2), f32), np.array([[0, 1], [np.nan, 0], [0, 0]], f32),
                      np.ones((3, 2, 2), f32), np.array([2, 2, 2], np.int32), 6),
        "overflow_to_inf": (np.array([[0.0], [0.0], [1.0]], f32),
                            np.array([[0.0], [1e21], [1e30]], f32), np.ones((3, 2, 1), f32),
                            np.array([0, 2, 0], np.int32), 6),
        "zero_counts": (mixed_d, mixed_u, mixed_dem, np.array([0, 3, 0, 4, 0], np.int32), 20),
        "drained_before_t": (mixed_d, mixed_u, mixed_dem, np.array([1, 0, 2, 1, 0], np.int32),
                             20),
        "counts_above_g": (mixed_d, mixed_u, mixed_dem, np.array([6, 1, 9, 0, 5], np.int32),
                           21),
        "forty_resources": (*wide_queue_tree(40, 5, g_dim=6, r_dim=40), 30),
    }


def drf_bound(inputs, steps):
    """Least time of the ordering pass from the bytes it must move (the
    queue rows and counts read once, the demand rows the picks charge, the
    (queue, slot) rows written) over HBM bandwidth, and from its operations
    (per step a compare per queue and the picked row's charge and share)
    over the fp32 rate. Returns (ms, by)."""
    deserved, usage, demand, counts = inputs
    q_dim, r_dim = deserved.shape
    read = (2 * q_dim * r_dim + steps * r_dim + q_dim) * 4
    written = steps * 2 * 4
    t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    t_ops = steps * (q_dim + 4 * r_dim) / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def drf_phase_bounds(inputs, steps):
    """Least time of the share table and of the merge apart, each from the
    bytes it must move over HBM bandwidth and its operations over the fp32
    rate, counted for this run's data: the table entries the counts need
    (k < min(count, G)) and the queues with more pending gangs than G.
    Share table: the queue rows, counts and those demand rows read, the
    entries and tails written; an add, a divide and a max per entry and
    resource. Merge: counts and entries read, the (queue, slot) rows
    written, the tail, deserved and demand row G-1 of each queue past G
    read and the tail written; a compare per queue and step. Returns
    {"shares": (ms, by), "merge": (ms, by)}."""
    deserved, usage, demand, counts = inputs
    q_dim, g_dim, r_dim = demand.shape
    entries = int(np.clip(counts, 0, g_dim).sum())
    past = int((counts > g_dim).sum())

    def bound(nbytes, ops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    return {
        "shares": bound((2 * q_dim * r_dim + q_dim + entries * (r_dim + 1) + past * r_dim) * 4,
                        3 * entries * r_dim),
        "merge": bound((q_dim + entries + 2 * steps + 4 * past * r_dim) * 4, steps * q_dim),
    }


DRF_QUEUE_EDGES = (1, 32, 33, 64, 1024, 1025, 2048, 4096)  # warp, block and owner edges


def _host_ms(fn, reps=3):
    """Median host-clock time of fn in ms, the card synchronised around each
    call (for the plain versions, which read the card every step)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_drf(q_inputs) -> dict:
    """The DRF kernels against their plain twin, every scan step bit for
    bit, and each phase against its plain version at (q); then their times:
    the share table, the merge and the whole pass at (q)'s shape, and the
    merge per step at the other shapes it takes (the table not staged, one
    warp and more), each a median of CUDA event pairs."""
    from grove_tpu_torch.quota.ordering import (
        fair_order,
        fair_order_merge_ref,
        fair_order_ref,
        fair_order_scan,
        merge_cuda,
        merge_ref,
        order_keys,
        share_table_cuda,
        share_table_ref,
    )

    def upload(inputs):
        return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in inputs]

    def check(tag, inputs, steps):
        cuda = upload(inputs)
        got = fair_order_scan(*cuda, steps).cpu()
        want = fair_order_ref(*[t.cpu() for t in cuda], steps)
        if not torch.equal(got, want):
            _fail(f"DRF kernel != plain twin ({tag})")

    rng = np.random.default_rng(7)
    for trial in range(200):
        tree = random_queue_tree(rng)
        check(f"random tree {trial}", tree, tree[2].shape[0] * tree[2].shape[1])
    print("[drf] 200 random queue trees (tests/test_quota.py's generator, seed 7): every scan"
          " step equal bit for bit", flush=True)
    for q_dim in DRF_QUEUE_EDGES:
        tree = wide_queue_tree(q_dim, q_dim)
        check(f"Q={q_dim}", tree, q_dim * tree[2].shape[1])
    print(f"[drf] Q = {', '.join(map(str, DRF_QUEUE_EDGES))} (warp, block and owner edges):"
          " equal bit for bit", flush=True)
    edges = drf_edge_trees()
    for name, (*tree, steps) in edges.items():
        check(name, tree, steps)
    print(f"[drf] edge trees {', '.join(edges)}: equal bit for bit", flush=True)
    unstaged = wide_queue_tree(8, 8, g_dim=8192, r_dim=2)  # a 256 KB table
    check("Q=8 G=8192", unstaged, int(unstaged[3].sum()) + 4)
    for q_dim in (64, 1025):
        tree = past_g_tree(q_dim)
        check(f"Q={q_dim} past G", tree, int(tree[3].sum()) + 4)
    print("[drf] Q=8 G=8192 (table read from global memory), Q=64 and Q=1025 with counts"
          " above G (the tail charged above one warp): equal bit for bit", flush=True)
    # past 57,600 queues the merge keeps its taken counts in global memory;
    # the twin here is the plain two-phase version on the CPU (the step scan
    # over 65,536 queues costs tens of seconds)
    many = {}
    for q_dim in DRF_GLOBAL_COUNT_QUEUES:
        tree = many_queue_tree(q_dim)
        steps = int(tree[3].sum())
        cuda = upload(tree)
        got = fair_order_scan(*cuda, steps + 4).cpu()
        want = fair_order_merge_ref(*[torch.from_numpy(np.ascontiguousarray(a)) for a in tree],
                                    steps + 4)
        if not torch.equal(got, want):
            _fail(f"DRF kernel != plain two-phase version at Q={q_dim}")
        t_des, t_use, t_dem, t_counts = cuda
        t_table, t_tail = share_table_cuda(t_des, t_use, t_dem, t_counts)
        t_ms = _median_ms(lambda: merge_cuda(t_table, t_tail, t_des, t_dem, t_counts, steps),
                          reps=3, warmup=1)
        many[q_dim] = {"merge_ms": t_ms, "steps": steps, "us_per_step": t_ms * 1e3 / steps}
        print(f"[drf] Q={q_dim} G=2 R=2 (taken counts in global memory), {steps} steps: equal"
              f" bit for bit to the plain two-phase version; merge {t_ms:.3f} ms,"
              f" {t_ms * 1e3 / steps:.4f} us per step", flush=True)

    total = int(q_inputs[3].sum())
    check("(q)", q_inputs, total)
    got = fair_order(*q_inputs, device="cuda")
    if not np.array_equal(got, fair_order(*q_inputs, device="cpu")):
        _fail("fair_order on the card != on the CPU at (q)")
    cuda = upload(q_inputs)
    deserved, usage, demand, counts = cuda
    q_dim, g_dim, r_dim = q_inputs[2].shape
    # each phase against its plain version on the same inputs (the merge on
    # the plain table, whose keys are the kernel's)
    table, tail = share_table_cuda(*cuda)
    plain_table, plain_tail = share_table_ref(deserved, usage, demand)
    keys = table.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    plain_keys = order_keys(plain_table).cpu().numpy()
    for q, count in enumerate(q_inputs[3]):
        n = min(int(count), g_dim)
        if not np.array_equal(keys[q, :n], plain_keys[q, :n]):
            _fail(f"share table kernel != plain share table at (q), queue {q}")
    if not torch.equal(merge_cuda(table, tail, deserved, demand, counts, total),
                       merge_ref(plain_table, plain_tail, deserved, demand, counts, total)):
        _fail("merge kernel != plain merge at (q)")
    print("[drf] (q) share table == plain share table (every entry the counts need), merge =="
          " plain merge: bit for bit", flush=True)

    ms = _median_ms(lambda: fair_order_scan(*cuda, total), reps=20, warmup=2)
    shares_ms = _median_ms(lambda: share_table_cuda(*cuda), reps=20, warmup=2)
    # counts <= G at (q): the merge never charges the tail, so it can rerun
    merge_ms = _median_ms(lambda: merge_cuda(table, tail, deserved, demand, counts, total),
                          reps=20, warmup=2)
    # the same steps through the one-warp loop that checks for queues past
    # G: a ninth queue with more pending gangs than G and +inf usage (its
    # key +inf, its index the highest) wins no step before the eight drain
    extra = (np.ones((1, r_dim), np.float32), np.full((1, r_dim), np.inf, np.float32),
             np.zeros((1, g_dim, r_dim), np.float32), np.array([g_dim + 1], np.int32))
    p_des, p_use, p_dem, p_counts = upload(
        [np.concatenate([x, y]) for x, y in zip(q_inputs, extra)])
    p_table, p_tail = share_table_cuda(p_des, p_use, p_dem, p_counts)
    if not torch.equal(merge_cuda(p_table, p_tail, p_des, p_dem, p_counts, total),
                       merge_cuda(table, tail, deserved, demand, counts, total)):
        _fail("merge with a queue past G that wins no step != the merge at (q)")
    past_g_loop_ms = _median_ms(
        lambda: merge_cuda(p_table, p_tail, p_des, p_dem, p_counts, total), reps=20, warmup=2)
    plain_ms = _host_ms(lambda: fair_order_ref(*cuda, total))
    plain_shares_ms = _host_ms(lambda: share_table_ref(deserved, usage, demand))
    plain_merge_ms = _host_ms(
        lambda: merge_ref(plain_table, plain_tail, deserved, demand, counts, total))
    bound_ms, bound_by = drf_bound(q_inputs, total)
    bounds = drf_phase_bounds(q_inputs, total)
    print(f"[drf] (q) Q={q_dim} G={g_dim} R={r_dim}, {total} steps: whole pass {ms:.4f} ms ="
          f" share table {shares_ms:.4f} ms + merge {merge_ms:.4f} ms (medians of 20 calls"
          f" each, CUDA event pairs); plain on the card (host clock, median of 3): scan twin"
          f" {plain_ms:.1f} ms, share table {plain_shares_ms:.1f} ms, merge"
          f" {plain_merge_ms:.1f} ms", flush=True)
    print(f"[drf] (q) per dependent step: whole pass {ms * 1e3 / total:.4f} us, merge"
          f" {merge_ms * 1e3 / total:.4f} us; bound {bound_ms * 1e3:.4f} us for the pass"
          f" ({bound_by}), {bound_ms * 1e3 / total:.6f} us per step; share table bound"
          f" {bounds['shares'][0] * 1e3:.4f} us ({bounds['shares'][1]}), merge bound"
          f" {bounds['merge'][0] * 1e3:.4f} us ({bounds['merge'][1]})", flush=True)

    print(f"[drf] (q) merge through the one-warp loop that checks for queues past G (a"
          f" ninth queue past G that wins no step; the same {total} rows):"
          f" {past_g_loop_ms:.4f} ms, against {merge_ms:.4f} ms without the check", flush=True)

    # the merge per step where it takes its other paths (counts <= G: no tail)
    other = {"Q=8 G=8192 unstaged": unstaged}
    other.update({f"Q={n} G=6": wide_queue_tree(n, n) for n in (64, 1025, 4096)})
    per_step = {}
    for tag, tree in other.items():
        steps = int(tree[3].sum())
        t_des, t_use, t_dem, t_counts = upload(tree)
        t_table, t_tail = share_table_cuda(t_des, t_use, t_dem, t_counts)
        t_ms = _median_ms(lambda: merge_cuda(t_table, t_tail, t_des, t_dem, t_counts, steps),
                          reps=10, warmup=2)
        per_step[tag] = {"merge_ms": t_ms, "steps": steps, "us_per_step": t_ms * 1e3 / steps}
        print(f"[drf] merge at {tag}, {steps} steps: {t_ms:.4f} ms,"
              f" {t_ms * 1e3 / steps:.4f} us per step", flush=True)
    return {"ms": ms, "shares_ms": shares_ms, "merge_ms": merge_ms, "plain_ms": plain_ms,
            "plain_shares_ms": plain_shares_ms, "plain_merge_ms": plain_merge_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bounds": bounds, "steps": total,
            "merge_past_g_loop_ms": past_g_loop_ms, "merge_per_step": per_step,
            "merge_global_counts": many}


# The JAX package's delta rounds on the churn world of
# models/scenarios.scheduler_world("delta") (seed 0: (q)'s round, then 24
# churn ticks), from `JAX_PLATFORMS=cpu python scripts/scheduler_reference.py
# delta` (JAX 0.9.0 on the CPU; a JAX GangScheduler with enable_delta() and
# delta_selfcheck on every round): per round, round_summary as in
# JAX_SCHEDULER_REFERENCE, the delta counters, the crc32 of the free-capacity
# matrix (state_fingerprint()[2]) and the sha256 of the whole
# state_fingerprint().
JAX_DELTA_REFERENCE = [
    {"admitted": 10231, "bound": 34833, "score_sum": 10084.246239542961, "bindings": 34833,
     "bindings_sha256": "7ff9f94016b74cc5ea0e31eb3c29f4ea4fe0ae8f674ab4586e1f50bd4f7c744a",
     "evicted": 0, "evicted_sha256": _NONE,
     "admitted_per_queue": {"tenant-0": 1271, "tenant-1": 1280, "tenant-2": 1280, "tenant-3": 1280,
                            "tenant-4": 1280, "tenant-5": 1280, "tenant-6": 1280,
                            "tenant-7": 1280},
     "events_by_reason": {"GangAdmitted": 10231, "GangDeferred": 9, "PodBound": 34833},
     "counters": {"warm_start_hits": 0, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 10240, "last_reused": 0},
     "free_crc": 4170254377,
     "state_sha256": "6e2f2ee82a78f33369423fb86e8b1bc5aadbc227cf0530e4199985c99213a0e5"},
    {"admitted": 6, "bound": 47, "score_sum": 3.846746325492859, "bindings": 34880,
     "bindings_sha256": "cebb696007c67301b1c42dd66443189972f1a61a61b86a3bb314a7ed44df32a1",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 6},
     "events_by_reason": {"GangAdmitted": 6, "GangDeferred": 5, "PodBound": 47},
     "counters": {"warm_start_hits": 9, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 2, "last_reused": 9},
     "free_crc": 2853563664,
     "state_sha256": "4ca9fcd99409ebf3829b7d7b95b90276df86d6e87f46927a7a5ee3f109fec58f"},
    {"admitted": 4, "bound": 21, "score_sum": 2.885926067829132, "bindings": 34900,
     "bindings_sha256": "37fbfb16f5bfe96f5041383a85523a7d7811865a33ef0d3bf1484a7b3ae665cc",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 4},
     "events_by_reason": {"GangAdmitted": 4, "GangDeferred": 2, "PodBound": 21},
     "counters": {"warm_start_hits": 14, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 5},
     "free_crc": 4261502517,
     "state_sha256": "f3a45706f3cebadf921b7f9f8a4837baccda2156b07802cb680ba1924b5f3f45"},
    {"admitted": 2, "bound": 12, "score_sum": 1.7916667461395264, "bindings": 34912,
     "bindings_sha256": "01ad51b0c30b3a40f9c6b2bf99358126a4fec14cf729c8d05c9e8f16d3888e52",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 1, "tenant-1": 1},
     "events_by_reason": {"GangAdmitted": 2, "GangDeferred": 2, "PodBound": 12},
     "counters": {"warm_start_hits": 16, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 2, "last_reused": 2},
     "free_crc": 3698672750,
     "state_sha256": "8d9005283d8c08775b250d062109e3e855107f966a7cdd9a6681a41043c5ac96"},
    {"admitted": 2, "bound": 4, "score_sum": 2.0, "bindings": 34916,
     "bindings_sha256": "6d6f734446588fd3e66c8df26850b5a876cb3979dbbfa97bdcea944254c35192",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-2": 1, "tenant-3": 1},
     "events_by_reason": {"GangAdmitted": 2, "GangDeferred": 2, "PodBound": 4},
     "counters": {"warm_start_hits": 18, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 2, "last_reused": 2},
     "free_crc": 625421677,
     "state_sha256": "6d75ea68ebf5dfcc83f14a184e41952ccee1e91c4d19e06b8a571c859d1e99bd"},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34916,
     "bindings_sha256": "6d6f734446588fd3e66c8df26850b5a876cb3979dbbfa97bdcea944254c35192",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 20, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 2943177636,
     "state_sha256": "eceac7ecd3a912e5d13107dd233c2b1a1ac32045617118eaac31fe6e1d745b64"},
    {"admitted": 1, "bound": 4, "score_sum": 1.0, "bindings": 34920,
     "bindings_sha256": "16c9dab416c52572af7ccb6bd7484fb0a0660b24967ea982c5c43e4a012881cf",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-4": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 4},
     "counters": {"warm_start_hits": 22, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 2},
     "free_crc": 2943177636,
     "state_sha256": "a26a9c6a52c94cc11a396627cac45b0066f1e2f5532ca8c7bbe5d74503f327f5"},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34912,
     "bindings_sha256": "9462513fc7d335b94364b03debe2d38532d0c9fa1a407f976a7f844a7e09674e",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 24, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 2206875172,
     "state_sha256": "8ce276fe9bd35865dd150a719625e9c388581ca18e96fc8cecac2ab97120eb76"},
    {"admitted": 1, "bound": 3, "score_sum": 1.0, "bindings": 34915,
     "bindings_sha256": "b35562f58361a2d01d50fecc1b2cc5808a3cfcb04fda923fca91e8aafb1103d0",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-5": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 3},
     "counters": {"warm_start_hits": 26, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 2},
     "free_crc": 2206875172,
     "state_sha256": "422f2c31c28b182ab55ebccb56356419ac58ab6b137afd052fde81d7fcb00593"},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34911,
     "bindings_sha256": "e5abbbe71d6a627dbab8215a178533c803426118a687e6e55cd9b4dbed73453e",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 26, "solve_reuses": 0, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 2, "last_reused": 0},
     "free_crc": 1223848722,
     "state_sha256": "4b761a054b0628d872452a6637cafbe3e59ab486cea03fbdf25ca85d0f23d020"},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34911,
     "bindings_sha256": "e5abbbe71d6a627dbab8215a178533c803426118a687e6e55cd9b4dbed73453e",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 28, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 1223848722,
     "state_sha256": "4b761a054b0628d872452a6637cafbe3e59ab486cea03fbdf25ca85d0f23d020"},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34909,
     "bindings_sha256": "98360279b024e059939a400763dd77fdacba82357501ec3ead41ab416656ac32",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 30, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 163520973,
     "state_sha256": "50e6da15d16d8e199c77bdcbb855bb3e0dbbda293e05eae1aa7e1d2ff5bca965"},
    {"admitted": 1, "bound": 1, "score_sum": 1.0, "bindings": 34909,
     "bindings_sha256": "bff193bc45cc5f57d9a630a644deac88d8807dcd0985dce10784890933296dfa",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 1},
     "counters": {"warm_start_hits": 32, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 2},
     "free_crc": 1227874246,
     "state_sha256": "1ff4ba4bc9b3cd87362e588833c5bd880f6a91f8e6101b7f7442b4a43c7f109d"},
    {"admitted": 1, "bound": 2, "score_sum": 1.0, "bindings": 34911,
     "bindings_sha256": "a118da0a2b715b16c6689a6eed7e888173c385a025e61e4a43db1b71a9535986",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-6": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 2},
     "counters": {"warm_start_hits": 34, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 2},
     "free_crc": 3341797644,
     "state_sha256": "d1d9395506630404f67a8c8afa9fee126ea2b8f29ca50ed5e7a80dce5f00bfae"},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34911,
     "bindings_sha256": "a118da0a2b715b16c6689a6eed7e888173c385a025e61e4a43db1b71a9535986",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 36, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 3215944548,
     "state_sha256": "74111ee1f38c281d4f2e400155cfb003da725312c05b9d9c24c21b2780bcaaf5"},
    {"admitted": 1, "bound": 1, "score_sum": 0.6333333849906921, "bindings": 34911,
     "bindings_sha256": "a118da0a2b715b16c6689a6eed7e888173c385a025e61e4a43db1b71a9535986",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 1},
     "counters": {"warm_start_hits": 38, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 2},
     "free_crc": 649209802,
     "state_sha256": "9f73b02076962f5c1eacca09b3eba1e001d7fbc862e75e5d0fa62166c98ae375"},
    {"admitted": 2, "bound": 11, "score_sum": 1.7619048357009888, "bindings": 34922,
     "bindings_sha256": "4c948a8b5d0621a63f49c9ba2d1a6dcd5b545b6019e74f816249b948a005b0e9",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 1, "tenant-7": 1},
     "events_by_reason": {"GangAdmitted": 2, "GangDeferred": 2, "PodBound": 11},
     "counters": {"warm_start_hits": 40, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 2, "last_reused": 2},
     "free_crc": 3215944548,
     "state_sha256": "7ab3e709829319ca9e2962e2da9f50e9dc2ac1c81f302e18272915f0f0976e08"},
    {"admitted": 1, "bound": 4, "score_sum": 1.0, "bindings": 34926,
     "bindings_sha256": "ea318b8afed5265b7440317da70aa53ecfd8ce71715942f18523896eb903b378",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-1": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 4},
     "counters": {"warm_start_hits": 40, "solve_reuses": 1, "full_fallbacks": 2,
                  "drift_detected": 0, "last_reencoded": 3, "last_reused": 0},
     "free_crc": 1667032430,
     "state_sha256": "522e18afb8a0dce7706209d5379022accc84790c4a302428cb54747e3662f688"},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34926,
     "bindings_sha256": "ea318b8afed5265b7440317da70aa53ecfd8ce71715942f18523896eb903b378",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 42, "solve_reuses": 1, "full_fallbacks": 2,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 579851944,
     "state_sha256": "4d7c78492e6c3ef56b99518ebd3cd88c35597c52213a5e4b49c19c5871cc1450"},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34924,
     "bindings_sha256": "0d51644d098403557782b4e98a04042b6bc578a43d05b85d22cc1c47f705cc4b",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 44, "solve_reuses": 1, "full_fallbacks": 2,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 3924359870,
     "state_sha256": "c6168c66884ae23837c933ef09d8e1073a3e919ef8ef6b2a118f54e0c5497737"},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34924,
     "bindings_sha256": "0d51644d098403557782b4e98a04042b6bc578a43d05b85d22cc1c47f705cc4b",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 46, "solve_reuses": 2, "full_fallbacks": 2,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 3924359870,
     "state_sha256": "c6168c66884ae23837c933ef09d8e1073a3e919ef8ef6b2a118f54e0c5497737"},
    {"admitted": 1, "bound": 4, "score_sum": 1.0, "bindings": 34928,
     "bindings_sha256": "802f677d914cb479d30d3484670fccc8252012ff45b0dfc3754e8e5258a9f0c2",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-2": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 4},
     "counters": {"warm_start_hits": 48, "solve_reuses": 2, "full_fallbacks": 2,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 2},
     "free_crc": 3924359870,
     "state_sha256": "71c9818d75925973075519c9807f70d104ba0a467e9f8363126e0ad8d5f93ece"},
    {"admitted": 2, "bound": 7, "score_sum": 2.0, "bindings": 34935,
     "bindings_sha256": "a4a00aeb838794ca78312131b7c95383df51035969f1f4f74b57a223f10890bf",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-3": 1, "tenant-4": 1},
     "events_by_reason": {"GangAdmitted": 2, "GangDeferred": 2, "PodBound": 7},
     "counters": {"warm_start_hits": 50, "solve_reuses": 2, "full_fallbacks": 2,
                  "drift_detected": 0, "last_reencoded": 2, "last_reused": 2},
     "free_crc": 1819035171,
     "state_sha256": "fe74e24b75dfce4e73616ede33964eab2bf7edcb912671077118ab3da228fc6d"},
    {"admitted": 1, "bound": 1, "score_sum": 1.0, "bindings": 34935,
     "bindings_sha256": "c340bd965e640835bbd017354266c06c19c16ef546d84c381d04224fa86ab6ff",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 1},
     "counters": {"warm_start_hits": 52, "solve_reuses": 2, "full_fallbacks": 2,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 2},
     "free_crc": 2266553442,
     "state_sha256": "1aec5906cafe6d1e119cfc0cecc8771823207d6eca7ace702085e9ba501ff08a"},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34935,
     "bindings_sha256": "c340bd965e640835bbd017354266c06c19c16ef546d84c381d04224fa86ab6ff",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 54, "solve_reuses": 2, "full_fallbacks": 2,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 314465237,
     "state_sha256": "d0e4157055e581e5ebcc50d6679857b058eaa17f55e93de7f079edc96a20413d"},
]


def _percentile(samples, q):
    """Nearest-rank percentile, as sim/deltachurn.py reports it."""
    from grove_tpu_torch.sim.deltachurn import _percentile

    return _percentile(samples, q)


# [delta]'s churn ticks, cut from the world's 24 when [churn] came to run the
# delta round at full width (PERF.md section 4): tick 8 cordons a node and
# tick 16 uncordons it, so 17 is the fewest that still show a full fallback,
# a solve reuse and a flap back onto the retired encoding. The churn ticks
# are drawn one by one from a seeded stream, so the cut world's rounds are
# the first of the full world's and JAX_DELTA_REFERENCE (taken at 24) holds
# them.
DELTA_TICKS = 17


def phase_delta() -> dict:
    """The churn world through the port's GangScheduler with the delta
    state and its A/B self-check on every round, on the card; every round
    held against JAX_DELTA_REFERENCE and checked valid."""
    import hashlib

    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.api.wire import decode_object
    from grove_tpu_torch.models.scenarios import (
        EventCapture,
        apply_tick,
        delta_counters,
        round_summary,
        scheduler_world,
    )
    from grove_tpu_torch.observability.events import EVENTS
    from grove_tpu_torch.observability.tracing import TRACER
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda
    from grove_tpu_torch.runtime.clock import VirtualClock
    from grove_tpu_torch.runtime.store import Store
    from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
    from grove_tpu_torch.solver.scheduler import GangScheduler

    world = scheduler_world("delta", ticks=DELTA_TICKS)
    reference = JAX_DELTA_REFERENCE[: DELTA_TICKS + 1]
    if len(reference) != len(world["ticks"]) + 1:
        _fail("JAX_DELTA_REFERENCE does not hold one entry per round of the churn world")
    t0 = time.perf_counter()
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store, make_nodes(*world["nodes"]))
    sched = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"],
                          device="cuda")
    if not sched.enable_delta():
        _fail("delta: enable_delta() refused the port's store")
    sched.delta_selfcheck = True
    EVENTS.reset()
    EVENTS.clock = store.clock
    for doc in world["queues"] + world["rounds"][0]:
        store.create(decode_object(doc), consume=True)
    load_s = time.perf_counter() - t0
    TRACER.enable()
    out = {"fill_launches": 0, "drf_shares_launches": 0, "drf_merge_launches": 0,
           "load_s": load_s, "rounds": []}
    seen = {"reuse": 0, "fallback": 0, "flap_back_reused": 0}
    before_cordon = None
    for index, tick in enumerate([None] + world["ticks"]):
        ops = tick or []
        if any(op[0] == "cordon" and op[2] for op in ops):
            before_cordon = sched.delta._enc
        if tick:
            apply_tick(store, cluster, tick, decode_object)
        counts = delta_counters(sched.delta)
        TRACER.reset()
        sched.last_selfcheck_seconds = 0.0
        with EventCapture(EVENTS) as cap:
            fill_batch.launches = 0
            share_table_cuda.launches = merge_cuda.launches = 0
            t0 = time.perf_counter()
            sched.schedule_pending()
            wall = time.perf_counter() - t0
            fills = fill_batch.launches
            shares, merges = share_table_cuda.launches, merge_cuda.launches
        tag = f"delta round {index + 1}"
        got = round_summary(store, cluster, cap.events)
        fp = sched.delta.state_fingerprint()
        got.update(counters=delta_counters(sched.delta), free_crc=fp[2],
                   state_sha256=hashlib.sha256(repr(fp).encode()).hexdigest())
        want = dict(reference[index])
        if not np.isclose(got["score_sum"], want.pop("score_sum"), rtol=1e-6, atol=0):
            _fail(f"{tag}: score sum {got['score_sum']} != the JAX package's")
        for key, value in want.items():
            if got[key] != value:
                _fail(f"{tag}: {key} {got[key]} != the JAX package's {value}")
        check_world_valid(tag, store, cluster)
        now = got["counters"]
        reused = now["solve_reuses"] > counts["solve_reuses"]
        fallback = now["full_fallbacks"] > counts["full_fallbacks"]
        flap_back = (any(op[0] == "cordon" and not op[2] for op in ops)
                     and sched.delta._enc is before_cordon)
        seen["reuse"] += reused
        seen["fallback"] += fallback
        seen["flap_back_reused"] += flap_back
        spans = TRACER.spans()
        encode_s = sum(sp.dur_us for sp in spans if sp.name == "solve.delta_encode") / 1e6
        split = _span_split(spans, sched.last_selfcheck_seconds)
        row = {"wall_s": wall, "selfcheck_s": sched.last_selfcheck_seconds,
               "delta_encode_s": encode_s, **split, "fill_launches": fills,
               "drf_shares_launches": shares, "drf_merge_launches": merges,
               "solve_reused": reused, "full_fallback": fallback, "flap_back_reused": flap_back,
               "reencoded": now["last_reencoded"], "reused": now["last_reused"],
               **{k: got[k] for k in ("admitted", "bound", "evicted")}}
        out["rounds"].append(row)
        out["fill_launches"] += fills
        out["drf_shares_launches"] += shares
        out["drf_merge_launches"] += merges
        what = ", ".join(w for w, on in (("solve reused", reused), ("full fallback", fallback),
                                         ("flap back: retired encoding reused", flap_back)) if on)
        print(f"[delta] round {index + 1}{' (the (q) round)' if index == 0 else ''}: wall"
              f" {wall:.3f} s, self-check (this round's encode and solve from scratch)"
              f" {sched.last_selfcheck_seconds:.3f} s, solve.delta_encode {encode_s:.4f} s;"
              f" pending scan {split['scan_encode_s']:.3f} s, quota order"
              f" {split['quota_order_s']:.3f} s, solve {split['solve_s']:.3f} s,"
              f" preempt/reclaim {split['preempt_reclaim_s']:.3f} s ({split['trial_solves']}"
              f" trial solves), commit+status {split['commit_status_s']:.3f} s;"
              f" specs re-encoded {now['last_reencoded']}, reused {now['last_reused']};"
              f" fill launches {fills}, DRF launches {shares} share table + {merges} merge;"
              f" admitted {got['admitted']}, bound {got['bound']}, evicted {got['evicted']}"
              f"{'; ' + what if what else ''}; equal to the JAX package's, valid", flush=True)
    TRACER.disable()
    for key, label in (("reuse", "solve reuse"), ("fallback", "full fallback"),
                       ("flap_back_reused", "flap back that reused the retired encoding")):
        if not seen[key]:
            _fail(f"delta: no tick showed a {label}")
    for key in ("fill_launches", "drf_shares_launches", "drf_merge_launches"):
        if not out[key]:
            _fail(f"delta: the phase launched no {key[:-9]} kernel")
    ticks = out["rounds"][1:]
    # the tick wall with the self-check subtracted, as deltachurn.churn_loop
    # reports it; the self-check is the same tick's encode and solve from
    # scratch
    walls = [max(0.0, r["wall_s"] - r["selfcheck_s"]) for r in ticks]
    scratch = [r["selfcheck_s"] for r in ticks]
    out.update(ticks=len(ticks), tick_p50_s=_percentile(walls, 0.5),
               tick_p99_s=_percentile(walls, 0.99), tick_mean_s=statistics.mean(walls),
               selfcheck_p50_s=_percentile(scratch, 0.5),
               selfcheck_p99_s=_percentile(scratch, 0.99), seen=seen)
    print(f"[delta] {len(ticks)} churn ticks, wall less self-check: p50"
          f" {out['tick_p50_s']:.4f} s, p99 {out['tick_p99_s']:.4f} s, mean"
          f" {out['tick_mean_s']:.4f} s; the self-check's from-scratch encode + solve of the"
          f" same ticks: p50 {out['selfcheck_p50_s']:.4f} s, p99 {out['selfcheck_p99_s']:.4f} s;"
          f" solve reuses {seen['reuse']}, full fallbacks {seen['fallback']}, flap backs that"
          f" reused the retired encoding {seen['flap_back_reused']}; launches over the phase:"
          f" fill {out['fill_launches']}, DRF {out['drf_shares_launches']} share table +"
          f" {out['drf_merge_launches']} merge", flush=True)
    parts = ("scan_encode_s", "quota_order_s", "solve_s", "preempt_reclaim_s",
             "commit_status_s", "delta_encode_s")
    out["tick_median_split_s"] = {k: statistics.median(r[k] for r in ticks) for k in parts}
    print("[delta] churn ticks, median by span: " + ", ".join(
        f"{k[:-2]} {v:.4f} s" for k, v in out["tick_median_split_s"].items()), flush=True)
    return out


# JAX_FRONTIER_REFERENCE: (phi), the frontier's world
# (scheduler_world("frontier"): (q)'s round, then 16 churn ticks of seed 0),
# from `JAX_PLATFORMS=cpu python scripts/scheduler_reference.py frontier`
# (JAX 0.9.0 on the CPU; a JAX GangScheduler with enable_delta(),
# enable_frontier(), delta_selfcheck and frontier_selfcheck on every round):
# per round, what JAX_DELTA_REFERENCE holds and the deterministic fields of
# the frontier state's stats() (models/scenarios.frontier_counters).
JAX_FRONTIER_REFERENCE = [
    {"admitted": 10239, "bound": 34892, "score_sum": 10075.59018716216, "bindings": 34892,
     "bindings_sha256": "1b32956de0fe6eb889754516a4d931ed0f5b1f96488183c435f55aa4259af4e5",
     "evicted": 0, "evicted_sha256": _NONE,
     "admitted_per_queue": {"tenant-0": 1279, "tenant-1": 1280, "tenant-2": 1280, "tenant-3": 1280,
                            "tenant-4": 1280, "tenant-5": 1280, "tenant-6": 1280, "tenant-7": 1280},
     "events_by_reason": {"GangAdmitted": 10239, "GangDeferred": 1, "PodBound": 34892},
     "counters": {"warm_start_hits": 0, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 10240, "last_reused": 0},
     "free_crc": 4170254377,
     "state_sha256": "5857466a50e354eea7826846d427135e1a935af65fcef8ba76a9f7f1510ea1cf",
     "frontier": {"solves": 1, "degenerate_ticks": 0, "subproblems_total": 80,
                  "assigned_gangs_total": 10240, "residual_gangs_total": 2,
                  "batched_dispatches_total": 58, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 1, "bound": 8, "score_sum": 0.6166666746139526, "bindings": 34900,
     "bindings_sha256": "47637971338c2a8424b3145090f59641f24eaf4126d7860266a289ada9232c2f",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 8},
     "counters": {"warm_start_hits": 1, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 2, "last_reused": 1},
     "free_crc": 531161091,
     "state_sha256": "5550e7597977a5d01081764b0f0e88f93a29448aec63af21a9a2a06fc05107e5",
     "frontier": {"solves": 2, "degenerate_ticks": 0, "subproblems_total": 83,
                  "assigned_gangs_total": 10243, "residual_gangs_total": 5,
                  "batched_dispatches_total": 60, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 1, "bound": 1, "score_sum": 0.833333432674408, "bindings": 34900,
     "bindings_sha256": "47637971338c2a8424b3145090f59641f24eaf4126d7860266a289ada9232c2f",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 1},
     "counters": {"warm_start_hits": 3, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 2},
     "free_crc": 3244670425,
     "state_sha256": "9fdce3f7c7b14a5b246a0961abc336ce181a8f0c98a24ded25a5052fce66c4e9",
     "frontier": {"solves": 3, "degenerate_ticks": 0, "subproblems_total": 86,
                  "assigned_gangs_total": 10246, "residual_gangs_total": 7,
                  "batched_dispatches_total": 62, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 2, "bound": 12, "score_sum": 1.3666667342185974, "bindings": 34912,
     "bindings_sha256": "d184eacd1959de30888f18825d9cb0726ab2a1da80660932314da0ddb990c14e",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 1, "tenant-1": 1},
     "events_by_reason": {"GangAdmitted": 2, "GangDeferred": 2, "PodBound": 12},
     "counters": {"warm_start_hits": 5, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 2, "last_reused": 2},
     "free_crc": 3376158537,
     "state_sha256": "d989144f3e7ee7cdeb2f7ef240ee8f96360bb21cd079ad2950fa42080db2bea2",
     "frontier": {"solves": 4, "degenerate_ticks": 0, "subproblems_total": 90,
                  "assigned_gangs_total": 10250, "residual_gangs_total": 9,
                  "batched_dispatches_total": 64, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 2, "bound": 4, "score_sum": 2.0, "bindings": 34916,
     "bindings_sha256": "62b5cd0765345800059f75175f533dbc8625f60964229d4e12c47547cee396cc",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-2": 1, "tenant-3": 1},
     "events_by_reason": {"GangAdmitted": 2, "GangDeferred": 2, "PodBound": 4},
     "counters": {"warm_start_hits": 7, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 2, "last_reused": 2},
     "free_crc": 33499926,
     "state_sha256": "1ceb15baee66e4b72f233cb3164a14d14981c0624ce26750dfba84f4a20dca4e",
     "frontier": {"solves": 5, "degenerate_ticks": 0, "subproblems_total": 94,
                  "assigned_gangs_total": 10254, "residual_gangs_total": 11,
                  "batched_dispatches_total": 66, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34916,
     "bindings_sha256": "62b5cd0765345800059f75175f533dbc8625f60964229d4e12c47547cee396cc",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 9, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 1807678792,
     "state_sha256": "ca50bfc8f7522352adf8bd65aa16b145aac8c2d0e770b3b52116187f10393bd3",
     "frontier": {"solves": 6, "degenerate_ticks": 0, "subproblems_total": 96,
                  "assigned_gangs_total": 10256, "residual_gangs_total": 13,
                  "batched_dispatches_total": 68, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 1, "bound": 4, "score_sum": 1.0, "bindings": 34920,
     "bindings_sha256": "a40b956f2fff8c649bc8979def7f099b7a9180bd57919e691cc1256ac80c4773",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-4": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 4},
     "counters": {"warm_start_hits": 11, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 2},
     "free_crc": 1807678792,
     "state_sha256": "47b9174ee4c5cd93dc42d849de04755e454776d6ccc6c5e01c66dad920447c67",
     "frontier": {"solves": 7, "degenerate_ticks": 0, "subproblems_total": 98,
                  "assigned_gangs_total": 10259, "residual_gangs_total": 15,
                  "batched_dispatches_total": 70, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34912,
     "bindings_sha256": "393aaa3d7b0a078c00dbf1e1aa161678477d06cc6ec0758118fe9faf620b1b3a",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 13, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 415572874,
     "state_sha256": "7f8657d15bff41313ba2a156303dbb5e7fc342e97a5b3a09776ceba2dc873ade",
     "frontier": {"solves": 8, "degenerate_ticks": 0, "subproblems_total": 100,
                  "assigned_gangs_total": 10261, "residual_gangs_total": 17,
                  "batched_dispatches_total": 72, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 1, "bound": 3, "score_sum": 1.0, "bindings": 34915,
     "bindings_sha256": "a10cb4c4edc66d4f7e0e5cbbde5d3c55862138645238fcb5f957c7b8bcd00093",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-5": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 3},
     "counters": {"warm_start_hits": 15, "solve_reuses": 0, "full_fallbacks": 0,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 2},
     "free_crc": 415572874,
     "state_sha256": "cc3462fa5cf91f296cc7ce41c645955ddc5c9dd7b9b5bd7791d72bf1bef74320",
     "frontier": {"solves": 9, "degenerate_ticks": 0, "subproblems_total": 103,
                  "assigned_gangs_total": 10264, "residual_gangs_total": 19,
                  "batched_dispatches_total": 74, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34911,
     "bindings_sha256": "05d6116159b06f5278e446587f261f5df65f86eace232ad6e674f59265174fd7",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 15, "solve_reuses": 0, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 2, "last_reused": 0},
     "free_crc": 2387562348,
     "state_sha256": "4f07db561f6068ae4c36ac03c0a1d1daff98372b1c0e7fcca084adfeadc41abc",
     "frontier": {"solves": 10, "degenerate_ticks": 0, "subproblems_total": 105,
                  "assigned_gangs_total": 10266, "residual_gangs_total": 21,
                  "batched_dispatches_total": 76, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34911,
     "bindings_sha256": "05d6116159b06f5278e446587f261f5df65f86eace232ad6e674f59265174fd7",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 17, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 2387562348,
     "state_sha256": "4f07db561f6068ae4c36ac03c0a1d1daff98372b1c0e7fcca084adfeadc41abc",
     "frontier": {"solves": 10, "degenerate_ticks": 0, "subproblems_total": 105,
                  "assigned_gangs_total": 10266, "residual_gangs_total": 21,
                  "batched_dispatches_total": 76, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34909,
     "bindings_sha256": "231c586e7949e4504eeff63a0bed065f35ee89a7425878d06ab69d4c4b77a26a",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 19, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 2094630420,
     "state_sha256": "97b1233260c6a6ff589ccda8da69eafab4cb28df0934c9504fc5c4d169aec17b",
     "frontier": {"solves": 11, "degenerate_ticks": 0, "subproblems_total": 107,
                  "assigned_gangs_total": 10268, "residual_gangs_total": 23,
                  "batched_dispatches_total": 78, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 1, "bound": 1, "score_sum": 1.0, "bindings": 34909,
     "bindings_sha256": "0475924000ce00eb49c0cbfc4e7c74c533a0837b2dcbb2438809e3392dd0aeeb",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 1},
     "counters": {"warm_start_hits": 21, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 2},
     "free_crc": 216308278,
     "state_sha256": "fc3c601e7ff8bb827b4d9a2dd21f6a1011104a4f2713daeb7fb0b3286ca83bd6",
     "frontier": {"solves": 12, "degenerate_ticks": 0, "subproblems_total": 110,
                  "assigned_gangs_total": 10271, "residual_gangs_total": 25,
                  "batched_dispatches_total": 80, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 1, "bound": 2, "score_sum": 1.0, "bindings": 34911,
     "bindings_sha256": "0979dad7b9c4daaea05654889970f3398a62b589dd42e92e01c23a745f1e191a",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-6": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 2},
     "counters": {"warm_start_hits": 23, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 2},
     "free_crc": 2100331684,
     "state_sha256": "c0f0975aa1e9524fb248f446d256f3e8344080b393d3f75faf7e795737d4e229",
     "frontier": {"solves": 13, "degenerate_ticks": 0, "subproblems_total": 112,
                  "assigned_gangs_total": 10274, "residual_gangs_total": 27,
                  "batched_dispatches_total": 82, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 0, "bound": 0, "score_sum": 0.0, "bindings": 34911,
     "bindings_sha256": "0979dad7b9c4daaea05654889970f3398a62b589dd42e92e01c23a745f1e191a",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {},
     "events_by_reason": {"GangDeferred": 2},
     "counters": {"warm_start_hits": 25, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 0, "last_reused": 2},
     "free_crc": 4049128258,
     "state_sha256": "f860c0bc4728c8f8386c7160b4128a60ec5f6fd9d5b3f6d2e53faf31623ab9a7",
     "frontier": {"solves": 14, "degenerate_ticks": 0, "subproblems_total": 114,
                  "assigned_gangs_total": 10276, "residual_gangs_total": 29,
                  "batched_dispatches_total": 84, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 1, "bound": 1, "score_sum": 0.6000000238418579, "bindings": 34911,
     "bindings_sha256": "f37b235c5bf5e639026d12a1b8f41d6cfbfaccf0aa23260465476dcb28c5a3fc",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 1},
     "events_by_reason": {"GangAdmitted": 1, "GangDeferred": 2, "PodBound": 1},
     "counters": {"warm_start_hits": 27, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 1, "last_reused": 2},
     "free_crc": 3616014856,
     "state_sha256": "381a62d5eacb3f4e11dceb6597cbc31d134d628de7bf99a9d628cffaf2e198bb",
     "frontier": {"solves": 15, "degenerate_ticks": 0, "subproblems_total": 116,
                  "assigned_gangs_total": 10279, "residual_gangs_total": 31,
                  "batched_dispatches_total": 86, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
    {"admitted": 2, "bound": 11, "score_sum": 1.607142984867096, "bindings": 34922,
     "bindings_sha256": "7d79a80fe4c9777700d696983e3fa763bc2bb63a61da55c5ffe25553041b4c5d",
     "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 1, "tenant-7": 1},
     "events_by_reason": {"GangAdmitted": 2, "GangDeferred": 2, "PodBound": 11},
     "counters": {"warm_start_hits": 29, "solve_reuses": 1, "full_fallbacks": 1,
                  "drift_detected": 0, "last_reencoded": 2, "last_reused": 2},
     "free_crc": 1596714649,
     "state_sha256": "d064a23a6da2f05ce4763cd5ffb5af6243533915b804a571a2d767b0dc63fda7",
     "frontier": {"solves": 16, "degenerate_ticks": 0, "subproblems_total": 120,
                  "assigned_gangs_total": 10283, "residual_gangs_total": 33,
                  "batched_dispatches_total": 88, "residual_overlap_hits": 0,
                  "residual_overlap_misses": 0}},
]


class _RecordStacks:
    """Keeps the stacks the frontier hands to solve_waves_stacked (the
    arrays, not copies: the frontier does not write them after)."""

    def __enter__(self):
        from grove_tpu_torch.solver import frontier

        self.module, self.wrapped, self.stacks = frontier, frontier.solve_waves_stacked, []

        def record(stack, **kw):
            self.stacks.append(stack)
            return self.wrapped(stack, **kw)

        frontier.solve_waves_stacked = record
        return self

    def __exit__(self, *exc):
        self.module.solve_waves_stacked = self.wrapped


def frontier_stacks(nodes, specs, topology):
    """The stacks the partitioned frontier builds for `specs` on `nodes`
    with all their capacity free (a first round's): [(lane problems,
    stack)] per bucket, each lane built and each bucket stacked by the
    port's FrontierState, as its solve does."""
    from grove_tpu_torch.solver import frontier
    from grove_tpu_torch.solver.encode import NodeEncoding, _next_pow2, build_problem

    problem = build_problem(nodes, specs, topology)
    enc = NodeEncoding(nodes, topology, problem.resource_names)
    state = frontier.FrontierState(topology)
    plan = state.plan_for(enc)
    free = enc.base_capacity.copy()
    part_of = state.assign(plan, enc, free, specs)
    buckets = {}
    for k in sorted({int(k) for k in part_of if k >= 0}):
        idxs = [i for i in range(len(specs)) if part_of[i] == k]
        n_real = int(plan.ends[k] - plan.starts[k])
        key = (_next_pow2(max(len(idxs), frontier.MIN_SUB_GANG_BUCKET)),
               _next_pow2(max(n_real, 8)))
        buckets.setdefault(key, []).append(state._build_lane(
            enc, free, plan, k, idxs, specs, key[0], problem.max_groups, key[1],
            list(problem.resource_names)))
    return [(lanes, state._stack_bucket(lanes)) for _key, lanes in sorted(buckets.items())]


def stacked_fill_call(stack, chunk_size):
    """The arguments of the first fill kernel launch of one stacked dispatch
    of `stack` (the lanes folded into the gang axis by the fill's vmap
    rule), cloned, and the dispatch's lane count."""
    from grove_tpu_torch.ops import fill as fill_mod
    from grove_tpu_torch.solver.kernel import solve_waves_stacked

    calls = []
    wrapped = fill_mod._fill_batch_cuda

    def record(free, mask, demand, count, with_free_after):
        calls.append((tuple(t.clone() for t in (free, mask, demand, count)),
                      {"with_free_after": with_free_after}))
        raise _Captured

    fill_mod._fill_batch_cuda = record
    try:
        solve_waves_stacked(stack, chunk_size=chunk_size, max_waves=1, device="cuda")
    except _Captured:
        return calls[0], stack["demand"].shape[0]
    finally:
        fill_mod._fill_batch_cuda = wrapped
    _fail("frontier: the stacked dispatch made no fill call")


# [frontier]'s churn ticks, cut from (phi)'s 16 (PERF.md section 4): a
# residual gang, a multi-lane stacked dispatch and the stacked fill all show
# in round 1; the first rounds of (phi) are JAX_FRONTIER_REFERENCE's first
# entries, as for [delta]
FRONTIER_TICKS = 6


def phase_frontier(delta_round1) -> dict:
    """(phi) through the port's GangScheduler with the delta state, the
    partitioned frontier and both self-checks on every round, on the card;
    every round held against JAX_FRONTIER_REFERENCE and checked valid; then
    the fill at the stacked dispatch's shape against its plain version and
    timed beside its bound."""
    import hashlib

    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.api.wire import decode_object
    from grove_tpu_torch.models.scenarios import (
        EventCapture,
        apply_tick,
        delta_counters,
        frontier_counters,
        round_summary,
        scheduler_world,
    )
    from grove_tpu_torch.observability.events import EVENTS
    from grove_tpu_torch.observability.tracing import TRACER
    from grove_tpu_torch.ops.fill import fill_batch, fill_batch_ref
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda
    from grove_tpu_torch.runtime.clock import VirtualClock
    from grove_tpu_torch.runtime.store import Store
    from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
    from grove_tpu_torch.solver.scheduler import GangScheduler

    world = scheduler_world("frontier", ticks=FRONTIER_TICKS)
    reference = JAX_FRONTIER_REFERENCE[: FRONTIER_TICKS + 1]
    if len(reference) != len(world["ticks"]) + 1:
        _fail("JAX_FRONTIER_REFERENCE does not hold one entry per round of (phi)")
    t0 = time.perf_counter()
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store, make_nodes(*world["nodes"]))
    sched = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"],
                          device="cuda")
    if not sched.enable_frontier():
        _fail("frontier: enable_frontier() refused the port's store")
    sched.delta_selfcheck = sched.frontier_selfcheck = True
    front = sched.frontier
    EVENTS.reset()
    EVENTS.clock = store.clock
    for doc in world["queues"] + world["rounds"][0]:
        store.create(decode_object(doc), consume=True)
    load_s = time.perf_counter() - t0
    TRACER.enable()
    out = {"fill_launches": 0, "drf_shares_launches": 0, "drf_merge_launches": 0,
           "stacked_fill_launches": 0, "stacked_fill_rows_ok": True, "load_s": load_s,
           "rounds": []}
    widest = 0  # most real lanes in one stacked dispatch
    with _RecordStacks() as recorded:
        for index, tick in enumerate([None] + world["ticks"]):
            if tick:
                apply_tick(store, cluster, tick, decode_object)
            TRACER.reset()
            sched.last_selfcheck_seconds = 0.0
            front_check0 = front.selfcheck_seconds
            stacked0, rows0 = front.stacked_fill_launches, front.stacked_fill_rows
            solves0 = front.solves
            with EventCapture(EVENTS) as cap:
                fill_batch.launches = 0
                share_table_cuda.launches = merge_cuda.launches = 0
                t0 = time.perf_counter()
                sched.schedule_pending()
                wall = time.perf_counter() - t0
                fills = fill_batch.launches
                shares, merges = share_table_cuda.launches, merge_cuda.launches
            tag = f"frontier round {index + 1}"
            got = round_summary(store, cluster, cap.events)
            fp = sched.delta.state_fingerprint()
            got.update(counters=delta_counters(sched.delta), free_crc=fp[2],
                       state_sha256=hashlib.sha256(repr(fp).encode()).hexdigest(),
                       frontier=frontier_counters(front))
            want = dict(reference[index])
            if not np.isclose(got["score_sum"], want.pop("score_sum"), rtol=1e-6, atol=0):
                _fail(f"{tag}: score sum {got['score_sum']} != the JAX package's")
            for key, value in want.items():
                if got[key] != value:
                    _fail(f"{tag}: {key} {got[key]} != the JAX package's {value}")
            check_world_valid(tag, store, cluster)
            partitioned = front.solves > solves0
            stacked = front.stacked_fill_launches - stacked0
            stacked_rows = front.stacked_fill_rows - rows0
            buckets = front.last_buckets if partitioned else []
            if partitioned:
                widest = max([widest] + [b[2] for b in buckets])
                # every stacked launch took all stacked lanes' chunk rows
                if stacked_rows != sum(b[3] * min(sched.chunk_size, b[0]) * b[5]
                                       for b in buckets):
                    out["stacked_fill_rows_ok"] = False
            spans = TRACER.spans()
            front_check = front.selfcheck_seconds - front_check0
            partition_s = sum(sp.dur_us for sp in spans if sp.name == "solve.partition") / 1e6
            execute = [sp.dur_us / 1e6 for sp in spans if sp.name == "solver.execute"
                       and sp.attrs.get("kernel") == "solve_wave_chunk_stack"]
            # the frontier's self-check runs inside solve.partition; the
            # delta one outside the round's spans
            split = _span_split(spans, sched.last_selfcheck_seconds - front_check)
            row = {"wall_s": wall, "selfcheck_s": sched.last_selfcheck_seconds,
                   "frontier_selfcheck_s": front_check,
                   "partition_s": partition_s - front_check, **split,
                   "stacked_dispatches": len(execute), "execute_host_s": sum(execute),
                   "buckets": [list(b) for b in buckets], "fill_launches": fills,
                   "stacked_fill_launches": stacked, "drf_shares_launches": shares,
                   "drf_merge_launches": merges, "partitioned": partitioned,
                   **{k: got[k] for k in ("admitted", "bound", "evicted")}}
            out["rounds"].append(row)
            out["fill_launches"] += fills
            out["stacked_fill_launches"] += stacked
            out["drf_shares_launches"] += shares
            out["drf_merge_launches"] += merges
            per_dispatch = (sum(execute) / len(execute)) if execute else 0.0
            print(f"[frontier] round {index + 1}{' (the (q) round)' if index == 0 else ''}:"
                  f" wall {wall:.3f} s, self-checks {sched.last_selfcheck_seconds:.3f} s (frontier"
                  f" {front_check:.3f} s); solve.partition less its self-check"
                  f" {row['partition_s']:.3f} s over {len(buckets)} bucket(s)"
                  f" {[tuple(b[:4]) for b in buckets]} (g_pad, n_pad, lanes, stacked lanes),"
                  f" {len(execute)} stacked dispatches, host time per dispatch"
                  f" {per_dispatch * 1e3:.2f} ms; pending scan {split['scan_encode_s']:.3f} s,"
                  f" quota order {split['quota_order_s']:.3f} s, global solve"
                  f" {split['solve_s']:.3f} s, commit+status {split['commit_status_s']:.3f} s;"
                  f" fill launches {fills} ({stacked} stacked), DRF launches {shares} share"
                  f" table + {merges} merge; admitted {got['admitted']}, bound {got['bound']};"
                  f" frontier {got['frontier']}; equal to the JAX package's, valid", flush=True)
    TRACER.disable()
    last = frontier_counters(front)
    if widest < 2:
        _fail("frontier: no stacked dispatch held two or more real lanes")
    if not last["residual_gangs_total"]:
        _fail("frontier: no gang went through the residual pass")
    if not out["stacked_fill_launches"]:
        _fail("frontier: solve_waves_stacked launched no fill kernel")
    if not out["stacked_fill_rows_ok"]:
        _fail("frontier: a stacked fill launch did not take every lane's chunk rows")
    for key in ("drf_shares_launches", "drf_merge_launches"):
        if not out[key]:
            _fail(f"frontier: the phase launched no {key[:-9]} kernel")
    first = out["rounds"][0]
    print(f"[frontier] round 1 beside [delta]'s round 1 (the same world and round through the"
          f" global solve): wall {first['wall_s']:.3f} s vs {delta_round1['wall_s']:.3f} s,"
          f" self-checks {first['selfcheck_s']:.3f} s vs {delta_round1['selfcheck_s']:.3f} s;"
          f" solve {first['partition_s']:.3f} s (solve.partition less its self-check) vs"
          f" {delta_round1['solve_s']:.3f} s (scheduler.solve); pending scan"
          f" {first['scan_encode_s']:.3f} s vs {delta_round1['scan_encode_s']:.3f} s, commit+status"
          f" {first['commit_status_s']:.3f} s vs {delta_round1['commit_status_s']:.3f} s", flush=True)
    ticks = out["rounds"][1:]
    walls = [max(0.0, r["wall_s"] - r["selfcheck_s"]) for r in ticks]
    dispatches = [r["stacked_dispatches"] for r in out["rounds"]]
    host = sum(r["execute_host_s"] for r in out["rounds"]) / max(sum(dispatches), 1)
    out.update(ticks=len(ticks), tick_p50_s=_percentile(walls, 0.5),
               tick_p99_s=_percentile(walls, 0.99), tick_mean_s=statistics.mean(walls),
               stacked_dispatches_per_round=dispatches, host_s_per_stacked_dispatch=host,
               widest_stack_lanes=widest, stats=front.stats())
    print(f"[frontier] {len(ticks)} churn ticks, wall less self-checks: p50"
          f" {out['tick_p50_s']:.4f} s, p99 {out['tick_p99_s']:.4f} s, mean"
          f" {out['tick_mean_s']:.4f} s; stacked dispatches per round {dispatches}, host time"
          f" per stacked dispatch {host * 1e3:.3f} ms (solver.execute spans); widest stack"
          f" {widest} real lanes; launches over the phase: fill {out['fill_launches']}"
          f" ({out['stacked_fill_launches']} from solve_waves_stacked), DRF"
          f" {out['drf_shares_launches']} share table + {out['drf_merge_launches']} merge;"
          f" stats {front.stats()}", flush=True)
    # the fill at the stacked dispatch's shape: round 1's first bucket (the
    # launches here are outside the counted run)
    (args, kw), lanes = stacked_fill_call(recorded.stacks[0], sched.chunk_size)
    fill_out = fill_batch(*args, **kw)
    torch.cuda.synchronize()
    err = _check_equal("frontier stacked", fill_out, fill_batch_ref(*args, **kw))
    ms = _median_ms(lambda: fill_batch(*args, **kw))
    plain_ms = _median_ms(lambda: fill_batch_ref(*args, **kw))
    bound_ms, bound_by = _fill_bound(args, **kw)
    free, mask, demand, count = args
    c, p, r = demand.shape
    print(f"[frontier] stacked fill: {lanes} lanes x {c // lanes} gangs = C={c} rows, P={p}"
          f" N={mask.shape[-1]} R={r}, free {'shared' if free.dim() == 2 else 'per-gang'},"
          f" free_after {'yes' if kw['with_free_after'] else 'no'}: equal bit for bit; kernel"
          f" {ms * 1e3:.2f} us per launch, plain {plain_ms * 1e3:.2f} us, bound"
          f" {bound_ms * 1e3:.3f} us ({bound_by}), {100 * bound_ms / ms:.1f} % of bound",
          flush=True)
    out["stacked_fill"] = {"case": "frontier_stacked", "rows": c, "lanes": lanes, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                           "share_of_bound": bound_ms / ms, "max_abs_err": err}
    return out


# The JAX package's numbers for [sharded]: `solve_waves_device` of (a) on
# one device at solve_stress_sharded's budget (chunk 128, 32 waves), from
# `JAX_PLATFORMS=cpu python scripts/stats_reference.py sharded` (JAX 0.9.0,
# CPU): counts, the score sum and the crc32 of the arrays' bytes. The score
# is held at rtol 1e-6 (XLA's CPU backend fuses its multiply-add), the rest
# exactly.
JAX_SHARDED_REFERENCE = {
    "nodes": 5120,
    "gangs": 10240,
    "chunk_size": 128,
    "max_waves": 32,
    "admitted": 10230,
    "pending": 10,
    "waves": 15,
    "pods_placed": 34813,
    "score_sum": 10115.289792835712,
    "admitted_crc32": 3046904420,
    "placed_crc32": 3412897608,
    "score_crc32": 1986570905,
    "chosen_level_crc32": 1917465202,
    "free_after_crc32": 1908075594,
}
SHARDED_WORLDS = (1, 2, 4)  # ranks on cuda:0: NCCL at 1, gloo above (they share the card)
SHARDED_TIMEOUT_S = 300  # per spawn; each collective raises after 120 s


def _crc(a) -> int:
    import zlib

    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def _check_sharded_vs_jax(tag, res, ref):
    """A stress solve's result against JAX_SHARDED_REFERENCE."""
    got = {"admitted": int(res["admitted"].sum()), "pending": int(res["pending"].sum()),
           "waves": int(res["waves"]), "pods_placed": int(res["placed"].sum()),
           **{f"{k}_crc32": _crc(res[k]) for k in ("admitted", "placed", "chosen_level",
                                                     "free_after")}}
    for key, value in got.items():
        if value != ref[key]:
            _fail(f"{tag}: {key} {value} != the JAX package's {ref[key]}")
    score_sum = float(res["score"].astype(np.float64).sum())
    if not np.isclose(score_sum, ref["score_sum"], rtol=1e-6, atol=0):
        _fail(f"{tag}: score sum {score_sum} != the JAX package's {ref['score_sum']}")


def _spawn_sharded_worlds(cfg, ref) -> list:
    """[sharded]'s rank worlds, one after another: (world size, the ranks'
    results, seconds from spawn to results)."""
    from grove_tpu_torch.parallel.multihost import run_ranks

    worlds = []
    for world in SHARDED_WORLDS:
        jobs = [("stress", dict(cfg, warmup=True)), ("cluster", {})]
        if world > 1:
            jobs.append(("ring", {"n_nodes": ref["nodes"], "n_gangs": ref["gangs"], "gang": 0}))
        if world == 2:
            jobs.append(("fill", {}))
        t0 = time.perf_counter()
        ranks = run_ranks(jobs, world, device="cuda:0", timeout=SHARDED_TIMEOUT_S,
                          pg_timeout=120)
        worlds.append((world, ranks, time.perf_counter() - t0))
    return worlds


def phase_sharded(alongside=None, after_ranks=None) -> dict:
    """(a) with its node axis sharded over local ranks on the one card
    (solve_stress_sharded through parallel.multihost.run_ranks): NCCL at
    world size 1, gloo ranks sharing cuda:0 at 2 and 4. Every rank's result
    must equal the single-device solve on the card bit for bit and
    JAX_SHARDED_REFERENCE; at 2 and 4 ranks domain_aggregates_ring of (a)'s
    gang 0 must equal the single-device aggregates, and at 2 ranks the
    sharded fill's identity cases the whole-axis kernel and the plain fill;
    and the launcher's own check (``spawn_local_cluster``'s job: a gather
    from the rank's device, a small sharded solve equal to the rank's
    one-device solve) must pass at each size. Every rank must launch the
    fill kernel and load the parent's build.

    The ranks are processes of their own, with their own launch counts:
    ``alongside()``, when given, runs here while they run (the smoke gives
    it [operator], whose phases time no kernel), and its result lands
    under ``"alongside"``. ``after_ranks()``, when given, is called once
    the rank worlds have ended (from the thread that waited for them)."""
    from concurrent.futures import ThreadPoolExecutor

    from grove_tpu_torch.models.scenarios import build_stress_problem
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.ops.nodeaxis import WHOLE
    from grove_tpu_torch.parallel.ring import domain_aggregates
    from grove_tpu_torch.parallel.sharded import fill_cases, run_fill_case, solve_stress_single

    ref = JAX_SHARDED_REFERENCE
    cfg = {k: ref[k] for k in ("chunk_size", "max_waves")}
    cfg.update(n_nodes=ref["nodes"], n_gangs=ref["gangs"])
    problem = build_stress_problem(ref["nodes"], ref["gangs"])
    solve_stress_single(problem, cfg["chunk_size"], cfg["max_waves"], device="cuda")  # warm-up
    fill_batch.launches = 0
    t0 = time.perf_counter()
    single = solve_stress_single(problem, cfg["chunk_size"], cfg["max_waves"], device="cuda")
    single_s = time.perf_counter() - t0
    single_launches = fill_batch.launches
    _check_sharded_vs_jax("sharded: single-device solve", single, ref)
    K, free_agg = domain_aggregates(problem.capacity, problem.topo, problem.seg_starts,
                                    problem.seg_ends, problem.demand[0], problem.count[0],
                                    device="cuda")
    wholes = {name: (run_fill_case(case, WHOLE, "cuda"), run_fill_case(case, WHOLE, "cpu"))
              for name, case in fill_cases().items()}
    print(f"[sharded] (a) {ref['gangs']} gangs x {ref['nodes']} nodes, chunk {cfg['chunk_size']},"
          f" {cfg['max_waves']} waves: single-device solve {single_s:.3f} s (wall, after a"
          f" warm-up), {single['waves']} waves, admitted {int(single['admitted'].sum())}, fill"
          f" launches {single_launches}; equal to the JAX package's", flush=True)
    out = {"single_s": single_s, "single_fill_launches": single_launches, "waves": single["waves"],
           "worlds": {}, "fill_launches": 0, "max_abs_err": 0.0}
    keys = ("admitted", "placed", "score", "chosen_level", "free_after", "pending")
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(_spawn_sharded_worlds, cfg, ref)
        if after_ranks is not None:
            spawned.add_done_callback(lambda _done: after_ranks())
        if alongside is not None:
            out["alongside"] = alongside()
        worlds = spawned.result()
    for world, ranks, wall in worlds:
        tag = f"sharded world {world}"
        want_backend = "nccl" if world == 1 else "gloo"
        for rank, res in enumerate(ranks):
            got = res["stress"]
            for key in keys:
                same = got[key].dtype == single[key].dtype
                if not same or got[key].tobytes() != single[key].tobytes():
                    _fail(f"{tag} rank {rank}: {key} != the single-device solve")
            if int(got["waves"]) != single["waves"]:
                _fail(f"{tag} rank {rank}: waves {int(got['waves'])} != {single['waves']}")
            _check_sharded_vs_jax(f"{tag} rank {rank}", got, ref)
            if str(got["backend"]) != want_backend:
                _fail(f"{tag} rank {rank}: backend {got['backend']}, expected {want_backend}")
            if int(got["fill_launches"]) == 0:
                _fail(f"{tag} rank {rank}: the fill kernel did not launch")
            if int(got["compiled_kernels"]):
                _fail(f"{tag} rank {rank}: rebuilt a kernel instead of loading the parent's build")
            if not bool(res["cluster"]["ok"]):
                _fail(f"{tag} rank {rank}: the launcher's cluster check failed")
            if res["worker"]["blocked_modules"].size:
                _fail(f"{tag} rank {rank}: imported {res['worker']['blocked_modules']}")
            if "ring" in res and (res["ring"]["K"].tobytes() != K.tobytes()
                                  or res["ring"]["free_agg"].tobytes() != free_agg.tobytes()):
                _fail(f"{tag} rank {rank}: ring aggregates != the single-device aggregates")
        if "fill" in ranks[0]:
            for name, (kernel, plain) in wholes.items():
                parts = [{k.split("/", 1)[1]: v for k, v in res["fill"].items()
                          if k.startswith(name + "/")} for res in ranks]
                for key in kernel:
                    got = parts[0][key] if key == "placed" else np.concatenate(
                        [p[key] for p in parts], axis=-2 if key == "free_after" else -1)
                    if not got.tobytes() == kernel[key].tobytes() == plain[key].tobytes():
                        _fail(f"{tag}: sharded fill case {name} {key} != the whole-axis fill")
        launches = [int(r["stress"]["fill_launches"]) for r in ranks]
        collectives = [int(r["stress"]["collectives"]) for r in ranks]
        if len(set(collectives)) != 1:
            _fail(f"{tag}: ranks called {collectives} collectives")
        solve_s = [float(r["stress"]["seconds"]) for r in ranks]
        out["fill_launches"] += sum(launches)
        out["worlds"][world] = {"backend": want_backend, "spawn_wall_s": wall,
                                "solve_s": solve_s, "fill_launches": launches,
                                "collectives": collectives[0],
                                "collectives_per_wave": collectives[0] / single["waves"]}
        print(f"[sharded] world {world} ({want_backend}, ranks on cuda:0): solve"
              f" {max(solve_s):.3f} s"
              f" (slowest rank; single device {single_s:.3f} s), spawn to results {wall:.1f} s;"
              f" {collectives[0]} collectives a rank, {collectives[0] / single['waves']:.1f} a"
              f" wave; fill launches per rank {launches}; every rank equal to the single-device"
              f" solve bit for bit and to the JAX package's; launcher check passed"
              + ("; ring aggregates equal" if world > 1 else "")
              + ("; sharded fill cases equal" if world == 2 else ""), flush=True)
    print("[sharded] the ranks shared one card: these times say nothing of multi-GPU speed",
          flush=True)
    return out


# JAX_OBSERVE_REFERENCE: (q)'s round with the tracer, the gang journeys and
# the wall profiler on (enabled before the world loads), and the explain
# burst after it, from `JAX_PLATFORMS=cpu python scripts/scheduler_reference.py
# observe` (JAX 0.9.0 on the CPU): `observe_summary` of the round (span
# multiset "name<parent", counters, gauges, histogram counts, Prometheus
# series, completed journeys), and per document of `explain_burst` the
# sha256 of its canonical JSON less timing fields, beside its verdict.
JAX_OBSERVE_REFERENCE = {'summary': {'spans': {'quota.order<scheduler.schedule': 1,
                       'quota.reclaim<scheduler.schedule': 1,
                       'scheduler.commit<scheduler.schedule': 1,
                       'scheduler.encode<quota.reclaim': 9,
                       'scheduler.encode<scheduler.schedule': 1,
                       'scheduler.pending-scan<scheduler.schedule': 1,
                       'scheduler.schedule<None': 1,
                       'scheduler.solve<quota.reclaim': 9,
                       'scheduler.solve<scheduler.schedule': 1,
                       'scheduler.status-write<scheduler.schedule': 1,
                       'solver.wave<scheduler.solve': 14},
             'counters': {'journeys_completed_total': 10231.0},
             'gauges': {'gang_solve_waves': 1,
                        'queue_admitted_gangs/tenant-0': 0,
                        'queue_admitted_gangs/tenant-1': 0,
                        'queue_admitted_gangs/tenant-2': 0,
                        'queue_admitted_gangs/tenant-3': 0,
                        'queue_admitted_gangs/tenant-4': 0,
                        'queue_admitted_gangs/tenant-5': 0,
                        'queue_admitted_gangs/tenant-6': 0,
                        'queue_admitted_gangs/tenant-7': 0,
                        'queue_dominant_share/tenant-0': 0.0,
                        'queue_dominant_share/tenant-1': 0.0,
                        'queue_dominant_share/tenant-2': 0.0,
                        'queue_dominant_share/tenant-3': 0.0,
                        'queue_dominant_share/tenant-4': 0.0,
                        'queue_dominant_share/tenant-5': 0.0,
                        'queue_dominant_share/tenant-6': 0.0,
                        'queue_dominant_share/tenant-7': 0.0,
                        'queue_pending_gangs/tenant-0': 1280,
                        'queue_pending_gangs/tenant-1': 1280,
                        'queue_pending_gangs/tenant-2': 1280,
                        'queue_pending_gangs/tenant-3': 1280,
                        'queue_pending_gangs/tenant-4': 1280,
                        'queue_pending_gangs/tenant-5': 1280,
                        'queue_pending_gangs/tenant-6': 1280,
                        'queue_pending_gangs/tenant-7': 1280},
             'histogram_counts': {'gang_solve_seconds': 1.0, 'quota_order_seconds': 1.0},
             'prometheus_series': ['grove_tpu_gang_solve_seconds_count',
                                   'grove_tpu_gang_solve_seconds_sum',
                                   'grove_tpu_gang_solve_seconds{quantile="0.5"}',
                                   'grove_tpu_gang_solve_seconds{quantile="0.9"}',
                                   'grove_tpu_gang_solve_seconds{quantile="0.99"}',
                                   'grove_tpu_gang_solve_waves',
                                   'grove_tpu_journeys_completed_total',
                                   'grove_tpu_queue_admitted_gangs{name="tenant-0"}',
                                   'grove_tpu_queue_admitted_gangs{name="tenant-1"}',
                                   'grove_tpu_queue_admitted_gangs{name="tenant-2"}',
                                   'grove_tpu_queue_admitted_gangs{name="tenant-3"}',
                                   'grove_tpu_queue_admitted_gangs{name="tenant-4"}',
                                   'grove_tpu_queue_admitted_gangs{name="tenant-5"}',
                                   'grove_tpu_queue_admitted_gangs{name="tenant-6"}',
                                   'grove_tpu_queue_admitted_gangs{name="tenant-7"}',
                                   'grove_tpu_queue_dominant_share{name="tenant-0"}',
                                   'grove_tpu_queue_dominant_share{name="tenant-1"}',
                                   'grove_tpu_queue_dominant_share{name="tenant-2"}',
                                   'grove_tpu_queue_dominant_share{name="tenant-3"}',
                                   'grove_tpu_queue_dominant_share{name="tenant-4"}',
                                   'grove_tpu_queue_dominant_share{name="tenant-5"}',
                                   'grove_tpu_queue_dominant_share{name="tenant-6"}',
                                   'grove_tpu_queue_dominant_share{name="tenant-7"}',
                                   'grove_tpu_queue_pending_gangs{name="tenant-0"}',
                                   'grove_tpu_queue_pending_gangs{name="tenant-1"}',
                                   'grove_tpu_queue_pending_gangs{name="tenant-2"}',
                                   'grove_tpu_queue_pending_gangs{name="tenant-3"}',
                                   'grove_tpu_queue_pending_gangs{name="tenant-4"}',
                                   'grove_tpu_queue_pending_gangs{name="tenant-5"}',
                                   'grove_tpu_queue_pending_gangs{name="tenant-6"}',
                                   'grove_tpu_queue_pending_gangs{name="tenant-7"}',
                                   'grove_tpu_quota_order_seconds_count',
                                   'grove_tpu_quota_order_seconds_sum',
                                   'grove_tpu_quota_order_seconds{quantile="0.5"}',
                                   'grove_tpu_quota_order_seconds{quantile="0.9"}',
                                   'grove_tpu_quota_order_seconds{quantile="0.99"}'],
             'journeys_completed_total': 10231},
 'explain': {'explain tenant-0/g5768-0': {'sha256': '4aed2651a35708bb2a6dc136b0a35fc1511d8077bed4425a61b11a2d09daa232',
                                          'state': 'pending',
                                          'fits_now': True,
                                          'binding_constraint': None,
                                          'detail': None},
             'explain tenant-0/g6232-0': {'sha256': '5203bfe46525d270a56f4a740f255e3505969f64019bb94a0d7736c44ee23b6b',
                                          'state': 'pending',
                                          'fits_now': True,
                                          'binding_constraint': None,
                                          'detail': None},
             'explain tenant-0/g8536-0': {'sha256': 'fad41c189eafa907b433c1bb72effeea5a46be9751706d711e6b1bba1a7a87e7',
                                          'state': 'pending',
                                          'fits_now': True,
                                          'binding_constraint': None,
                                          'detail': None},
             'explain tenant-0/g8608-0': {'sha256': 'eed720669795a0a28831feb57e8eb8cc9d2e8c01b84ebd030733eb3ec986d215',
                                          'state': 'pending',
                                          'fits_now': True,
                                          'binding_constraint': None,
                                          'detail': None},
             'explain tenant-0/g8784-0': {'sha256': '52ca4525179735c58bf90da0f4129323d9a5aecd07e6427058d08f5e436a6e25',
                                          'state': 'pending',
                                          'fits_now': True,
                                          'binding_constraint': None,
                                          'detail': None},
             'explain tenant-0/g9248-0': {'sha256': 'db45ee29127157b756570f6b5117e80c305cd16b8534c77bb0f468e793df5ae4',
                                          'state': 'pending',
                                          'fits_now': True,
                                          'binding_constraint': None,
                                          'detail': None},
             'explain tenant-0/g9616-0': {'sha256': 'a3b854c795cc53995b21343f49ec24a68a93428fd16682f1703e8cd497d0e880',
                                          'state': 'pending',
                                          'fits_now': True,
                                          'binding_constraint': None,
                                          'detail': None},
             'explain tenant-0/g9968-0': {'sha256': '4a50e2eb349f2e702dc1719101689b6df99d2ba423fb8a89ef5e69b0aa3573cd',
                                          'state': 'pending',
                                          'fits_now': False,
                                          'binding_constraint': 'quota',
                                          'detail': 'queue-position'},
             'explain tenant-0/g9992-0': {'sha256': '403f895fd89b18e027fcaa73cdf7d0a611288b764ad6652ea054417f4ae194aa',
                                          'state': 'pending',
                                          'fits_now': True,
                                          'binding_constraint': None,
                                          'detail': None},
             'explain tenant-0/g0-0': {'sha256': 'e41b33717e1d0e055fa816bdb5e00f12f7a161fdf16be8c97d4fa83d1d9ec008',
                                       'state': 'scheduled',
                                       'fits_now': True,
                                       'binding_constraint': None},
             'explain default/no-such-gang': {'sha256': '74234e98afe7498fb5daf1f36ac2d78acc339464f950703b8c019892f982b90b'},
             'capacity': {'sha256': '6d3123f79ade0bff0e4af41c814da12ae684c18dcb22fd7a4fb3553a284fce04'},
             'whatif drain-node node-0': {'sha256': '19a23951fc3e008f98034ea2686ad891904bd738de10d597349155df340bbc6c',
                                          'state': 'pending',
                                          'fits_now': True,
                                          'binding_constraint': None,
                                          'detail': None,
                                          'flipped': False},
             'whatif set-queue tenant-0': {'sha256': '3dec3f2ebd0d4ad64ff30fe4a0a99f9bb34f5d210e73d67547da3498a0bc0f4a',
                                           'state': 'pending',
                                           'fits_now': True,
                                           'binding_constraint': None,
                                           'detail': None,
                                           'flipped': False}}}
PROM_LINE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_]+="[^"]*",?)+\})? (\S+)$')


def phase_observe(q_wall_s, card, device="cuda", n_nodes=None, n_gangs=None,
                  reference=JAX_OBSERVE_REFERENCE) -> dict:
    """[observe]: (q)'s round with the glass-box layer on, then an explain
    burst over the same store, each held to the JAX package's."""
    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.api.wire import decode_object
    from grove_tpu_torch.models.scenarios import (
        EventCapture, doc_digests, explain_burst, observe_summary, round_summary,
        scheduler_world)
    from grove_tpu_torch.observability.events import EVENTS
    from grove_tpu_torch.observability.explain import ExplainEngine
    from grove_tpu_torch.observability.journey import JOURNEY_PHASES, JOURNEYS
    from grove_tpu_torch.observability.metrics import METRICS
    from grove_tpu_torch.observability.profile import PROFILER, disabled_check_cost_ns
    from grove_tpu_torch.observability.tracing import TRACER, validate_chrome_trace
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda
    from grove_tpu_torch.runtime.clock import VirtualClock
    from grove_tpu_torch.runtime.store import Store
    from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
    from grove_tpu_torch.solver.scheduler import GangScheduler

    layers = (TRACER, JOURNEYS, PROFILER)
    for layer in layers:
        layer.reset()
        layer.enable()
    METRICS.reset()
    world = scheduler_world("q", n_nodes, n_gangs)
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store, make_nodes(*world["nodes"]))
    sched = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"], device=device)
    EVENTS.reset()
    EVENTS.clock = store.clock
    t0 = time.perf_counter()
    for doc in world["queues"] + world["rounds"][0]:
        store.create(decode_object(doc), consume=True)
    load_s = time.perf_counter() - t0
    TRACER.reset()
    PROFILER.reset()
    METRICS.reset()
    fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0
    with EventCapture(EVENTS) as cap:
        t0 = time.perf_counter()
        sched.schedule_pending()
        wall = time.perf_counter() - t0
    launches = {"fill": fill_batch.launches, "drf_shares": share_table_cuda.launches,
                "drf_merge": merge_cuda.launches}
    for layer in layers:
        layer.disable()
    tag = "observe (q) round 1"
    if n_nodes is None and n_gangs is None:
        got = round_summary(store, cluster, cap.events)
        want = dict(JAX_SCHEDULER_REFERENCE["q"][0])
        if not np.isclose(got["score_sum"], want.pop("score_sum"), rtol=1e-6, atol=0):
            _fail(f"{tag}: score sum {got['score_sum']} != the JAX package's")
        for key, value in want.items():
            if got[key] != value:
                _fail(f"{tag}: {key} {got[key]} != the JAX package's {value}")
    check_world_valid(tag, store, cluster)
    summary = observe_summary(TRACER, METRICS, JOURNEYS)
    for key, value in reference["summary"].items():
        if summary[key] != value:
            _fail(f"{tag}: {key} {summary[key]} != the JAX package's {value}")
    if device != "cpu" and not all(launches.values()):
        _fail(f"{tag}: the round did not launch every kernel: {launches}")
    problems = validate_chrome_trace(TRACER.chrome_trace())
    if problems:
        _fail(f"{tag}: the Chrome trace is malformed: {problems[:5]}")
    prom = METRICS.prometheus_text().splitlines()
    bad = [ln for ln in prom if not (m := PROM_LINE.match(ln)) or not _is_float(m.group(3))]
    if bad or not prom:
        _fail(f"{tag}: Prometheus lines that do not parse: {bad[:5]}")
    admitted = incomplete = 0
    for gang in store.scan("PodGang"):
        if not any(c.type == "Scheduled" and c.status == "True" for c in gang.status.conditions):
            continue
        admitted += 1
        doc = JOURNEYS.journey(gang.metadata.namespace, gang.metadata.name)
        if doc is None or [p["phase"] for p in doc["phases"]] != list(JOURNEY_PHASES):
            incomplete += 1
    if not admitted or incomplete:
        _fail(f"{tag}: {incomplete} of {admitted} admitted gangs' journeys are not complete")
    report = PROFILER.report(wall_seconds=wall, top=6)
    if report["coverage"] < 0.95:
        _fail(f"{tag}: the profiler attributes {report['coverage']:.4f} of the round's wall")
    print(f"[observe] (q) round 1 traced (tracer, journeys, profiler on; world load {load_s:.3f} s"
          f" before it): wall {wall:.3f} s beside [sched]'s (q) round 1 {q_wall_s:.3f} s; equal to"
          f" the JAX package's: round, {sum(summary['spans'].values())} spans"
          f" ({len(summary['spans'])} name<parent pairs), {len(summary['gauges'])} gauges,"
          f" {len(prom)} Prometheus lines ({len(summary['prometheus_series'])} series), journeys"
          f" completed {summary['journeys_completed_total']} (all {admitted} admitted complete);"
          f" Chrome trace valid ({len(TRACER.spans())} events); profiler coverage"
          f" {report['coverage']:.4f}; launches fill {launches['fill']}, DRF"
          f" {launches['drf_shares']} + {launches['drf_merge']} | {card}", flush=True)
    print("[observe] profiler, top phases by self time: " + "; ".join(
        f"{r['controller']}/{r['phase']}@{r['shard']} {r['total_s']:.3f} s ({r['count']} x)"
        for r in report["phases"]) + f" | {card}", flush=True)
    # the explain burst, read-only over the same store
    engine = ExplainEngine(sched)
    pin = store.resource_version_vector()
    METRICS.reset()
    fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0
    t0 = time.perf_counter()
    burst = doc_digests(explain_burst(engine, store, cluster))
    burst_s = time.perf_counter() - t0
    explain_launches = {"fill": fill_batch.launches, "drf_shares": share_table_cuda.launches,
                        "drf_merge": merge_cuda.launches}
    if store.resource_version_vector() != pin:
        _fail(f"observe: the explain burst moved the store ({pin} -> "
              f"{store.resource_version_vector()})")
    if list(burst) != list(reference["explain"]):
        _fail(f"observe: explain burst asked {list(burst)}, the JAX one {list(reference['explain'])}")
    for key, want in reference["explain"].items():
        if burst[key] != want:
            _fail(f"observe: {key}: {burst[key]} != the JAX engine's {want}")
    if device != "cpu" and not all(explain_launches.values()):
        _fail(f"observe: the explain burst did not launch every kernel: {explain_launches}")
    latency = sorted(METRICS.histograms.get("explain_verdict_seconds", []))
    out = {"wall_s": wall, "load_s": load_s, "q_sched_wall_s": q_wall_s,
           "coverage": report["coverage"], "top_phases": report["phases"],
           "disabled_check_ns": disabled_check_cost_ns(),
           "explain_burst_s": burst_s, "explains": len(latency),
           "explain_p50_s": _percentile(latency, 0.5), "explain_p99_s": _percentile(latency, 0.99),
           **{f"{k}_launches": v for k, v in launches.items()},
           **{f"explain_{k}_launches": v for k, v in explain_launches.items()}}
    print(f"[observe] explain burst ({len(burst)} documents: {len(latency)} explains, capacity, a"
          f" drain and a queue what-if) {burst_s:.3f} s, each document equal to the JAX engine's;"
          f" explain latency p50 {out['explain_p50_s'] * 1e3:.1f} ms, p99"
          f" {out['explain_p99_s'] * 1e3:.1f} ms; trial solves launched fill"
          f" {explain_launches['fill']}, order views DRF {explain_launches['drf_shares']} +"
          f" {explain_launches['drf_merge']}; store untouched; all-off check"
          f" {out['disabled_check_ns']:.1f} ns | {card}", flush=True)
    return out


# JAX_SLO_REFERENCE: the SLO world (models/scenarios.run_slo_world: the churn
# world's (q) round and its first 6 ticks, the clock 10 s a round, the
# tracer, journeys, time series, SLO engine, forecaster and flight recorder
# on), from `JAX_PLATFORMS=cpu python scripts/scheduler_reference.py slo
# --ticks 6`
# (JAX 0.9.0 on the CPU): per round round_summary and the sha256 of the
# series windows; then the windows, the SLO status, the forecast and the
# flight bundle's summary.
JAX_SLO_REFERENCE = {'dumps': 1,
 'flight': {'commits': 945,
            'commits_sha256': 'fad040ca20b6d337eb20d83c7875b1e9233d175d40e6377225f7f132cdce57ef',
            'detail': 'objective=backlog-wait window=60s attainment=0.8333 target=0.9 '
                      'indicator=queue_wait_vt/tenant-0:last < 45 over 10s target 90% budget 60s '
                      'burn 2x 10s/60s',
            'errors': 0,
            'events': 1024,
            'events_sha256': 'ff23646e9092bbfba7fddceab2ea758a5f41863e608dbb9b9b927907bfafd79c',
            'reason': 'SloBreach',
            'records': 1024,
            'spans': {'quota.order': 5,
                      'quota.reclaim': 5,
                      'scheduler.commit': 5,
                      'scheduler.encode': 10,
                      'scheduler.pending-scan': 5,
                      'scheduler.schedule': 6,
                      'scheduler.solve': 15,
                      'scheduler.status-write': 6,
                      'solve.delta_encode': 5,
                      'solver.wave': 17},
            'vt': 60.0},
 'forecast': {'horizon_s': 300.0,
              'last': 35726.0,
              'model': 'persistence',
              'n': 7,
              'now': 70.0,
              'peak': {'at_s': 95.0, 'mean': 35726.0},
              'period_s': 600.0,
              'points': [{'at_s': 95.0,
                          'hi': 35968.750228567114,
                          'lo': 35483.249771432886,
                          'mean': 35726.0},
                         {'at_s': 120.0,
                          'hi': 35968.750228567114,
                          'lo': 35483.249771432886,
                          'mean': 35726.0},
                         {'at_s': 145.0,
                          'hi': 35968.750228567114,
                          'lo': 35483.249771432886,
                          'mean': 35726.0},
                         {'at_s': 170.0,
                          'hi': 35968.750228567114,
                          'lo': 35483.249771432886,
                          'mean': 35726.0},
                         {'at_s': 195.0,
                          'hi': 35968.750228567114,
                          'lo': 35483.249771432886,
                          'mean': 35726.0},
                         {'at_s': 220.0,
                          'hi': 35968.750228567114,
                          'lo': 35483.249771432886,
                          'mean': 35726.0},
                         {'at_s': 245.0,
                          'hi': 35968.750228567114,
                          'lo': 35483.249771432886,
                          'mean': 35726.0},
                         {'at_s': 270.0,
                          'hi': 35968.750228567114,
                          'lo': 35483.249771432886,
                          'mean': 35726.0},
                         {'at_s': 295.0,
                          'hi': 35968.750228567114,
                          'lo': 35483.249771432886,
                          'mean': 35726.0},
                         {'at_s': 320.0,
                          'hi': 35968.750228567114,
                          'lo': 35483.249771432886,
                          'mean': 35726.0},
                         {'at_s': 345.0,
                          'hi': 35968.750228567114,
                          'lo': 35483.249771432886,
                          'mean': 35726.0},
                         {'at_s': 370.0,
                          'hi': 35968.750228567114,
                          'lo': 35483.249771432886,
                          'mean': 35726.0}],
              'series': 'queue_usage/tenant-0',
              'sigma': 121.37511428355872,
              'slope_per_s': 0.0},
 'rounds': [{'admitted': 10231,
             'admitted_per_queue': {'tenant-0': 1271,
                                    'tenant-1': 1280,
                                    'tenant-2': 1280,
                                    'tenant-3': 1280,
                                    'tenant-4': 1280,
                                    'tenant-5': 1280,
                                    'tenant-6': 1280,
                                    'tenant-7': 1280},
             'bindings': 34833,
             'bindings_sha256': '7ff9f94016b74cc5ea0e31eb3c29f4ea4fe0ae8f674ab4586e1f50bd4f7c744a',
             'bound': 34833,
             'events_by_reason': {'GangAdmitted': 10231, 'GangDeferred': 9, 'PodBound': 34833},
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'score_sum': 10084.246239542961,
             'windows_sha256': '8b9416db0baa3340875fde022650ae382ab3d7ad451eaffbb551bb0ab63ecb2f'},
            {'admitted': 6,
             'admitted_per_queue': {'tenant-0': 6},
             'bindings': 34880,
             'bindings_sha256': 'cebb696007c67301b1c42dd66443189972f1a61a61b86a3bb314a7ed44df32a1',
             'bound': 47,
             'events_by_reason': {'GangAdmitted': 6, 'GangDeferred': 5, 'PodBound': 47},
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'score_sum': 3.846746325492859,
             'windows_sha256': 'd299f883dcad01719a840d3d755835bd45a4d0d5d95d62d5dc953aef09f76170'},
            {'admitted': 4,
             'admitted_per_queue': {'tenant-0': 4},
             'bindings': 34900,
             'bindings_sha256': '37fbfb16f5bfe96f5041383a85523a7d7811865a33ef0d3bf1484a7b3ae665cc',
             'bound': 21,
             'events_by_reason': {'GangAdmitted': 4, 'GangDeferred': 2, 'PodBound': 21},
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'score_sum': 2.885926067829132,
             'windows_sha256': '0383aeaef4811316db598877118391dd690c2a58b1ed8c20642cd51258ab9ced'},
            {'admitted': 2,
             'admitted_per_queue': {'tenant-0': 1, 'tenant-1': 1},
             'bindings': 34912,
             'bindings_sha256': '01ad51b0c30b3a40f9c6b2bf99358126a4fec14cf729c8d05c9e8f16d3888e52',
             'bound': 12,
             'events_by_reason': {'GangAdmitted': 2, 'GangDeferred': 2, 'PodBound': 12},
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'score_sum': 1.7916667461395264,
             'windows_sha256': 'd0e38cf2de33be9f9f75e88b6c557d265b1edb5d7ac3d22e4da391b022f91ed8'},
            {'admitted': 2,
             'admitted_per_queue': {'tenant-2': 1, 'tenant-3': 1},
             'bindings': 34916,
             'bindings_sha256': '6d6f734446588fd3e66c8df26850b5a876cb3979dbbfa97bdcea944254c35192',
             'bound': 4,
             'events_by_reason': {'GangAdmitted': 2, 'GangDeferred': 2, 'PodBound': 4},
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'score_sum': 2.0,
             'windows_sha256': 'af264f9abc452d61ccfa436c69537cbce5083592be6893dd4be58589b042d665'},
            {'admitted': 0,
             'admitted_per_queue': {},
             'bindings': 34916,
             'bindings_sha256': '6d6f734446588fd3e66c8df26850b5a876cb3979dbbfa97bdcea944254c35192',
             'bound': 0,
             'events_by_reason': {'FlightRecorderDumped': 1, 'GangDeferred': 2, 'SloBreach': 1},
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'score_sum': 0.0,
             'windows_sha256': '4e021a2db5e4ee1dacbd64992dcef23952e2a9bfd116a5e54cde1b89d18e5c61'},
            {'admitted': 1,
             'admitted_per_queue': {'tenant-4': 1},
             'bindings': 34920,
             'bindings_sha256': '16c9dab416c52572af7ccb6bd7484fb0a0660b24967ea982c5c43e4a012881cf',
             'bound': 4,
             'events_by_reason': {'GangAdmitted': 1,
                                  'GangDeferred': 2,
                                  'PodBound': 4,
                                  'SloBurnRateHigh': 1},
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'score_sum': 1.0,
             'windows_sha256': '5b8523cf4d4a4fe0ee372b41cc0a7ab4b116fb7960800e7f58b9a430c6dc7a94'}],
 'status': {'enabled': True,
            'objectives': [{'attainment': 0.6666666666666666,
                            'bad': 2,
                            'breaches': 1,
                            'budget_remaining': 0.0,
                            'burn_rate_fast': 10.0,
                            'burn_rate_slow': 3.3333,
                            'evaluations': 7,
                            'good': 5,
                            'name': 'backlog-wait',
                            'recoveries': 0,
                            'series': 'queue_wait_vt/tenant-0',
                            'spec': 'queue_wait_vt/tenant-0:last < 45 over 10s target 90% budget '
                                    '60s burn 2x 10s/60s',
                            'state': 'breached',
                            'value': 60.0},
                           {'attainment': 1.0,
                            'bad': 0,
                            'breaches': 0,
                            'budget_remaining': 1.0,
                            'burn_rate_fast': 0.0,
                            'burn_rate_slow': 0.0,
                            'evaluations': 7,
                            'good': 7,
                            'name': 'admission',
                            'recoveries': 0,
                            'series': 'admission_latency_vt',
                            'spec': 'admission_latency_vt:max < 60 over 30s target 90% budget 180s '
                                    'burn 6x 30s/180s',
                            'state': 'ok',
                            'value': 10.0}],
            'series': {'admission_latency_vt': {'count': 10246,
                                                'kind': 'dist',
                                                'max': 30.0,
                                                'mean': 10.01073589693539,
                                                'p50': 12.582912,
                                                'p99': 12.582912,
                                                'rate': 34.153333333333336},
                       'queue_usage/tenant-0': {'kind': 'gauge',
                                                'last': 35726.0,
                                                'max': 35726.0,
                                                'mean': 35651.71428571428,
                                                'min': 35376.0,
                                                'n': 7,
                                                'p50': 35726.0,
                                                'p99': 35726.0},
                       'queue_usage/tenant-1': {'kind': 'gauge',
                                                'last': 7676.0,
                                                'max': 7676.0,
                                                'mean': 7672.571428571428,
                                                'min': 7668.0,
                                                'n': 7,
                                                'p50': 7676.0,
                                                'p99': 7676.0},
                       'queue_usage/tenant-2': {'kind': 'gauge',
                                                'last': 7700.0,
                                                'max': 7700.0,
                                                'mean': 7697.714285714285,
                                                'min': 7696.0,
                                                'n': 7,
                                                'p50': 7696.0,
                                                'p99': 7700.0},
                       'queue_usage/tenant-3': {'kind': 'gauge',
                                                'last': 7784.0,
                                                'max': 7784.0,
                                                'mean': 7781.714285714285,
                                                'min': 7780.0,
                                                'n': 7,
                                                'p50': 7780.0,
                                                'p99': 7784.0},
                       'queue_usage/tenant-4': {'kind': 'gauge',
                                                'last': 7662.0,
                                                'max': 7662.0,
                                                'mean': 7655.142857142857,
                                                'min': 7654.0,
                                                'n': 7,
                                                'p50': 7654.0,
                                                'p99': 7662.0},
                       'queue_usage/tenant-5': {'kind': 'gauge',
                                                'last': 7678.0,
                                                'max': 7678.0,
                                                'mean': 7678.0,
                                                'min': 7678.0,
                                                'n': 7,
                                                'p50': 7678.0,
                                                'p99': 7678.0},
                       'queue_usage/tenant-6': {'kind': 'gauge',
                                                'last': 7630.0,
                                                'max': 7630.0,
                                                'mean': 7630.0,
                                                'min': 7630.0,
                                                'n': 7,
                                                'p50': 7630.0,
                                                'p99': 7630.0},
                       'queue_usage/tenant-7': {'kind': 'gauge',
                                                'last': 7714.0,
                                                'max': 7714.0,
                                                'mean': 7714.0,
                                                'min': 7714.0,
                                                'n': 7,
                                                'p50': 7714.0,
                                                'p99': 7714.0},
                       'queue_wait_vt/tenant-0': {'kind': 'gauge',
                                                  'last': 60.0,
                                                  'max': 60.0,
                                                  'mean': 32.857142857142854,
                                                  'min': 10.0,
                                                  'n': 7,
                                                  'p50': 30.0,
                                                  'p99': 60.0},
                       'queue_wait_vt/tenant-1': {'kind': 'gauge',
                                                  'last': 60.0,
                                                  'max': 60.0,
                                                  'mean': 35.0,
                                                  'min': 10.0,
                                                  'n': 6,
                                                  'p50': 30.0,
                                                  'p99': 60.0},
                       'rate:journeys_completed_total': {'kind': 'gauge',
                                                         'last': 1.0,
                                                         'max': 10231.0,
                                                         'mean': 1463.7142857142858,
                                                         'min': 0.0,
                                                         'n': 7,
                                                         'p50': 2.0,
                                                         'p99': 10231.0},
                       'ready_fraction': {'kind': 'gauge',
                                          'last': 0.0,
                                          'max': 0.0,
                                          'mean': 0.0,
                                          'min': 0.0,
                                          'n': 7,
                                          'p50': 0.0,
                                          'p99': 0.0},
                       'slo:admission:good': {'kind': 'gauge',
                                              'last': 1.0,
                                              'max': 1.0,
                                              'mean': 1.0,
                                              'min': 1.0,
                                              'n': 7,
                                              'p50': 1.0,
                                              'p99': 1.0},
                       'slo:backlog-wait:good': {'kind': 'gauge',
                                                 'last': 0.0,
                                                 'max': 1.0,
                                                 'mean': 0.7142857142857143,
                                                 'min': 0.0,
                                                 'n': 7,
                                                 'p50': 1.0,
                                                 'p99': 1.0}}},
 'windows': {'admission_latency': {'count': 10246},
             'admission_latency_vt': {'count': 10246,
                                      'kind': 'dist',
                                      'max': 30.0,
                                      'mean': 10.01073589693539,
                                      'p50': 12.582912,
                                      'p99': 12.582912,
                                      'rate': 34.153333333333336},
             'queue_usage/tenant-0': {'kind': 'gauge',
                                      'last': 35726.0,
                                      'max': 35726.0,
                                      'mean': 35651.71428571428,
                                      'min': 35376.0,
                                      'n': 7,
                                      'p50': 35726.0,
                                      'p99': 35726.0},
             'queue_usage/tenant-1': {'kind': 'gauge',
                                      'last': 7676.0,
                                      'max': 7676.0,
                                      'mean': 7672.571428571428,
                                      'min': 7668.0,
                                      'n': 7,
                                      'p50': 7676.0,
                                      'p99': 7676.0},
             'queue_usage/tenant-2': {'kind': 'gauge',
                                      'last': 7700.0,
                                      'max': 7700.0,
                                      'mean': 7697.714285714285,
                                      'min': 7696.0,
                                      'n': 7,
                                      'p50': 7696.0,
                                      'p99': 7700.0},
             'queue_usage/tenant-3': {'kind': 'gauge',
                                      'last': 7784.0,
                                      'max': 7784.0,
                                      'mean': 7781.714285714285,
                                      'min': 7780.0,
                                      'n': 7,
                                      'p50': 7780.0,
                                      'p99': 7784.0},
             'queue_usage/tenant-4': {'kind': 'gauge',
                                      'last': 7662.0,
                                      'max': 7662.0,
                                      'mean': 7655.142857142857,
                                      'min': 7654.0,
                                      'n': 7,
                                      'p50': 7654.0,
                                      'p99': 7662.0},
             'queue_usage/tenant-5': {'kind': 'gauge',
                                      'last': 7678.0,
                                      'max': 7678.0,
                                      'mean': 7678.0,
                                      'min': 7678.0,
                                      'n': 7,
                                      'p50': 7678.0,
                                      'p99': 7678.0},
             'queue_usage/tenant-6': {'kind': 'gauge',
                                      'last': 7630.0,
                                      'max': 7630.0,
                                      'mean': 7630.0,
                                      'min': 7630.0,
                                      'n': 7,
                                      'p50': 7630.0,
                                      'p99': 7630.0},
             'queue_usage/tenant-7': {'kind': 'gauge',
                                      'last': 7714.0,
                                      'max': 7714.0,
                                      'mean': 7714.0,
                                      'min': 7714.0,
                                      'n': 7,
                                      'p50': 7714.0,
                                      'p99': 7714.0},
             'queue_wait_vt/tenant-0': {'kind': 'gauge',
                                        'last': 60.0,
                                        'max': 60.0,
                                        'mean': 32.857142857142854,
                                        'min': 10.0,
                                        'n': 7,
                                        'p50': 30.0,
                                        'p99': 60.0},
             'queue_wait_vt/tenant-1': {'kind': 'gauge',
                                        'last': 60.0,
                                        'max': 60.0,
                                        'mean': 35.0,
                                        'min': 10.0,
                                        'n': 6,
                                        'p50': 30.0,
                                        'p99': 60.0},
             'rate:journeys_completed_total': {'kind': 'gauge',
                                               'last': 1.0,
                                               'max': 10231.0,
                                               'mean': 1463.7142857142858,
                                               'min': 0.0,
                                               'n': 7,
                                               'p50': 2.0,
                                               'p99': 10231.0},
             'ready_fraction': {'kind': 'gauge',
                                'last': 0.0,
                                'max': 0.0,
                                'mean': 0.0,
                                'min': 0.0,
                                'n': 7,
                                'p50': 0.0,
                                'p99': 0.0},
             'slo:admission:good': {'kind': 'gauge',
                                    'last': 1.0,
                                    'max': 1.0,
                                    'mean': 1.0,
                                    'min': 1.0,
                                    'n': 7,
                                    'p50': 1.0,
                                    'p99': 1.0},
             'slo:backlog-wait:good': {'kind': 'gauge',
                                       'last': 0.0,
                                       'max': 1.0,
                                       'mean': 0.7142857142857143,
                                       'min': 0.0,
                                       'n': 7,
                                       'p50': 1.0,
                                       'p99': 1.0}}}

# [sidecar]: the port's gRPC sidecar in the smoke process. grpcio and
# protobuf are optional dependencies of the port: without them the phase
# says which one is missing and runs nothing.
SIDECAR_RPC_TIMEOUT_S = 600.0


def _sidecar_missing():
    """The missing optional package and its ImportError, or None."""
    from grove_tpu_torch.cluster import grpcsolver

    if grpcsolver.grpc is None:
        return "grpcio", grpcsolver._GRPC_IMPORT_ERROR
    if grpcsolver.pb is None:
        return "protobuf", grpcsolver._PROTOBUF_IMPORT_ERROR
    return None


def phase_sidecar(main_path, card, device="cuda", n_nodes=None, n_gangs=None) -> dict:
    """[sidecar]: the port's SolverServer on the card inside this process:
    (a) through SolverClient equal to [main]'s solve_decoded answer, (q)
    round 1 through a GangScheduler whose solves go to the sidecar equal to
    the JAX round, a health Check and a malformed request. ``device`` and
    the cut (``n_nodes``, ``n_gangs``; the JAX round is held only uncut)
    rehearse the phase on the CPU, with ``main_path["a_response"]`` the
    solve_decoded answer of the same cut."""
    missing = _sidecar_missing()
    if missing is not None:
        print(f"[sidecar] {missing[0]} is not installed ({type(missing[1]).__name__}:"
              f" {missing[1]}); the wire layer has only its CPU tests here", flush=True)
        return {"skipped": f"{missing[0]}: {missing[1]}"}
    import grpc

    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.api.wire import decode_object
    from grove_tpu_torch.cluster import grpcsolver
    from grove_tpu_torch.cluster.grpcsolver import solve_decoded
    from grove_tpu_torch.models.scenarios import (
        STRESS_CAPACITY, EventCapture, round_summary, scheduler_world, stress_gang_specs)
    from grove_tpu_torch.observability.events import EVENTS
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda
    from grove_tpu_torch.runtime.clock import VirtualClock
    from grove_tpu_torch.runtime.store import Store
    from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
    from grove_tpu_torch.solver.encode import StickyGroupPad
    from grove_tpu_torch.solver.scheduler import GangScheduler

    # the endpoint's sticky padding starts fresh, as [main]'s did for (a)
    grpcsolver._PAD_GROUPS = StickyGroupPad()
    server = grpcsolver.SolverServer(device=device).start()
    client = grpcsolver.SolverClient(server.address)
    out = {"address": server.address}
    try:
        if not client.healthy(timeout=30.0):
            _fail("sidecar: the health Check does not read SERVING")
        nodes = make_nodes(n_nodes or 5120, dict(STRESS_CAPACITY), 8, 8)
        t0 = time.perf_counter()
        specs = stress_gang_specs(n_gangs or 10240, seed=0)
        request = grpcsolver.build_request(nodes, specs, ClusterTopology())
        encode_s = time.perf_counter() - t0
        fill_batch.launches = 0
        t0 = time.perf_counter()
        response = client.solve(request, timeout=SIDECAR_RPC_TIMEOUT_S)
        rpc_s = time.perf_counter() - t0
        fills = fill_batch.launches
        want = main_path["a_response"]["placements"]
        if len(response.placements) != len(want):
            _fail(f"sidecar (a): {len(response.placements)} placements, [main] {len(want)}")
        for got, row in zip(response.placements, want):
            assignments = [(a.group, a.node, a.count) for a in got.assignments]
            fields = ((got.gang, row["gang"]), (got.admitted, row["admitted"]),
                      (got.placement_score, row["placement_score"]),
                      (got.chosen_level_key, row["chosen_level_key"]),
                      (assignments, row["assignments"]))
            if any(a != b for a, b in fields):
                _fail(f"sidecar (a): gang {row['gang']} differs from [main]'s solve_decoded")
        if fills == 0 and device != "cpu":
            _fail("sidecar (a): the RPC's solve did not launch the fill kernel")
        # [main]'s (a) was the process's first solve; the same solve in
        # process once more, warm, is the wall the RPC's is compared with
        t0 = time.perf_counter()
        warm = solve_decoded(nodes, specs, ClusterTopology(), device=device,
                             pad_groups=StickyGroupPad())
        warm_s = time.perf_counter() - t0
        if warm["placements"] != want:
            _fail("sidecar (a): a second solve_decoded of (a) differs from [main]'s")
        admitted = sum(p.admitted for p in response.placements)
        out["a"] = {"request_bytes": request.ByteSize(), "response_bytes": response.ByteSize(),
                    "build_request_s": encode_s, "rpc_wall_s": rpc_s,
                    "solve_seconds": response.solve_seconds, "warm_wall_s": warm_s,
                    "warm_solve_seconds": warm["solve_seconds"],
                    "main_wall_s": main_path["a"]["wall_s"],
                    "main_solve_seconds": main_path["a"]["solve_seconds"],
                    "admitted": admitted, "fill_launches": fills}
        print(f"[sidecar] (a) {len(request.gangs)} gangs x {len(nodes)} nodes through"
              f" SolverClient -> SolverServer ({server.address}, {device}): request {request.ByteSize()} bytes (built in"
              f" {encode_s:.3f} s), response {response.ByteSize()} bytes; RPC wall"
              f" {rpc_s:.3f} s (solve_seconds {response.solve_seconds:.3f}) beside"
              f" solve_decoded's {warm_s:.3f} s (solve_seconds {warm['solve_seconds']:.3f})"
              f" right after it, and [main]'s {main_path['a']['wall_s']:.3f} s (solve_seconds"
              f" {main_path['a']['solve_seconds']:.3f}; the process's first solve); admitted"
              f" {admitted}, every placement equal to [main]'s; fill launches of the RPC"
              f" {fills} | {card}", flush=True)
        # (q) round 1 with every solve of the round going to the sidecar
        world = scheduler_world("q", n_nodes, n_gangs)
        store = Store(VirtualClock(0.0))
        cluster = SimCluster(store, make_nodes(*world["nodes"]))
        sched = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"],
                              solver_sidecar=server.address, device=device)
        sched.sidecar_timeout = SIDECAR_RPC_TIMEOUT_S
        EVENTS.reset()
        EVENTS.clock = store.clock
        for doc in world["queues"] + world["rounds"][0]:
            store.create(decode_object(doc), consume=True)
        fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0
        with EventCapture(EVENTS) as cap:
            t0 = time.perf_counter()
            sched.schedule_pending()
            wall = time.perf_counter() - t0
        launches = {"fill": fill_batch.launches, "drf_shares": share_table_cuda.launches,
                    "drf_merge": merge_cuda.launches}
        tag = "sidecar (q) round 1"
        got = round_summary(store, cluster, cap.events)
        if n_nodes is None and n_gangs is None:
            want = dict(JAX_SCHEDULER_REFERENCE["q"][0])
            if not np.isclose(got["score_sum"], want.pop("score_sum"), rtol=1e-6, atol=0):
                _fail(f"{tag}: score sum {got['score_sum']} != the JAX package's")
            for key, value in want.items():
                if got[key] != value:
                    _fail(f"{tag}: {key} {got[key]} != the JAX package's {value}")
        check_world_valid(tag, store, cluster)
        if sched.sidecar_fallbacks:
            _fail(f"{tag}: {sched.sidecar_fallbacks} solves fell back in process")
        if device != "cpu" and not all(launches.values()):
            _fail(f"{tag}: the round did not launch every kernel: {launches}")
        out["q"] = {"wall_s": wall, "sidecar_fallbacks": sched.sidecar_fallbacks,
                    **{f"{k}_launches": v for k, v in launches.items()},
                    **{k: got[k] for k in ("admitted", "bound", "evicted")}}
        print(f"[sidecar] (q) round 1 through GangScheduler(solver_sidecar=...): wall"
              f" {wall:.3f} s; admitted {got['admitted']}, bound {got['bound']}; equal to the JAX"
              f" package's, valid; sidecar fallbacks 0; launches fill {launches['fill']}"
              f" (the sidecar's solves), DRF {launches['drf_shares']} +"
              f" {launches['drf_merge']} (the round's order) | {card}", flush=True)
        # one malformed request: a required key that is no level of the topology
        bad = grpcsolver.build_request(
            nodes[:8], [{"name": "bad", "required_key": "example.com/no-such-level",
                         "groups": [{"name": "bad-0", "demand": {"cpu": 1.0}, "count": 1,
                                     "min_count": 1}]}], ClusterTopology())
        try:
            client.solve(bad, timeout=60.0)
        except grpc.RpcError as exc:
            if exc.code() != grpc.StatusCode.INVALID_ARGUMENT:
                _fail(f"sidecar: a malformed request gave {exc.code()}, not INVALID_ARGUMENT")
        else:
            _fail("sidecar: a malformed request was answered")
        if not client.healthy(timeout=30.0):
            _fail("sidecar: the health Check does not read SERVING after the requests")
        print("[sidecar] health Check SERVING; a malformed request INVALID_ARGUMENT",
              flush=True)
    finally:
        client.close()
        server.stop(grace=1.0)
    return out


# [slo]'s ticks, cut from run_slo_world's 12 (PERF.md section 4); the
# backlog's wait objective still breaches at round 6 and freezes the bundle.
# JAX_SLO_REFERENCE is `scripts/scheduler_reference.py slo --ticks 6`.
SLO_SMOKE_TICKS = 6


def phase_slo(delta, card, device="cuda", n_nodes=None, n_gangs=None, ticks=SLO_SMOKE_TICKS,
              reference=JAX_SLO_REFERENCE) -> dict:
    """[slo]: the SLO world (models/scenarios.run_slo_world) at full width on
    the card with the observatory on, every part held to
    JAX_SLO_REFERENCE. ``device``, a cut and its ``reference`` (the "slo"
    object of `scripts/scheduler_reference.py slo --nodes N --gangs G
    --ticks T`) rehearse the phase on the CPU."""
    import tempfile
    import types

    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.api.wire import decode_object
    from grove_tpu_torch.models.scenarios import SLO_STEP_S, run_slo_world
    from grove_tpu_torch.observability import (
        EVENTS, FLIGHTREC, JOURNEYS, METRICS, SLO, TIMESERIES, TRACER, SloSpec)
    from grove_tpu_torch.observability.flightrec import load_bundle
    from grove_tpu_torch.observability.forecast import FORECASTER
    from grove_tpu_torch.observability.profile import disabled_check_cost_ns
    from grove_tpu_torch.observability.timeseries import install_serving_collector
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda
    from grove_tpu_torch.runtime.clock import VirtualClock
    from grove_tpu_torch.runtime.store import Store
    from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
    from grove_tpu_torch.solver.scheduler import GangScheduler

    pkg = types.SimpleNamespace(
        Store=Store, VirtualClock=VirtualClock, SimCluster=SimCluster, make_nodes=make_nodes,
        GangScheduler=GangScheduler, ClusterTopology=ClusterTopology,
        decode_object=decode_object, EVENTS=EVENTS, METRICS=METRICS, TRACER=TRACER,
        JOURNEYS=JOURNEYS, TIMESERIES=TIMESERIES, SLO=SLO, SloSpec=SloSpec,
        FORECASTER=FORECASTER, FLIGHTREC=FLIGHTREC,
        install_serving_collector=install_serving_collector, load_bundle=load_bundle)
    ref = reference
    rows = []
    launches = {"fill": 0, "drf_shares": 0, "drf_merge": 0}

    def before(index):
        fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0

    def after(index, wall_s, observe_s, summary):
        counts = {"fill": fill_batch.launches, "drf_shares": share_table_cuda.launches,
                  "drf_merge": merge_cuda.launches}
        for k, v in counts.items():
            launches[k] += v
        tag = f"slo round {index + 1}"
        want = dict(ref["rounds"][index])
        got = dict(summary)
        if not np.isclose(got.pop("score_sum"), want.pop("score_sum"), rtol=1e-6, atol=0):
            _fail(f"{tag}: score sum {summary['score_sum']} != the JAX package's")
        for key, value in want.items():
            if got[key] != value:
                _fail(f"{tag}: {key} {got[key]} != the JAX package's {value}")
        rows.append({"wall_s": wall_s, "observatory_s": observe_s,
                     **{f"{k}_launches": v for k, v in counts.items()},
                     **{k: got[k] for k in ("admitted", "bound", "evicted")}})
        print(f"[slo] round {index + 1} (vt {SLO_STEP_S * (index + 1):.0f} s): wall"
              f" {wall_s:.3f} s, sample + evaluate {observe_s * 1e3:.2f} ms; admitted"
              f" {got['admitted']}, events {got['events_by_reason']}; launches fill"
              f" {counts['fill']}, DRF {counts['drf_shares']} + {counts['drf_merge']};"
              f" round and series windows equal to the JAX package's", flush=True)

    with tempfile.TemporaryDirectory() as out_dir:
        got = run_slo_world(pkg, n_nodes, n_gangs, ticks, out_dir=out_dir,
                            scheduler_kwargs={"device": device}, before_round=before,
                            after_round=after)
    if len(got["rounds"]) != len(ref["rounds"]):
        _fail(f"slo: {len(got['rounds'])} rounds, the JAX run {len(ref['rounds'])}")
    for key in ("windows", "status", "forecast", "dumps", "flight"):
        if got[key] != ref[key]:
            _fail(f"slo: {key} differs from the JAX package's: {got[key]} != {ref[key]}")
    if device != "cpu" and not all(launches.values()):
        _fail(f"slo: the phase did not launch every kernel: {launches}")
    check_ns = disabled_check_cost_ns()
    ticks = [r["wall_s"] for r in rows[1:]]
    delta_ticks = [max(0.0, r["wall_s"] - r["selfcheck_s"]) for r in delta["rounds"][1:]]
    delta_r1 = delta["rounds"][0]["wall_s"] - delta["rounds"][0]["selfcheck_s"]
    out = {"round1_wall_s": rows[0]["wall_s"], "tick_p50_s": _percentile(ticks, 0.5),
           "tick_p99_s": _percentile(ticks, 0.99), "delta_round1_wall_s": delta_r1,
           "delta_tick_p50_s": _percentile(delta_ticks, 0.5),
           "observatory_p50_ms": _percentile([r["observatory_s"] for r in rows], 0.5) * 1e3,
           "disabled_check_ns": check_ns, "series": len(got["windows"]),
           "objectives": {o["name"]: o["state"] for o in got["status"]["objectives"]},
           "flight": {k: got["flight"][k] for k in ("reason", "vt", "records", "commits")},
           **{f"{k}_launches": v for k, v in launches.items()}, "rounds": rows}
    print(f"[slo] (delta)'s world with the observatory on ({len(rows)} rounds, the clock"
          f" {SLO_STEP_S:.0f} s a round): round 1 wall {out['round1_wall_s']:.3f} s beside"
          f" [delta]'s {delta_r1:.3f} s (less its self-check); ticks p50 {out['tick_p50_s']:.4f} s,"
          f" p99 {out['tick_p99_s']:.4f} s beside [delta]'s p50 {out['delta_tick_p50_s']:.4f} s;"
          f" sample + evaluate p50 {out['observatory_p50_ms']:.2f} ms; {out['series']} series,"
          f" SLO status, forecast and flight bundle ({got['flight']['reason']} at vt"
          f" {got['flight']['vt']}, {got['flight']['commits']} commit digests) equal to the JAX"
          f" package's; objectives {out['objectives']}; all-off check (flight recorder in the"
          f" flag) {check_ns:.1f} ns; launches fill {launches['fill']}, DRF"
          f" {launches['drf_shares']} + {launches['drf_merge']} | {card}", flush=True)
    return out


# JAX_DISRUPTION_REFERENCE: the disruption world (omega,
# models/scenarios.run_disruption_world: (q)'s gangs with a PodCliqueSet and a
# disruption budget each, a broker, a node-health monitor, a drain controller
# and a remediator, the storm, crash, drains and fail-slow node of its
# script, the clock 10 s a round), from `JAX_PLATFORMS=cpu python
# scripts/scheduler_reference.py disruption` (JAX 0.9.0 on the CPU): every
# round's record and the nodes the script chose.
JAX_DISRUPTION_REFERENCE = {'rounds': [{'admitted': 10232,
             'bound': 34826,
             'score_sum': 10086.266505539417,
             'bindings': 34826,
             'bindings_sha256': '2dc721d8f178aabc5a3a72dd1879931fc47539ff97e13b5f3fac88eccebe617c',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {'default': 1,
                                    'tenant-0': 1271,
                                    'tenant-1': 1280,
                                    'tenant-2': 1280,
                                    'tenant-3': 1280,
                                    'tenant-4': 1280,
                                    'tenant-5': 1280,
                                    'tenant-6': 1280,
                                    'tenant-7': 1280},
             'events_by_reason': {'GangAdmitted': 10232, 'GangDeferred': 9, 'PodBound': 34826},
             'round': 1,
             'script': ['cordon node-5119; create the world'],
             'trials': 9,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 2.0, 'breaker_open': False, 'last_grant': []},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [],
                         'states': {'Ready': 5120},
                         'nodes_sha256': 'd9d9dca2b24aee1c1d7bf74d8713da608d86286032c5b939a8c0b05b53ed4f0b'},
             'drain': {},
             'drained_gangs': [],
             'ledger': [],
             'events': [['PodGang',
                         'tenant-0',
                         'g6224-0',
                         'Warning',
                         'GangDeferred',
                         'not admitted this round (node-fragmentation: aggregate capacity covers '
                         'the floor, but no feasible packing exists on current per-node free '
                         'capacity)'],
                        ['PodGang',
                         'tenant-0',
                         'g7928-0',
                         'Warning',
                         'GangDeferred',
                         'not admitted this round (node-fragmentation: aggregate capacity covers '
                         'the floor, but no feasible packing exists on current per-node free '
                         'capacity)'],
                        ['PodGang',
                         'tenant-0',
                         'g8712-0',
                         'Warning',
                         'GangDeferred',
                         'not admitted this round (node-fragmentation: aggregate capacity covers '
                         'the floor, but no feasible packing exists on current per-node free '
                         'capacity)'],
                        ['PodGang',
                         'tenant-0',
                         'g8944-0',
                         'Warning',
                         'GangDeferred',
                         'not admitted this round (node-fragmentation: aggregate capacity covers '
                         'the floor, but no feasible packing exists on current per-node free '
                         'capacity)'],
                        ['PodGang',
                         'tenant-0',
                         'g8992-0',
                         'Warning',
                         'GangDeferred',
                         'not admitted this round (node-fragmentation: aggregate capacity covers '
                         'the floor, but no feasible packing exists on current per-node free '
                         'capacity)'],
                        ['PodGang',
                         'tenant-0',
                         'g9016-0',
                         'Warning',
                         'GangDeferred',
                         'not admitted this round (node-fragmentation: aggregate capacity covers '
                         'the floor, but no feasible packing exists on current per-node free '
                         'capacity)'],
                        ['PodGang',
                         'tenant-0',
                         'g904-0',
                         'Warning',
                         'GangDeferred',
                         'not admitted this round (node-fragmentation: aggregate capacity covers '
                         'the floor, but no feasible packing exists on current per-node free '
                         'capacity)'],
                        ['PodGang',
                         'tenant-0',
                         'g9736-0',
                         'Warning',
                         'GangDeferred',
                         'not admitted this round (node-fragmentation: aggregate capacity covers '
                         'the floor, but no feasible packing exists on current per-node free '
                         'capacity)'],
                        ['PodGang',
                         'tenant-0',
                         'g9744-0',
                         'Warning',
                         'GangDeferred',
                         'not admitted this round (node-fragmentation: aggregate capacity covers '
                         'the floor, but no feasible packing exists on current per-node free '
                         'capacity)']],
             'events_sha256': '1214bd2d82efaf09a3821dddc7d104b59bcece04c0383aeafdd192ca840cde27'},
            {'admitted': 2206,
             'bound': 2206,
             'score_sum': 2206.0,
             'bindings': 37032,
             'bindings_sha256': '6dc92308d1e2065110e5869f721610219b4e8aa52c0749556c01b38b3906df38',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {'default': 2206},
             'events_by_reason': {'GangAdmitted': 2206, 'PodBound': 2206},
             'round': 2,
             'script': ['delete 9 pending gangs; create 2206 fillers'],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 2.0, 'breaker_open': False, 'last_grant': []},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [],
                         'states': {'Ready': 5120},
                         'nodes_sha256': 'c0d7a229d6f0da30140279c465b6e1ed77e6921a7d3f95b76afe629994306f2a'},
             'drain': {},
             'drained_gangs': [],
             'ledger': [],
             'events': [],
             'events_sha256': 'df860bb91f690891ec8d190a04ceb2fa7c7b309b19a2dc18f8832d2395d70559'},
            {'admitted': 0,
             'bound': 0,
             'score_sum': 0.0,
             'bindings': 37032,
             'bindings_sha256': '6dc92308d1e2065110e5869f721610219b4e8aa52c0749556c01b38b3906df38',
             'evicted': 2,
             'evicted_sha256': 'd3fb34dfca204d433b10d3bb064d5f929703f271dbaa363e51486aced9b84544',
             'admitted_per_queue': {},
             'events_by_reason': {'BreakerOpen': 1,
                                  'DisruptionThrottled': 1,
                                  'GangDeferred': 4,
                                  'Preempted': 2},
             'round': 3,
             'script': ['create 4 critical gangs in tenant-1'],
             'trials': 14,
             'would_allow': 61459,
             'refused': 39484,
             'broker': {'tokens': 0.0, 'breaker_open': True, 'last_grant': []},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [],
                         'states': {'Ready': 5120},
                         'nodes_sha256': 'c0d7a229d6f0da30140279c465b6e1ed77e6921a7d3f95b76afe629994306f2a'},
             'drain': {},
             'drained_gangs': [],
             'ledger': [],
             'events': [['PodGang',
                         'filler',
                         'fill0-0',
                         'Warning',
                         'Preempted',
                         'preempted by higher-priority gang tenant-1/storm0-0'],
                        ['PodGang',
                         'filler',
                         'fill1-0',
                         'Warning',
                         'Preempted',
                         'preempted by higher-priority gang tenant-1/storm1-0'],
                        ['DisruptionBroker',
                         '',
                         'cluster',
                         'Warning',
                         'BreakerOpen',
                         'disruption-storm circuit breaker opened: voluntary-eviction budget '
                         'exhausted (preemption asked for 1 eviction(s), 0.0 token(s) left); all '
                         'voluntary disruptions denied until 30s of quiet'],
                        ['PodGang',
                         'filler',
                         'fill10-0',
                         'Warning',
                         'DisruptionThrottled',
                         'preemption denied: eviction storm (breaker opened)'],
                        ['PodGang',
                         'tenant-1',
                         'storm0-0',
                         'Warning',
                         'GangDeferred',
                         'not admitted this round (insufficient-capacity: cluster free tpu cannot '
                         'cover the gang floor (1 tpu needed))'],
                        ['PodGang',
                         'tenant-1',
                         'storm1-0',
                         'Warning',
                         'GangDeferred',
                         'not admitted this round (insufficient-capacity: cluster free tpu cannot '
                         'cover the gang floor (1 tpu needed))'],
                        ['PodGang',
                         'tenant-1',
                         'storm2-0',
                         'Warning',
                         'GangDeferred',
                         'not admitted this round (insufficient-capacity: cluster free tpu cannot '
                         'cover the gang floor (1 tpu needed))'],
                        ['PodGang',
                         'tenant-1',
                         'storm3-0',
                         'Warning',
                         'GangDeferred',
                         'not admitted this round (insufficient-capacity: cluster free tpu cannot '
                         'cover the gang floor (1 tpu needed))']],
             'events_sha256': 'fed21ae8258f74b398cb136c77b390ce00c9eb4f26c4b6869188a55b933c99b3'},
            {'admitted': 4,
             'bound': 4,
             'score_sum': 4.0,
             'bindings': 34830,
             'bindings_sha256': 'dbdad84a91f0c0b3f352d07154e2826417952f989daa53ac356539c29ff1654b',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {'tenant-1': 4},
             'events_by_reason': {'GangAdmitted': 4, 'PodBound': 4},
             'round': 4,
             'script': ['delete 2206 fillers'],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 0.0, 'breaker_open': True, 'last_grant': []},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [],
                         'states': {'Ready': 5120},
                         'nodes_sha256': '2519551778e6c6696a47af703c9cce9088776e091c5639aa02cb453d6d968d51'},
             'drain': {},
             'drained_gangs': [],
             'ledger': [],
             'events': [],
             'events_sha256': 'b31b041b1c6324168b64aac9bf129f2bafb5a674f23644eb2de6e27cde55c2d8'},
            {'admitted': 0,
             'bound': 0,
             'score_sum': 0.0,
             'bindings': 34830,
             'bindings_sha256': 'dbdad84a91f0c0b3f352d07154e2826417952f989daa53ac356539c29ff1654b',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {},
             'events_by_reason': {},
             'round': 5,
             'script': [],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 0.0, 'breaker_open': True, 'last_grant': []},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [],
                         'states': {'Ready': 5120},
                         'nodes_sha256': '2519551778e6c6696a47af703c9cce9088776e091c5639aa02cb453d6d968d51'},
             'drain': {},
             'drained_gangs': [],
             'ledger': [],
             'events': [],
             'events_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855'},
            {'admitted': 0,
             'bound': 0,
             'score_sum': 0.0,
             'bindings': 34830,
             'bindings_sha256': 'dbdad84a91f0c0b3f352d07154e2826417952f989daa53ac356539c29ff1654b',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {},
             'events_by_reason': {'BreakerClosed': 1},
             'round': 6,
             'script': [],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 2.0, 'breaker_open': False, 'last_grant': []},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [],
                         'states': {'Ready': 5120},
                         'nodes_sha256': '2519551778e6c6696a47af703c9cce9088776e091c5639aa02cb453d6d968d51'},
             'drain': {},
             'drained_gangs': [],
             'ledger': [],
             'events': [['DisruptionBroker',
                         '',
                         'cluster',
                         'Normal',
                         'BreakerClosed',
                         'quiet window (30s) elapsed; breaker closed']],
             'events_sha256': 'd56649254181fa58f6d5558320ff0df1c86062b2081ea7b591ace212522790cc'},
            {'admitted': 0,
             'bound': 0,
             'score_sum': 0.0,
             'bindings': 34830,
             'bindings_sha256': 'dbdad84a91f0c0b3f352d07154e2826417952f989daa53ac356539c29ff1654b',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {},
             'events_by_reason': {'NodeNotReady': 2},
             'round': 7,
             'script': ['crash node-0 and node-2736'],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 2.0, 'breaker_open': False, 'last_grant': []},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [],
                         'states': {'NotReady': 2, 'Ready': 5118},
                         'nodes_sha256': 'c2bf5bf81c1dfa75e23b2a263f384ca88a3fdf02a05b69984bddd09d078df738'},
             'drain': {},
             'drained_gangs': [],
             'ledger': [],
             'events': [['Node',
                         '',
                         'node-0',
                         'Warning',
                         'NodeNotReady',
                         'no heartbeat for 10.0s (grace 30s)'],
                        ['Node',
                         '',
                         'node-2736',
                         'Warning',
                         'NodeNotReady',
                         'no heartbeat for 10.0s (grace 30s)']],
             'events_sha256': 'e1ea2dee1b8323ca0dbfea6cf883dcb6a91b173c7ab499ed235d23b33e4f9808'},
            {'admitted': 0,
             'bound': 0,
             'score_sum': 0.0,
             'bindings': 34830,
             'bindings_sha256': 'dbdad84a91f0c0b3f352d07154e2826417952f989daa53ac356539c29ff1654b',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {},
             'events_by_reason': {},
             'round': 8,
             'script': [],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 2.0, 'breaker_open': False, 'last_grant': []},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [],
                         'states': {'NotReady': 2, 'Ready': 5118},
                         'nodes_sha256': '0d09a2a0f54aa664761230edfdcf93ec51689167ec93075f7e771a6cf8a9ef22'},
             'drain': {},
             'drained_gangs': [],
             'ledger': [],
             'events': [],
             'events_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855'},
            {'admitted': 1,
             'bound': 1,
             'score_sum': 0.833333432674408,
             'bindings': 34819,
             'bindings_sha256': 'd7a6f0d032f418b80a84c548e61098148a4341cf983431c822f11f833049287e',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {'default': 1},
             'events_by_reason': {'GangAdmitted': 1,
                                  'GangRequeued': 2,
                                  'NodeLost': 4,
                                  'PodBound': 1},
             'round': 9,
             'script': ['uncordon node-5119'],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 2.0, 'breaker_open': False, 'last_grant': []},
             'monitor': {'held': ['tenant-0/g6504-0', 'tenant-3/g10003-0'],
                         'probation': [],
                         'rescue_pending': ['default/serve0-0'],
                         'rescues': [],
                         'states': {'Lost': 2, 'Ready': 5118},
                         'nodes_sha256': '1329ab852d83c09d1176207bd0777bd3851598f192bb87103520154a6b4a4595'},
             'drain': {},
             'drained_gangs': [],
             'ledger': [],
             'events': [['Node',
                         '',
                         'node-0',
                         'Warning',
                         'NodeLost',
                         'heartbeat grace period (30s) exceeded; failing its pods'],
                        ['Node',
                         '',
                         'node-2736',
                         'Warning',
                         'NodeLost',
                         'heartbeat grace period (30s) exceeded; failing its pods'],
                        ['Node',
                         '',
                         'node-0',
                         'Warning',
                         'NodeLost',
                         'failed 1 pod(s) bound to lost node node-0'],
                        ['Node',
                         '',
                         'node-2736',
                         'Warning',
                         'NodeLost',
                         'failed 7 pod(s) bound to lost node node-2736'],
                        ['PodGang',
                         'tenant-0',
                         'g6504-0',
                         'Warning',
                         'GangRequeued',
                         'node node-2736 lost; survivors below MinReplicas (g6504-0-g6504-0=0/3, '
                         'g6504-0-g6504-1=0/1); gang terminated and requeued'],
                        ['PodGang',
                         'tenant-3',
                         'g10003-0',
                         'Warning',
                         'GangRequeued',
                         'node node-2736 lost; survivors below MinReplicas '
                         '(g10003-0-g10003-0=0/3); gang terminated and requeued']],
             'events_sha256': '5f0a47102e2dbbdca04f8b4b9f38efde95d97c9279251ac3fb7cb5d60f2ab3e3'},
            {'admitted': 2,
             'bound': 11,
             'score_sum': 1.7916667461395264,
             'bindings': 34830,
             'bindings_sha256': '3672e6b1acf9f2a4f85508501c1554c674125d7316e55e1b324a4bb472b19110',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {'tenant-0': 1, 'tenant-3': 1},
             'events_by_reason': {'GangAdmitted': 2,
                                  'GangBackoffReleased': 2,
                                  'GangRescued': 1,
                                  'PodBound': 11},
             'round': 10,
             'script': [],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 2.0, 'breaker_open': False, 'last_grant': []},
             'monitor': {'held': [],
                         'probation': ['tenant-0/g6504-0', 'tenant-3/g10003-0'],
                         'rescue_pending': [],
                         'rescues': [{'namespace': 'default',
                                      'gang': 'serve0-0',
                                      'lost_node': 'node-0',
                                      'survivors': {'serve0-0-serve0-0': 1},
                                      'domain_key': None,
                                      'domain': None,
                                      'since': 90.0,
                                      'completed_at': 100.0,
                                      'placement_nodes': ['node-5119', 'node-1']}],
                         'states': {'Lost': 2, 'Ready': 5118},
                         'nodes_sha256': '318c414fcad54c5e9a5ad56ad62c3ab1ab0d87c8908743cbe2fb5137113e1ed5'},
             'drain': {},
             'drained_gangs': [],
             'ledger': [],
             'events': [['PodGang',
                         'tenant-0',
                         'g6504-0',
                         'Normal',
                         'GangBackoffReleased',
                         'backoff expired after 1 attempt(s); re-entering the all-or-nothing '
                         'solve'],
                        ['PodGang',
                         'tenant-3',
                         'g10003-0',
                         'Normal',
                         'GangBackoffReleased',
                         'backoff expired after 1 attempt(s); re-entering the all-or-nothing '
                         'solve'],
                        ['PodGang',
                         'default',
                         'serve0-0',
                         'Normal',
                         'GangRescued',
                         'gang whole again after losing node-0']],
             'events_sha256': 'df47b8066da7840254389644f3a0a9ee976e203e452d4c0a2f04ef60bd0462ed'},
            {'admitted': 0,
             'bound': 0,
             'score_sum': 0.0,
             'bindings': 34830,
             'bindings_sha256': '3672e6b1acf9f2a4f85508501c1554c674125d7316e55e1b324a4bb472b19110',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {},
             'events_by_reason': {},
             'round': 11,
             'script': [],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 2.0, 'breaker_open': False, 'last_grant': []},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [{'namespace': 'default',
                                      'gang': 'serve0-0',
                                      'lost_node': 'node-0',
                                      'survivors': {'serve0-0-serve0-0': 1},
                                      'domain_key': None,
                                      'domain': None,
                                      'since': 90.0,
                                      'completed_at': 100.0,
                                      'placement_nodes': ['node-5119', 'node-1']}],
                         'states': {'Lost': 2, 'Ready': 5118},
                         'nodes_sha256': '29111171a9e3981f0d79781f753eb72e362416ecf7e4d5a66f5fab52d371ed76'},
             'drain': {},
             'drained_gangs': [],
             'ledger': [],
             'events': [],
             'events_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855'},
            {'admitted': 1,
             'bound': 4,
             'score_sum': 1.0,
             'bindings': 34830,
             'bindings_sha256': '945fc2d856355a681bd53678eda598a241f27ad916803be23b0d79725f3cd788',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {'tenant-7': 1},
             'events_by_reason': {'DisruptionThrottled': 1,
                                  'GangAdmitted': 1,
                                  'GangDrained': 1,
                                  'NodeDraining': 2,
                                  'PodBound': 4},
             'round': 12,
             'script': ['drain node-253 and node-2'],
             'trials': 1,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 1.0,
                        'breaker_open': False,
                        'last_grant': [['tenant-7/g8567', 120.0]]},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [{'namespace': 'default',
                                      'gang': 'serve0-0',
                                      'lost_node': 'node-0',
                                      'survivors': {'serve0-0-serve0-0': 1},
                                      'domain_key': None,
                                      'domain': None,
                                      'since': 90.0,
                                      'completed_at': 100.0,
                                      'placement_nodes': ['node-5119', 'node-1']}],
                         'states': {'Lost': 2, 'Ready': 5118},
                         'nodes_sha256': '22231c0a04fa9a2f7795996529779ad33993780a1b3300af3031854e7fc420e0'},
             'drain': {'node-2': 'Draining', 'node-253': 'Draining'},
             'drained_gangs': [{'namespace': 'tenant-7',
                                'gang': 'g8567-0',
                                'node': 'node-253',
                                'pre_placed': True,
                                'planned_nodes': ['node-127', 'node-127', 'node-127', 'node-127'],
                                'at': 120.0}],
             'ledger': [],
             'events': [['Node',
                         '',
                         'node-253',
                         'Normal',
                         'NodeDraining',
                         'drain requested: node cordoned; evicting its gangs whole, '
                         'budget-checked'],
                        ['Node',
                         '',
                         'node-2',
                         'Normal',
                         'NodeDraining',
                         'drain requested: node cordoned; evicting its gangs whole, '
                         'budget-checked'],
                        ['PodGang',
                         'tenant-0',
                         'g1080-0',
                         'Warning',
                         'DisruptionThrottled',
                         'drain denied: disruptionBudget of tenant-0/g1080 '
                         '(maxUnavailableGangs=0) would be exceeded'],
                        ['PodGang',
                         'tenant-7',
                         'g8567-0',
                         'Warning',
                         'GangDrained',
                         'node node-253 draining; gang evicted whole (placement on remaining '
                         'nodes verified before eviction)']],
             'events_sha256': '66939200a1663d6dac501db6602dba56f4215ebd2242a30f63421b0e81280914'},
            {'admitted': 0,
             'bound': 0,
             'score_sum': 0.0,
             'bindings': 34830,
             'bindings_sha256': '945fc2d856355a681bd53678eda598a241f27ad916803be23b0d79725f3cd788',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {},
             'events_by_reason': {'DisruptionThrottled': 1, 'NodeDrained': 1},
             'round': 13,
             'script': [],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 1.0,
                        'breaker_open': False,
                        'last_grant': [['tenant-7/g8567', 120.0]]},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [{'namespace': 'default',
                                      'gang': 'serve0-0',
                                      'lost_node': 'node-0',
                                      'survivors': {'serve0-0-serve0-0': 1},
                                      'domain_key': None,
                                      'domain': None,
                                      'since': 90.0,
                                      'completed_at': 100.0,
                                      'placement_nodes': ['node-5119', 'node-1']}],
                         'states': {'Lost': 2, 'Ready': 5118},
                         'nodes_sha256': 'b669fd5f30798109f65694a9de8f3844f0cf4e7030ed3343fe55b36ac26a2f80'},
             'drain': {'node-2': 'Draining', 'node-253': 'Drained'},
             'drained_gangs': [{'namespace': 'tenant-7',
                                'gang': 'g8567-0',
                                'node': 'node-253',
                                'pre_placed': True,
                                'planned_nodes': ['node-127', 'node-127', 'node-127', 'node-127'],
                                'at': 120.0}],
             'ledger': [],
             'events': [['PodGang',
                         'tenant-0',
                         'g1080-0',
                         'Warning',
                         'DisruptionThrottled',
                         'drain denied: disruptionBudget of tenant-0/g1080 '
                         '(maxUnavailableGangs=0) would be exceeded'],
                        ['Node',
                         '',
                         'node-253',
                         'Normal',
                         'NodeDrained',
                         'no bound pods remain; node drained (still cordoned until uncordon)']],
             'events_sha256': '1d2e89a53ffecf5d839a8ae1ca7a297286c9470cda087148744013bf9dae6884'},
            {'admitted': 0,
             'bound': 0,
             'score_sum': 0.0,
             'bindings': 34830,
             'bindings_sha256': '945fc2d856355a681bd53678eda598a241f27ad916803be23b0d79725f3cd788',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {},
             'events_by_reason': {'NodeUncordoned': 1},
             'round': 14,
             'script': ['uncordon node-2; enable the remediator; fail-slow node-318'],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 1.0,
                        'breaker_open': False,
                        'last_grant': [['tenant-7/g8567', 120.0]]},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [{'namespace': 'default',
                                      'gang': 'serve0-0',
                                      'lost_node': 'node-0',
                                      'survivors': {'serve0-0-serve0-0': 1},
                                      'domain_key': None,
                                      'domain': None,
                                      'since': 90.0,
                                      'completed_at': 100.0,
                                      'placement_nodes': ['node-5119', 'node-1']}],
                         'states': {'Lost': 2, 'Ready': 5118},
                         'nodes_sha256': '490916fe6c37c234567dded750b2effb0d9edcdcc5b463560095a9548c020ff4'},
             'drain': {'node-253': 'Drained'},
             'drained_gangs': [{'namespace': 'tenant-7',
                                'gang': 'g8567-0',
                                'node': 'node-253',
                                'pre_placed': True,
                                'planned_nodes': ['node-127', 'node-127', 'node-127', 'node-127'],
                                'at': 120.0}],
             'ledger': [],
             'events': [['Node',
                         '',
                         'node-2',
                         'Normal',
                         'NodeUncordoned',
                         'node uncordoned; schedulable again']],
             'events_sha256': 'eb50e03a8d2b377e702456b3d68302b1149edc055567fb20274d6b755570defa'},
            {'admitted': 0,
             'bound': 0,
             'score_sum': 0.0,
             'bindings': 34830,
             'bindings_sha256': '945fc2d856355a681bd53678eda598a241f27ad916803be23b0d79725f3cd788',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {},
             'events_by_reason': {},
             'round': 15,
             'script': [],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 1.0,
                        'breaker_open': False,
                        'last_grant': [['tenant-7/g8567', 120.0]]},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [{'namespace': 'default',
                                      'gang': 'serve0-0',
                                      'lost_node': 'node-0',
                                      'survivors': {'serve0-0-serve0-0': 1},
                                      'domain_key': None,
                                      'domain': None,
                                      'since': 90.0,
                                      'completed_at': 100.0,
                                      'placement_nodes': ['node-5119', 'node-1']}],
                         'states': {'Lost': 2, 'Ready': 5118},
                         'nodes_sha256': 'fd8b509f56ba4eaf19e38d49c522065c3032f694928c29b2b7379b29e03d4cf9'},
             'drain': {'node-253': 'Drained'},
             'drained_gangs': [{'namespace': 'tenant-7',
                                'gang': 'g8567-0',
                                'node': 'node-253',
                                'pre_placed': True,
                                'planned_nodes': ['node-127', 'node-127', 'node-127', 'node-127'],
                                'at': 120.0}],
             'ledger': [],
             'events': [],
             'events_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855'},
            {'admitted': 0,
             'bound': 0,
             'score_sum': 0.0,
             'bindings': 34830,
             'bindings_sha256': '945fc2d856355a681bd53678eda598a241f27ad916803be23b0d79725f3cd788',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {},
             'events_by_reason': {'NodeDegraded': 1, 'NodeDraining': 1, 'RemediationExecuted': 1},
             'round': 16,
             'script': [],
             'trials': 0,
             'would_allow': 1,
             'refused': 0,
             'broker': {'tokens': 1.0,
                        'breaker_open': False,
                        'last_grant': [['tenant-7/g8567', 120.0]]},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [{'namespace': 'default',
                                      'gang': 'serve0-0',
                                      'lost_node': 'node-0',
                                      'survivors': {'serve0-0-serve0-0': 1},
                                      'domain_key': None,
                                      'domain': None,
                                      'since': 90.0,
                                      'completed_at': 100.0,
                                      'placement_nodes': ['node-5119', 'node-1']}],
                         'states': {'Degraded': 1, 'Lost': 2, 'Ready': 5117},
                         'nodes_sha256': '26879529c2ffde9a286106567a7bcae7690368ea36ae0219453ffc6f7cd5424d'},
             'drain': {'node-253': 'Drained', 'node-318': 'Draining'},
             'drained_gangs': [{'namespace': 'tenant-7',
                                'gang': 'g8567-0',
                                'node': 'node-253',
                                'pre_placed': True,
                                'planned_nodes': ['node-127', 'node-127', 'node-127', 'node-127'],
                                'at': 120.0}],
             'ledger': [{'id': 1,
                         'vt': 160.0,
                         'trigger': {'kind': 'fail-slow',
                                     'detail': 'node node-318 Degraded (fail-slow suspicion over '
                                               'threshold)'},
                         'diagnosis': {'node': 'node-318', 'victims': ['tenant-1/g7777-0']},
                         'simulation': {'flipped': True,
                                        'victims': [{'gang': 'tenant-1/g7777-0',
                                                     'fits_after': True,
                                                     'after': None}]},
                         'action': {'kind': 'drain-node',
                                    'target': 'node-318',
                                    'mechanism': 'drain',
                                    'victims': ['tenant-1/g7777-0']},
                         'outcome': 'executed',
                         'reason': '',
                         'effect': None}],
             'events': [['Node',
                         '',
                         'node-318',
                         'Warning',
                         'NodeDegraded',
                         'fail-slow suspicion 1.76s exceeds 1.5s (EWMA of heartbeat lateness); '
                         'masking from new placements, running pods stay bound'],
                        ['Node',
                         '',
                         'node-318',
                         'Normal',
                         'NodeDraining',
                         'drain requested: node cordoned; evicting its gangs whole, '
                         'budget-checked'],
                        ['Remediation',
                         '',
                         'node-318',
                         'Normal',
                         'RemediationExecuted',
                         'fail-slow -> drain-node on node-318']],
             'events_sha256': '98ff5e1065d052e362639a4eb5727c74725bcac38aec60f4f81aeec2be9aeb43'},
            {'admitted': 1,
             'bound': 4,
             'score_sum': 1.0,
             'bindings': 34830,
             'bindings_sha256': '2e304607b580d664e398187aeb7dd6acb27e9414d6b6557dc4d8d89fff4361a8',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {'tenant-1': 1},
             'events_by_reason': {'GangAdmitted': 1, 'GangDrained': 1, 'PodBound': 4},
             'round': 17,
             'script': [],
             'trials': 1,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 0.0,
                        'breaker_open': False,
                        'last_grant': [['tenant-1/g7777', 170.0], ['tenant-7/g8567', 120.0]]},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [{'namespace': 'default',
                                      'gang': 'serve0-0',
                                      'lost_node': 'node-0',
                                      'survivors': {'serve0-0-serve0-0': 1},
                                      'domain_key': None,
                                      'domain': None,
                                      'since': 90.0,
                                      'completed_at': 100.0,
                                      'placement_nodes': ['node-5119', 'node-1']}],
                         'states': {'Degraded': 1, 'Lost': 2, 'Ready': 5117},
                         'nodes_sha256': '8ee7c8cbce999d58e6c40e87b66a9134284396b20bd5aac7ede54c6745b797a8'},
             'drain': {'node-253': 'Drained', 'node-318': 'Draining'},
             'drained_gangs': [{'namespace': 'tenant-7',
                                'gang': 'g8567-0',
                                'node': 'node-253',
                                'pre_placed': True,
                                'planned_nodes': ['node-127', 'node-127', 'node-127', 'node-127'],
                                'at': 120.0},
                               {'namespace': 'tenant-1',
                                'gang': 'g7777-0',
                                'node': 'node-318',
                                'pre_placed': True,
                                'planned_nodes': ['node-69', 'node-69', 'node-69', 'node-69'],
                                'at': 170.0}],
             'ledger': [{'id': 1,
                         'vt': 160.0,
                         'trigger': {'kind': 'fail-slow',
                                     'detail': 'node node-318 Degraded (fail-slow suspicion over '
                                               'threshold)'},
                         'diagnosis': {'node': 'node-318', 'victims': ['tenant-1/g7777-0']},
                         'simulation': {'flipped': True,
                                        'victims': [{'gang': 'tenant-1/g7777-0',
                                                     'fits_after': True,
                                                     'after': None}]},
                         'action': {'kind': 'drain-node',
                                    'target': 'node-318',
                                    'mechanism': 'drain',
                                    'victims': ['tenant-1/g7777-0']},
                         'outcome': 'executed',
                         'reason': '',
                         'effect': None}],
             'events': [['PodGang',
                         'tenant-1',
                         'g7777-0',
                         'Warning',
                         'GangDrained',
                         'node node-318 draining; gang evicted whole (placement on remaining '
                         'nodes verified before eviction)']],
             'events_sha256': '2fc5503bbd94a4ee452358c7cb02c78c9d6b20ffcf9d3651516527ac1f4e5521'},
            {'admitted': 0,
             'bound': 0,
             'score_sum': 0.0,
             'bindings': 34830,
             'bindings_sha256': '2e304607b580d664e398187aeb7dd6acb27e9414d6b6557dc4d8d89fff4361a8',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {},
             'events_by_reason': {'NodeDrained': 1},
             'round': 18,
             'script': [],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 0.0,
                        'breaker_open': False,
                        'last_grant': [['tenant-1/g7777', 170.0], ['tenant-7/g8567', 120.0]]},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [{'namespace': 'default',
                                      'gang': 'serve0-0',
                                      'lost_node': 'node-0',
                                      'survivors': {'serve0-0-serve0-0': 1},
                                      'domain_key': None,
                                      'domain': None,
                                      'since': 90.0,
                                      'completed_at': 100.0,
                                      'placement_nodes': ['node-5119', 'node-1']}],
                         'states': {'Degraded': 1, 'Lost': 2, 'Ready': 5117},
                         'nodes_sha256': '941f0d493adf35f788150ffcec6fbb9bb6f7db36cdbf7ca59a2151292cb3361d'},
             'drain': {'node-253': 'Drained', 'node-318': 'Drained'},
             'drained_gangs': [{'namespace': 'tenant-7',
                                'gang': 'g8567-0',
                                'node': 'node-253',
                                'pre_placed': True,
                                'planned_nodes': ['node-127', 'node-127', 'node-127', 'node-127'],
                                'at': 120.0},
                               {'namespace': 'tenant-1',
                                'gang': 'g7777-0',
                                'node': 'node-318',
                                'pre_placed': True,
                                'planned_nodes': ['node-69', 'node-69', 'node-69', 'node-69'],
                                'at': 170.0}],
             'ledger': [{'id': 1,
                         'vt': 160.0,
                         'trigger': {'kind': 'fail-slow',
                                     'detail': 'node node-318 Degraded (fail-slow suspicion over '
                                               'threshold)'},
                         'diagnosis': {'node': 'node-318', 'victims': ['tenant-1/g7777-0']},
                         'simulation': {'flipped': True,
                                        'victims': [{'gang': 'tenant-1/g7777-0',
                                                     'fits_after': True,
                                                     'after': None}]},
                         'action': {'kind': 'drain-node',
                                    'target': 'node-318',
                                    'mechanism': 'drain',
                                    'victims': ['tenant-1/g7777-0']},
                         'outcome': 'executed',
                         'reason': '',
                         'effect': None}],
             'events': [['Node',
                         '',
                         'node-318',
                         'Normal',
                         'NodeDrained',
                         'no bound pods remain; node drained (still cordoned until uncordon)']],
             'events_sha256': 'f05e6f718811e8f488f97295eb524ae5f05164656846d103555b0f31d6052cb7'},
            {'admitted': 0,
             'bound': 0,
             'score_sum': 0.0,
             'bindings': 34830,
             'bindings_sha256': '2e304607b580d664e398187aeb7dd6acb27e9414d6b6557dc4d8d89fff4361a8',
             'evicted': 0,
             'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
             'admitted_per_queue': {},
             'events_by_reason': {},
             'round': 19,
             'script': ['done'],
             'trials': 0,
             'would_allow': 0,
             'refused': 0,
             'broker': {'tokens': 0.0,
                        'breaker_open': False,
                        'last_grant': [['tenant-1/g7777', 170.0], ['tenant-7/g8567', 120.0]]},
             'monitor': {'held': [],
                         'probation': [],
                         'rescue_pending': [],
                         'rescues': [{'namespace': 'default',
                                      'gang': 'serve0-0',
                                      'lost_node': 'node-0',
                                      'survivors': {'serve0-0-serve0-0': 1},
                                      'domain_key': None,
                                      'domain': None,
                                      'since': 90.0,
                                      'completed_at': 100.0,
                                      'placement_nodes': ['node-5119', 'node-1']}],
                         'states': {'Degraded': 1, 'Lost': 2, 'Ready': 5117},
                         'nodes_sha256': 'e2d30a86e8488b31f5c18d11379f5684b9b6396056664a4fefe2743157b0ee6b'},
             'drain': {'node-253': 'Drained', 'node-318': 'Drained'},
             'drained_gangs': [{'namespace': 'tenant-7',
                                'gang': 'g8567-0',
                                'node': 'node-253',
                                'pre_placed': True,
                                'planned_nodes': ['node-127', 'node-127', 'node-127', 'node-127'],
                                'at': 120.0},
                               {'namespace': 'tenant-1',
                                'gang': 'g7777-0',
                                'node': 'node-318',
                                'pre_placed': True,
                                'planned_nodes': ['node-69', 'node-69', 'node-69', 'node-69'],
                                'at': 170.0}],
             'ledger': [{'id': 1,
                         'vt': 160.0,
                         'trigger': {'kind': 'fail-slow',
                                     'detail': 'node node-318 Degraded (fail-slow suspicion over '
                                               'threshold)'},
                         'diagnosis': {'node': 'node-318', 'victims': ['tenant-1/g7777-0']},
                         'simulation': {'flipped': True,
                                        'victims': [{'gang': 'tenant-1/g7777-0',
                                                     'fits_after': True,
                                                     'after': None}]},
                         'action': {'kind': 'drain-node',
                                    'target': 'node-318',
                                    'mechanism': 'drain',
                                    'victims': ['tenant-1/g7777-0']},
                         'outcome': 'executed',
                         'reason': '',
                         'effect': None}],
             'events': [],
             'events_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855'}],
 'names': {'reserved': 'node-5119',
           'deleted_pending': ['tenant-0/g6224-0',
                               'tenant-0/g7928-0',
                               'tenant-0/g8712-0',
                               'tenant-0/g8944-0',
                               'tenant-0/g8992-0',
                               'tenant-0/g9016-0',
                               'tenant-0/g904-0',
                               'tenant-0/g9736-0',
                               'tenant-0/g9744-0'],
           'fillers': 2206,
           'rescue': 'node-0',
           'requeue': 'node-2736',
           'requeued': ['tenant-0/g6504-0', 'tenant-3/g10003-0'],
           'drain': 'node-253',
           'held': 'node-2',
           'failslow': 'node-318'}}


def _trial_probe():
    """Class-level wrappers that attribute the scheduler's trial solves, the
    drain's trial pre-placement and the remediator's what-ifs: calls, trial
    solves, wall and fill launches per kind. Returns (stats, undo)."""
    from grove_tpu_torch.disruption.drain import NodeDrainController
    from grove_tpu_torch.observability.explain import ExplainEngine
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.solver.scheduler import GangScheduler

    kinds = (("preemption", GangScheduler, "_maybe_preempt"),
             ("reclaim", GangScheduler, "_maybe_reclaim"),
             ("drain", NodeDrainController, "_trial_preplacement"),
             ("whatif", ExplainEngine, "whatif"))
    stats = {k: {"calls": 0, "trials": 0, "wall_s": 0.0, "fill_launches": 0} for k, _, _ in kinds}
    current = []
    saved = []

    def wrap(kind, fn):
        def wrapper(*args, **kwargs):
            current.append(kind)
            launches, t0 = fill_batch.launches, time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                current.pop()
                row = stats[kind]
                row["calls"] += 1
                row["wall_s"] += time.perf_counter() - t0
                row["fill_launches"] += fill_batch.launches - launches
        return wrapper

    for kind, cls, name in kinds:
        saved.append((cls, name, cls.__dict__[name]))
        setattr(cls, name, wrap(kind, cls.__dict__[name]))
    solve = GangScheduler.__dict__["_solve_batch"]

    def counted(self, *args, **kwargs):
        if current and "problem" not in kwargs:
            stats[current[-1]]["trials"] += 1
        return solve(self, *args, **kwargs)

    saved.append((GangScheduler, "_solve_batch", solve))
    GangScheduler._solve_batch = counted

    def undo():
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    return stats, undo


def phase_disruption(card, device="cuda", n_nodes=None, n_gangs=None,
                     reference=None) -> dict:
    """[disruption]: the disruption world (models/scenarios.run_disruption_world)
    at full width on the card, every round and the script's choices held to
    JAX_DISRUPTION_REFERENCE, the world checked valid at the end. ``device``,
    a cut and its ``reference`` (the "disruption" object of
    `scripts/scheduler_reference.py disruption --nodes N --gangs G`) rehearse
    the phase on the CPU."""
    import types

    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.api.wire import decode_object
    from grove_tpu_torch.autoscale.hpa import HorizontalAutoscaler, StaticMetricsProvider
    from grove_tpu_torch.controller.nodehealth import NodeHealthMonitor
    from grove_tpu_torch.controller.remediate import RemediationController
    from grove_tpu_torch.disruption import DisruptionBroker, NodeDrainController
    from grove_tpu_torch.models.scenarios import (
        DISRUPTION_STEP_S, disruption_missing, run_disruption_world)
    from grove_tpu_torch.observability.events import EVENTS
    from grove_tpu_torch.observability.explain import ExplainEngine
    from grove_tpu_torch.observability.ledger import LEDGER
    from grove_tpu_torch.observability.metrics import METRICS
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda
    from grove_tpu_torch.runtime.clock import VirtualClock
    from grove_tpu_torch.runtime.store import Store
    from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
    from grove_tpu_torch.solver.scheduler import GangScheduler

    ref = JAX_DISRUPTION_REFERENCE if reference is None else reference
    pkg = types.SimpleNamespace(
        Store=Store, VirtualClock=VirtualClock, SimCluster=SimCluster, make_nodes=make_nodes,
        GangScheduler=GangScheduler, ClusterTopology=ClusterTopology,
        decode_object=decode_object, EVENTS=EVENTS, METRICS=METRICS, LEDGER=LEDGER,
        DisruptionBroker=DisruptionBroker, NodeDrainController=NodeDrainController,
        NodeHealthMonitor=NodeHealthMonitor, RemediationController=RemediationController,
        HorizontalAutoscaler=HorizontalAutoscaler, StaticMetricsProvider=StaticMetricsProvider,
        ExplainEngine=ExplainEngine)
    rows = []
    launches = {"fill": 0, "drf_shares": 0, "drf_merge": 0}

    def before(index):
        fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0

    def after(index, walls, record):
        counts = {"fill": fill_batch.launches, "drf_shares": share_table_cuda.launches,
                  "drf_merge": merge_cuda.launches}
        for k, v in counts.items():
            launches[k] += v
        tag = f"disruption round {index + 1}"
        if index >= len(ref["rounds"]):
            _fail(f"{tag}: the JAX run ended after {len(ref['rounds'])} rounds")
        want = dict(ref["rounds"][index])
        got = dict(record)
        if not np.isclose(got.pop("score_sum"), want.pop("score_sum"), rtol=1e-6, atol=0):
            _fail(f"{tag}: score sum {record['score_sum']} != the JAX package's")
        for key, value in want.items():
            if got[key] != value:
                _fail(f"{tag}: {key} {got[key]} != the JAX package's {value}")
        rows.append({**walls, **{f"{k}_launches": v for k, v in counts.items()},
                     **{k: got[k] for k in ("admitted", "bound", "evicted", "trials")}})
        print(f"[disruption] round {index + 1} (vt {DISRUPTION_STEP_S * (index + 1):.0f} s)"
              f" {record['script']}: wall {walls['round_s']:.3f} s (schedule"
              f" {walls['schedule_s']:.3f}, monitor {walls['monitor_s']:.3f}, drain"
              f" {walls['drain_s']:.3f}, remediator {walls['remediate_s']:.3f}); trials"
              f" {got['trials']}, would_allow {got['would_allow']} ({got['refused']} refused);"
              f" events {got['events_by_reason']}; launches fill {counts['fill']}, DRF"
              f" {counts['drf_shares']} + {counts['drf_merge']}; equal to the JAX package's",
              flush=True)

    def valid(store, cluster):
        check_world_valid("disruption (final)", store, cluster)

    stats, undo = _trial_probe()
    try:
        got = run_disruption_world(pkg, n_nodes, n_gangs, before_round=before, after_round=after,
                                   scheduler_kwargs={"device": device}, inspect=valid)
    finally:
        undo()
    if len(got["rounds"]) != len(ref["rounds"]):
        _fail(f"disruption: {len(got['rounds'])} rounds, the JAX run {len(ref['rounds'])}")
    if got["names"] != ref["names"]:
        _fail(f"disruption: the script chose {got['names']}, the JAX run {ref['names']}")
    missing = disruption_missing(got)
    if missing:
        _fail(f"disruption: the run did not show {missing}")
    if device != "cpu":
        if not all(launches.values()):
            _fail(f"disruption: the phase did not launch every kernel: {launches}")
        for kind in ("preemption", "drain", "whatif"):
            if not stats[kind]["fill_launches"]:
                _fail(f"disruption: the {kind} trials did not launch the fill kernel: {stats}")
    reasons = {}
    for rec in got["rounds"]:
        for k, v in rec["events_by_reason"].items():
            reasons[k] = reasons.get(k, 0) + v
    tally = {k: reasons.get(k, 0) for k in (
        "Preempted", "DisruptionThrottled", "BreakerOpen", "BreakerClosed", "GangRescued",
        "GangRequeued", "GangBackoffReleased", "GangDrained", "NodeDegraded",
        "RemediationExecuted")}
    held_rounds = sum(1 for rec in got["rounds"] if rec["monitor"]["held"])
    refused = sum(rec["refused"] for rec in got["rounds"])
    walls = [r["round_s"] for r in rows]
    out = {"rounds": rows, "names": got["names"], "events": tally, "held_rounds": held_rounds,
           "would_allow_refused": refused, "trials": stats,
           "round1_wall_s": walls[0], "phase_rounds_s": sum(walls),
           "tick_p50_s": _percentile(walls[3:], 0.5), "tick_p99_s": _percentile(walls[3:], 0.99),
           **{f"{k}_launches": v for k, v in launches.items()}}
    size = sum(got["rounds"][0]["monitor"]["states"].values())
    print(f"[disruption] (omega) on {size} nodes, {len(rows)} rounds, every one equal to the JAX"
          f" package's, the world valid: round 1 {walls[0]:.3f} s, fill round {walls[1]:.3f} s,"
          f" storm round {walls[2]:.3f} s, later rounds p50 {out['tick_p50_s']:.3f} s, p99"
          f" {out['tick_p99_s']:.3f} s; " + "; ".join(
              f"{k} {v['calls']} calls, {v['trials']} trial solves, {v['wall_s']:.3f} s, fill"
              f" {v['fill_launches']}" for k, v in stats.items())
          + f"; grants (Preempted) {tally['Preempted']}, denials {tally['DisruptionThrottled']}"
          f" + {refused} refused by would_allow, breaker open/close {tally['BreakerOpen']}/"
          f"{tally['BreakerClosed']}, rescues {tally['GangRescued']}, requeues"
          f" {tally['GangRequeued']} (held rounds {held_rounds}, released"
          f" {tally['GangBackoffReleased']}), drained gangs {tally['GangDrained']}, fail-slow"
          f" {tally['NodeDegraded']} -> remediation {tally['RemediationExecuted']}; script"
          f" {got['names']['rescue']}/{got['names']['requeue']} crashed, {got['names']['drain']}"
          f" and {got['names']['held']} drained, {got['names']['failslow']} fail-slow;"
          f" launches fill {launches['fill']}, DRF {launches['drf_shares']} +"
          f" {launches['drf_merge']} | {card}", flush=True)
    return out


# (iota), the operator world (models/scenarios.run_operator_world: BASELINE's
# integrated population, 10,240 PodCliqueSets on 5,120 nodes, then the
# rolling update of the 640 simple1 sets), and the ten samples each
# converged in a fresh harness (run_samples_world), through the JAX
# package's SimHarness: from `JAX_PLATFORMS=cpu python
# scripts/scheduler_reference.py operator` (JAX 0.9.0 on the CPU, under
# PYTHONHASHSEED=0), its "operator" object without the host walls.
JAX_OPERATOR_REFERENCE = {'world': {'n_sets': 10240, 'n_nodes': 5120, 'update_every': 16},
 'apply': {'resource_version': 10241,
           'census': {'ClusterTopology': [1, 1], 'PodCliqueSet': [10240, 10241]}},
 'converges': [{'ticks': [{'work': 194720,
                           'bound': 46400,
                           'started': 45120,
                           'round': {'admitted': 10240,
                                     'bound': 46400,
                                     'score_sum': 10151.270415246487,
                                     'bindings': 46400,
                                     'bindings_sha256': '2c63f0c74ab7f4bbc7bab08c2e1fd7747ec6084f9b63aa755ececfdc73421f80',
                                     'evicted': 0,
                                     'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                                     'admitted_per_queue': {'default': 10240},
                                     'events_by_reason': {'GangAdmitted': 10240,
                                                          'PodBound': 46400}}},
                          {'work': 32000,
                           'bound': 0,
                           'started': 640,
                           'round': {'admitted': 0,
                                     'bound': 0,
                                     'score_sum': 0.0,
                                     'bindings': 46400,
                                     'bindings_sha256': '2c63f0c74ab7f4bbc7bab08c2e1fd7747ec6084f9b63aa755ececfdc73421f80',
                                     'evicted': 0,
                                     'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                                     'admitted_per_queue': {},
                                     'events_by_reason': {}}},
                          {'work': 25280,
                           'bound': 800,
                           'started': 1440,
                           'round': {'admitted': 160,
                                     'bound': 800,
                                     'score_sum': 128.0000114440918,
                                     'bindings': 47200,
                                     'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205',
                                     'evicted': 0,
                                     'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                                     'admitted_per_queue': {'default': 160},
                                     'events_by_reason': {'GangAdmitted': 160, 'PodBound': 800}}},
                          {'work': 2080,
                           'bound': 0,
                           'started': 0,
                           'round': {'admitted': 0,
                                     'bound': 0,
                                     'score_sum': 0.0,
                                     'bindings': 47200,
                                     'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205',
                                     'evicted': 0,
                                     'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                                     'admitted_per_queue': {},
                                     'events_by_reason': {}}},
                          {'work': 0,
                           'bound': 0,
                           'started': 0,
                           'round': {'admitted': 0,
                                     'bound': 0,
                                     'score_sum': 0.0,
                                     'bindings': 47200,
                                     'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205',
                                     'evicted': 0,
                                     'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                                     'admitted_per_queue': {},
                                     'events_by_reason': {}}}],
                'events': {'GangAdmitted/PodGang': 10400,
                           'PCSGCreateSuccessful/PodCliqueScalingGroup': 960,
                           'PodBound/Pod': 47200,
                           'PodCliqueCreateSuccessful/PodClique': 20800,
                           'PodCreateSuccessful/Pod': 47200,
                           'PodGangCreateSuccessful/PodGang': 10400},
                'summary': {'all_ready': True,
                            'resource_version': 599521,
                            'census': {'ClusterTopology': [1, 1],
                                       'Event': [1000, 343841],
                                       'HorizontalPodAutoscaler': [1280, 146994],
                                       'Pod': [47200, 597601],
                                       'PodClique': [23040, 598401],
                                       'PodCliqueScalingGroup': [960, 598561],
                                       'PodCliqueSet': [10240, 599521],
                                       'PodGang': [10400, 599041],
                                       'Role': [10240, 147192],
                                       'RoleBinding': [10240, 147193],
                                       'Secret': [10240, 147194],
                                       'Service': [10240, 147195],
                                       'ServiceAccount': [10240, 147191]},
                            'reconcile_total': {'podclique': 162240.0,
                                                'podcliquescalinggroup': 6080.0,
                                                'podcliqueset': 85760.0},
                            'digest': {'ClusterTopology': '02b841404e7e330cdc38d9f771e094f47d83e7e69b9d047b64d95199fc940420',
                                       'HorizontalPodAutoscaler': 'bbf1ec8295b54e1551e74e9c4341679fe434ce9009c619bd49518ba73c25474e',
                                       'Pod': '2c1ed4f6766ce4d5e2d3628500d11ebbf71db1219dbe89c05cc4de8b48bf9a0e',
                                       'PodClique': 'c4f7a4c09af86aa1c01493bb0bad3bcec4eef1bd4c20a026723d57b6e63f3068',
                                       'PodCliqueScalingGroup': 'affcb3ef93949cb31c598a40aeb2b8c30ae03f28eb8ec909905aa3f1b254dbc9',
                                       'PodCliqueSet': '8f003ecd58c2e00ff6a50cc5d7b8ebd5daa1ce61f426d8ba7c610907fa51138b',
                                       'PodGang': '3285e86ae3b7fdc0efcf42cde07a32e62f98d6f2ee8e751fe6b333dcad48cf8b',
                                       'Role': '78767fc81e01aec7e64ac861ee666083e1470794d231dfda1489f2d086a14a34',
                                       'RoleBinding': '3687792b1112af8cfae18fa10dbc0f912cf71716501728042b09a574478cbcd1',
                                       'Secret': '00ef6f58ff2e21a1afef38b3bfe81a4e68ff1a866839b3713a795af388e33ba0',
                                       'Service': '5ebacd1ade6d546ddfa421786a6ffb064fef8a479a1c364ad5edb472d99165e4',
                                       'ServiceAccount': '43959ebc96a88dd4818dc819f10963d6c06e2020cb36c0d2ce8d4f93748a9912'},
                            'scored_gangs': 10400,
                            'score_sum': 10279.270426690578,
                            'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205'}},
               {'ticks': [{'work': 34560,
                           'bound': 2560,
                           'started': 2560,
                           'round': {'admitted': 0,
                                     'bound': 2560,
                                     'score_sum': 0.0,
                                     'bindings': 47200,
                                     'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205',
                                     'evicted': 0,
                                     'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                                     'admitted_per_queue': {},
                                     'events_by_reason': {'PodBound': 2560}}},
                          {'work': 10880,
                           'bound': 2560,
                           'started': 2560,
                           'round': {'admitted': 0,
                                     'bound': 2560,
                                     'score_sum': 0.0,
                                     'bindings': 47200,
                                     'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205',
                                     'evicted': 0,
                                     'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                                     'admitted_per_queue': {},
                                     'events_by_reason': {'PodBound': 2560}}},
                          {'work': 10240,
                           'bound': 640,
                           'started': 640,
                           'round': {'admitted': 0,
                                     'bound': 640,
                                     'score_sum': 0.0,
                                     'bindings': 47200,
                                     'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205',
                                     'evicted': 0,
                                     'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                                     'admitted_per_queue': {},
                                     'events_by_reason': {'PodBound': 640}}},
                          {'work': 640,
                           'bound': 0,
                           'started': 0,
                           'round': {'admitted': 0,
                                     'bound': 0,
                                     'score_sum': 0.0,
                                     'bindings': 47200,
                                     'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205',
                                     'evicted': 0,
                                     'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                                     'admitted_per_queue': {},
                                     'events_by_reason': {}}},
                          {'work': 640,
                           'bound': 0,
                           'started': 0,
                           'round': {'admitted': 0,
                                     'bound': 0,
                                     'score_sum': 0.0,
                                     'bindings': 47200,
                                     'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205',
                                     'evicted': 0,
                                     'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                                     'admitted_per_queue': {},
                                     'events_by_reason': {}}},
                          {'work': 0,
                           'bound': 0,
                           'started': 0,
                           'round': {'admitted': 0,
                                     'bound': 0,
                                     'score_sum': 0.0,
                                     'bindings': 47200,
                                     'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205',
                                     'evicted': 0,
                                     'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                                     'admitted_per_queue': {},
                                     'events_by_reason': {}}}],
                'events': {'PodBound/Pod': 5760,
                           'PodCreateSuccessful/Pod': 5760,
                           'PodUpdateDeleteSuccessful/Pod': 5760,
                           'RollingUpdateCompleted/PodCliqueScalingGroup': 640,
                           'RollingUpdateCompleted/PodCliqueSet': 640,
                           'RollingUpdateReplicaCompleted/PodCliqueSet': 640,
                           'RollingUpdateReplicaStarted/PodCliqueScalingGroup': 640,
                           'RollingUpdateReplicaStarted/PodCliqueSet': 640,
                           'RollingUpdateStarted/PodCliqueSet': 640},
                'summary': {'all_ready': True,
                            'resource_version': 682721,
                            'census': {'ClusterTopology': [1, 1],
                                       'Event': [1000, 679520],
                                       'HorizontalPodAutoscaler': [1280, 146994],
                                       'Pod': [47200, 673121],
                                       'PodClique': [23040, 682081],
                                       'PodCliqueScalingGroup': [960, 669921],
                                       'PodCliqueSet': [10240, 679521],
                                       'PodGang': [10400, 682721],
                                       'Role': [10240, 147192],
                                       'RoleBinding': [10240, 147193],
                                       'Secret': [10240, 147194],
                                       'Service': [10240, 147195],
                                       'ServiceAccount': [10240, 147191]},
                            'reconcile_total': {'podclique': 199360.0,
                                                'podcliquescalinggroup': 13760.0,
                                                'podcliqueset': 97920.0},
                            'digest': {'ClusterTopology': '02b841404e7e330cdc38d9f771e094f47d83e7e69b9d047b64d95199fc940420',
                                       'HorizontalPodAutoscaler': 'bbf1ec8295b54e1551e74e9c4341679fe434ce9009c619bd49518ba73c25474e',
                                       'Pod': 'fcaeb0fb12d06adfe5fb5bf4fcd571c2b9952f1bcdef194b455e92d36b2bc58e',
                                       'PodClique': 'cd55697d26d764adefa84550d074683ebcde8b63b0770e1e07565b38b048da62',
                                       'PodCliqueScalingGroup': '12555232932a87af47124c5be7dea6782a7b2bcbacf5fe11282cf666a422eb31',
                                       'PodCliqueSet': '329431c56985e38ce6c3eaf7bfac29750b32fac5aaa46678ac99a8260b523c02',
                                       'PodGang': 'be3492597fc9ddeb7ddfcf36e2b909aeae54d6ec9d93303ff7a8b49a2e3af01c',
                                       'Role': '78767fc81e01aec7e64ac861ee666083e1470794d231dfda1489f2d086a14a34',
                                       'RoleBinding': '3687792b1112af8cfae18fa10dbc0f912cf71716501728042b09a574478cbcd1',
                                       'Secret': '00ef6f58ff2e21a1afef38b3bfe81a4e68ff1a866839b3713a795af388e33ba0',
                                       'Service': '5ebacd1ade6d546ddfa421786a6ffb064fef8a479a1c364ad5edb472d99165e4',
                                       'ServiceAccount': '43959ebc96a88dd4818dc819f10963d6c06e2020cb36c0d2ce8d4f93748a9912'},
                            'scored_gangs': 10400,
                            'score_sum': 10279.270426690578,
                            'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205'}}],
 'samples': {'agentic-pipeline.yaml': {'ticks': 5,
                                       'tree_sha256': '79ee424795e852bd3e63daa10fcb6cf012a4103ef539c61d82d6b6cde6b89a73',
                                       'tree_lines': 15,
                                       'resource_version': 95,
                                       'census': {'ClusterTopology': [1, 1],
                                                  'Event': [14, 47],
                                                  'Pod': [9, 92],
                                                  'PodClique': [4, 93],
                                                  'PodCliqueSet': [1, 95],
                                                  'PodGang': [1, 94],
                                                  'Role': [1, 6],
                                                  'RoleBinding': [1, 7],
                                                  'Secret': [1, 8],
                                                  'Service': [1, 9],
                                                  'ServiceAccount': [1, 5]},
                                       'digest': {'ClusterTopology': '02b841404e7e330cdc38d9f771e094f47d83e7e69b9d047b64d95199fc940420',
                                                  'Pod': '11425ec0e676f4693b29b091f33b9787aad9a16324f2450e77edd0fedc9b1dab',
                                                  'PodClique': 'be97a7681db33d3f4b0a6dd0a9f494846ccd3c55f8cc6c3e495890bc7e35e1b4',
                                                  'PodCliqueSet': 'e39aba151f2ed170c790d46767bd895357b4ff68afe46aa0e85ab09dc4535ba4',
                                                  'PodGang': '7a85a6631b29b34fff53b1838427a9c786f39de146021293cde4de61b94b88a1',
                                                  'Role': '729e72eb64c40a53644ee9034dd8d835f33095bc3992add0fb03b0636a80ef40',
                                                  'RoleBinding': 'e55975bccc1ea2da848635a895e24bd76f33354186a151974101556f0e39bb72',
                                                  'Secret': '8b0f135841592b588f02906a7a351340ef3bc600e02fd9927b62b648ef4970d1',
                                                  'Service': '8b197a80a7f986b0aa16f64d7377828d01b060c6c71c61125b120efcf01ee3ee',
                                                  'ServiceAccount': 'e49c99bdac487e8dbf7d0c8300cc05c63e0544aebdebe06ada1ec03aa90a9ed2'},
                                       'scored_gangs': 1,
                                       'score_sum': 0.8518519401550293,
                                       'bindings_sha256': '207105ba00a51e65a7224a8a9f1489f379997aa95d269e951984c8a5b8a41357'},
             'cluster-topology-tpu.yaml': {'ticks': 1,
                                           'tree_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                                           'tree_lines': 0,
                                           'resource_version': 1,
                                           'census': {'ClusterTopology': [1, 1]},
                                           'digest': {'ClusterTopology': 'ff96591c98f53dc3e79fd9b83a9c46adcb8dde6b31ef92514ec1141b963e76c2'},
                                           'scored_gangs': 0,
                                           'score_sum': 0,
                                           'bindings_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855'},
             'drain-budget.yaml': {'ticks': 4,
                                   'tree_sha256': '32f9f3bad23bb82b48dd761d1eacbd27c971fd399cc3734a6d447f369749ecd5',
                                   'tree_lines': 13,
                                   'resource_version': 83,
                                   'census': {'ClusterTopology': [1, 1],
                                              'Event': [12, 43],
                                              'Pod': [6, 74],
                                              'PodClique': [3, 78],
                                              'PodCliqueSet': [1, 83],
                                              'PodGang': [3, 82],
                                              'Role': [1, 6],
                                              'RoleBinding': [1, 7],
                                              'Secret': [1, 8],
                                              'Service': [3, 11],
                                              'ServiceAccount': [1, 5]},
                                   'digest': {'ClusterTopology': '02b841404e7e330cdc38d9f771e094f47d83e7e69b9d047b64d95199fc940420',
                                              'Pod': '542b9788e3ec7feb9ae20bb91c8031e7f381099ebe334c88daab523e14b352c6',
                                              'PodClique': '46486b4a60b2381b9f012f9464ebbe1c273e10167da36f3108c101d633d6e1fc',
                                              'PodCliqueSet': 'd4430e3c6deda9ac625de2627dd7028de227732ead12600e6727a8b8b0972233',
                                              'PodGang': 'f60177d6634215ef8d85dbe5e8ac7991cd0251b70181f300ccc14583630f209b',
                                              'Role': '76646fd9bfebbf5cbb3f90acdb3bf1e6974531b2fbedec58fa1584dcde45e774',
                                              'RoleBinding': 'b59958f63b1a3325a397e70304957b3f6ce570757953eadddf43e7eeba4e2c48',
                                              'Secret': '11e1413cd68c0b522dd0639f7e58c42d45f4316e63d696967d644898ed5c8854',
                                              'Service': '7522eb76361c43b33d92ecb7dd373e2dbbb2dc30760792dbcf6902a38bcdcc74',
                                              'ServiceAccount': '31510c1d5a4314a1f405f49338afe2179d588dd12cfe47926236a3aa5bd61e15'},
                                   'scored_gangs': 3,
                                   'score_sum': 3.0,
                                   'bindings_sha256': '171379a4a10ff4771bc1be6f471c7654f356ab459463aa1030faf9047962d36f'},
             'multinode-disaggregated.yaml': {'ticks': 5,
                                              'tree_sha256': '2cc468f996ebe4a786f18c4b67cd7380ef0f072ffb9816ec7e09ca8c31da4ca8',
                                              'tree_lines': 24,
                                              'resource_version': 143,
                                              'census': {'ClusterTopology': [1, 1],
                                                         'Event': [17, 69],
                                                         'Pod': [13, 137],
                                                         'PodClique': [6, 140],
                                                         'PodCliqueScalingGroup': [2, 141],
                                                         'PodCliqueSet': [1, 143],
                                                         'PodGang': [2, 142],
                                                         'Role': [1, 6],
                                                         'RoleBinding': [1, 7],
                                                         'Secret': [1, 8],
                                                         'Service': [1, 9],
                                                         'ServiceAccount': [1, 5]},
                                              'digest': {'ClusterTopology': '02b841404e7e330cdc38d9f771e094f47d83e7e69b9d047b64d95199fc940420',
                                                         'Pod': '02d88f49a35fde7379e011bd63c0dffba679004a9dcf60e1ca3d56b20ca7aed3',
                                                         'PodClique': 'ddceb435a3f9fa809a82b6e351cc4630b996fd2176b7cdde72b7aed217d2937b',
                                                         'PodCliqueScalingGroup': '50a6463ad7d08d98806260a627ac4e037f6badb6f7e5fa07e882bf359d26c2b4',
                                                         'PodCliqueSet': '6cc5eddc7f26cbdfc0377d3c21ac677435b8ec11b9bd6abfffef93de05c86aa1',
                                                         'PodGang': 'cc306b4e1dfc6b57f73852a1308971f4b91e45372c8e3b548bf7abd52cf9a8fb',
                                                         'Role': '68500e01ba73c77148c834f9773b43b2b1132acc7a8efa683bd4833711cada11',
                                                         'RoleBinding': '8b5f7a9cbd14daf6f3422f2b65adb69c03c8c8fe5137eee0e49390fbcb31416e',
                                                         'Secret': '2a53e42e53d097ae0a1f5246de7a064efa74c2ce4cb2aef3c97045c935ec56a9',
                                                         'Service': '961373d4dba314467b103e9458b6254229af01cb0d3c376a23443d45eee20573',
                                                         'ServiceAccount': '3381ba821d534e8de1dcf7c031a661ba3a7fd9c31e5aff0a2d83922b182e20db'},
                                              'scored_gangs': 2,
                                              'score_sum': 1.6333335041999817,
                                              'bindings_sha256': '6dd46c93a2c59381cd903d6a31254d5eeb3e4adf3491e203eeeae072879ae10b'},
             'multitenant-queues.yaml': {'ticks': 4,
                                         'tree_sha256': 'f0bb105393be9fac94de0da360bbfeaf57deee57f226bbc30370d2dce4c7f707',
                                         'tree_lines': 10,
                                         'resource_version': 79,
                                         'census': {'ClusterTopology': [1, 1],
                                                    'Event': [8, 43],
                                                    'Pod': [4, 67],
                                                    'PodClique': [2, 71],
                                                    'PodCliqueSet': [2, 79],
                                                    'PodGang': [2, 75],
                                                    'Queue': [2, 77],
                                                    'Role': [2, 20],
                                                    'RoleBinding': [2, 21],
                                                    'Secret': [2, 22],
                                                    'Service': [2, 23],
                                                    'ServiceAccount': [2, 19]},
                                         'digest': {'ClusterTopology': '02b841404e7e330cdc38d9f771e094f47d83e7e69b9d047b64d95199fc940420',
                                                    'Pod': '041137d17a1418403b59f596c22625e7ac0f2a6d571f3ec216555af9437b4d1c',
                                                    'PodClique': '33ce2ccc61026216b15475f2e74cb846902e1482b107d2e06ee3012f94962ff2',
                                                    'PodCliqueSet': 'db4275bcc0d1d2962c3b23c284c1e3168574d1c9463e0be851812225fc66d789',
                                                    'PodGang': '3ac5b2bf4d000cbd5b80ba615cee44c1159ac146a7d4d1678ec2bff8ba71379e',
                                                    'Queue': '82e11d9d3d440a9aaddc004be4f13798236fb3d95e295ee549faae0630c9fe5d',
                                                    'Role': '287c937c65637e24cb01f4a3035fafd2c79754d305fdbbe71ac1f3923b760a42',
                                                    'RoleBinding': '82011a08a8cd60bcd18525a20d46d080625f7e01c1ba55538809092451030a9a',
                                                    'Secret': '1cbd42689db19f05cdf6e1c9ac10e99ca5bd989ea7256d63168a71b722eb36c8',
                                                    'Service': 'f0e3e3804f3e63f399650cbe285f024f9042fbb92c07bb43097d503b7faa4e7b',
                                                    'ServiceAccount': 'e431ad28e391ed4143fcf3d3b9fd103057b9d1e7b6bb30998acd340fc1e31263'},
                                         'scored_gangs': 2,
                                         'score_sum': 2.0,
                                         'bindings_sha256': '1f672032001be9076489e6aec193e51637c22ab1dc2cc7445e858b32c55cc276'},
             'simple1.yaml': {'ticks': 4,
                              'tree_sha256': '7c988802358934518bbd16650ee2717317187d38aae7bdfde4ad1a130b1c149a',
                              'tree_lines': 16,
                              'resource_version': 100,
                              'census': {'ClusterTopology': [1, 1],
                                         'Event': [13, 54],
                                         'HorizontalPodAutoscaler': [2, 11],
                                         'Pod': [9, 91],
                                         'PodClique': [4, 96],
                                         'PodCliqueScalingGroup': [1, 97],
                                         'PodCliqueSet': [1, 100],
                                         'PodGang': [1, 99],
                                         'Role': [1, 6],
                                         'RoleBinding': [1, 7],
                                         'Secret': [1, 8],
                                         'Service': [1, 9],
                                         'ServiceAccount': [1, 5]},
                              'digest': {'ClusterTopology': '02b841404e7e330cdc38d9f771e094f47d83e7e69b9d047b64d95199fc940420',
                                         'HorizontalPodAutoscaler': '4a8d396129b9de061721b348de64c919ad8efb68f3adace21c329a9af27bbc4f',
                                         'Pod': 'ec381d02b308fb6a4dd81f5d3b94dac42a1b5113d399de947e3db755e06fd0ca',
                                         'PodClique': '4ca1cc4527ecb4b11cf386cd3862dcf10e35dcd4452dfb465f45d5ae8c92d5f9',
                                         'PodCliqueScalingGroup': '7634ba434b41bc25d2a031042cc6a0c940785862eff481e328f78121f3bc3dda',
                                         'PodCliqueSet': 'c19ae9e9606889e11233db3317dbd1a2e69a8ad20e72efdf2a8bdbc35b2f1121',
                                         'PodGang': '0f763667857a137d34e9a1b282fbe8ef7f45880ca7ec47967e8b472528387c32',
                                         'Role': 'd8f4513c33fc8ae65081f39b3109809a8dbd58eeec1795ee8c6e806568ee9a26',
                                         'RoleBinding': '8a2a99cafe12daab3be8eadfe3aac88f502613220e3e9ad4f5f2d8d75eebac04',
                                         'Secret': '0dc4ff82c3544ef5806159b938c6358bb2b23de333750d85347d1cb39c1a2c19',
                                         'Service': '939590905bb42504cbb66a0a4e4961c9fcbfe370e3281fc45bdb85e7f82df257',
                                         'ServiceAccount': '74be9c6da80b82c142d2d9f69eb8ff3491db1e1a64fffa3d995611320b505215'},
                              'scored_gangs': 1,
                              'score_sum': 1.0,
                              'bindings_sha256': 'bdb3072106075a7efecca893ba4a2f8087e3ecac549593a476191d63e0392436'},
             'simple2-explicit-startup-order.yaml': {'ticks': 5,
                                                     'tree_sha256': 'f4c809059367cbbf8630837ce39e96841c8955b0e4bc5c16f2ba8dcd2184cadb',
                                                     'tree_lines': 15,
                                                     'resource_version': 97,
                                                     'census': {'ClusterTopology': [1, 1],
                                                                'Event': [14, 48],
                                                                'HorizontalPodAutoscaler': [1, 10],
                                                                'Pod': [9, 94],
                                                                'PodClique': [4, 95],
                                                                'PodCliqueSet': [1, 97],
                                                                'PodGang': [1, 96],
                                                                'Role': [1, 6],
                                                                'RoleBinding': [1, 7],
                                                                'Secret': [1, 8],
                                                                'Service': [1, 9],
                                                                'ServiceAccount': [1, 5]},
                                                     'digest': {'ClusterTopology': '02b841404e7e330cdc38d9f771e094f47d83e7e69b9d047b64d95199fc940420',
                                                                'HorizontalPodAutoscaler': '56b5a226a64bc628002e65b0522bbb37bc2ae62e3ce483dcc30ca2408b297965',
                                                                'Pod': 'a6b1d38fa5623a866be84fe172916ff36fe791880aec66f867dd98022bfb8eff',
                                                                'PodClique': 'c234edf9424d33fb66cd7178382c6cab2a94736483972ed1076633e03769899a',
                                                                'PodCliqueSet': '68d23020b9e31808e4bfcfed3f01299a6a5b1dbdd88d8da4eb9fce0ed7be6b08',
                                                                'PodGang': '714d8bd49bb6b24415a7d1de59cf31b0cede9a866acf7eff58f4c4554687ead9',
                                                                'Role': '9c5b4f84de74cdb93207a1f27d0e2bc89dfa7ed027b584f9877cc93c4ffd53e8',
                                                                'RoleBinding': '02f3db71659dd285176ec0135b5bdfdd5b47d8cec9c2fe3f68f73db647e06bed',
                                                                'Secret': '6ed1bcb486b20254d38eff18c10a3ae62521c776ad737d4e3edbb578120d15a3',
                                                                'Service': '2ed59c16546eda80c3844c0a8b6030c7b5391df26fd884d018442a35f59c89b4',
                                                                'ServiceAccount': '5860d618e91732b7d78d9b87f24aaadd28db123a6050d7c6cf060f15849f1205'},
                                                     'scored_gangs': 1,
                                                     'score_sum': 1.0,
                                                     'bindings_sha256': '818c364ea2137ab0cec215290bdd12bd06e059d483d8a95934152179e65eb873'},
             'simple3-explicit-startup-order.yaml': {'ticks': 5,
                                                     'tree_sha256': 'ea3af79327fc3f67939ddcbedb07b3d88061ed39f11ecc8e1827f30345788060',
                                                     'tree_lines': 18,
                                                     'resource_version': 115,
                                                     'census': {'ClusterTopology': [1, 1],
                                                                'Event': [14, 59],
                                                                'HorizontalPodAutoscaler': [2, 11],
                                                                'Pod': [10, 111],
                                                                'PodClique': [5, 113],
                                                                'PodCliqueScalingGroup': [1, 101],
                                                                'PodCliqueSet': [1, 115],
                                                                'PodGang': [1, 114],
                                                                'Role': [1, 6],
                                                                'RoleBinding': [1, 7],
                                                                'Secret': [1, 8],
                                                                'Service': [1, 9],
                                                                'ServiceAccount': [1, 5]},
                                                     'digest': {'ClusterTopology': '02b841404e7e330cdc38d9f771e094f47d83e7e69b9d047b64d95199fc940420',
                                                                'HorizontalPodAutoscaler': 'a0bf27831bbee572082da2e3a5ad6b8d9b141cb176cbce92fd65f8945f83d7e2',
                                                                'Pod': 'f83b57bca474c6e3b6aa042c73546b29f184f89624e0b66b20a4e9092d3dd0a9',
                                                                'PodClique': '9621d9c49ae247272e6be1586ad163b953d944bfacfba5c249f0c32d73ad8261',
                                                                'PodCliqueScalingGroup': 'e544f0f15272aa19e316b7aca6aeba06349c54dd8866ab6e938d9296a1bc2d45',
                                                                'PodCliqueSet': 'c09184b511897f455d442b962fa0ff24bc0b6696bc08eb71d1a665aafb70ed62',
                                                                'PodGang': '9f83c4d9d03809e11c96bda4f059dd0adede8781f80a34b75b30a91746d83954',
                                                                'Role': '458aea26ce91a9b37bf68c810042a66edade306642cf84e313b2e6b71c27d4a6',
                                                                'RoleBinding': 'eb7efa18d87c06dfcb4ae358c865468c20558c80f69c59dcb80a39a1e751482a',
                                                                'Secret': '88c203fd0e1b50bfde6d81f8a21fc8ff055dc4d9850d86844eef7fff19c11216',
                                                                'Service': 'ee5623e76d14376b79c43c3b1a984173e28729fc6d1c24833fad9cd2ec9b7ce2',
                                                                'ServiceAccount': '6ec4b87cf98952777ff244b302d9bc6f5841fa86cef52b09ccf25639c8f3071b'},
                                                     'scored_gangs': 1,
                                                     'score_sum': 1.0,
                                                     'bindings_sha256': '8c0b26731bc55a75c3ff755f786228d4139050fe4c8932fe712d89f127e55550'},
             'single-node-disaggregated.yaml': {'ticks': 4,
                                                'tree_sha256': 'c14f389c8edc020f51f90ce83eae37a69b863280adcce74b92ed5b2d07be828b',
                                                'tree_lines': 7,
                                                'resource_version': 50,
                                                'census': {'ClusterTopology': [1, 1],
                                                           'Event': [4, 29],
                                                           'HorizontalPodAutoscaler': [1, 10],
                                                           'Pod': [2, 43],
                                                           'PodClique': [2, 46],
                                                           'PodCliqueScalingGroup': [1, 47],
                                                           'PodCliqueSet': [1, 50],
                                                           'PodGang': [1, 49],
                                                           'Role': [1, 6],
                                                           'RoleBinding': [1, 7],
                                                           'Secret': [1, 8],
                                                           'Service': [1, 9],
                                                           'ServiceAccount': [1, 5]},
                                                'digest': {'ClusterTopology': '02b841404e7e330cdc38d9f771e094f47d83e7e69b9d047b64d95199fc940420',
                                                           'HorizontalPodAutoscaler': 'c499943652a839028ad9ce81901227862b000c467b66577f0872884e5aeed98b',
                                                           'Pod': 'a2c694e6e3f3f8084b6d63d3baf27a959f996a80bc94fc5b253c9af9f2e96f8f',
                                                           'PodClique': 'ea8a349d129656d7795737211aa414f247be7ee096691ce50bc46f75ba9f012d',
                                                           'PodCliqueScalingGroup': '3cd3c51f1b814422cfe080dd2936c67fee44988a16d1473f2d36de491d4f6adc',
                                                           'PodCliqueSet': 'dc6fbc5ba0e9b94f85328364007320b7841d5aa36557f4690df90f4e4c07f994',
                                                           'PodGang': 'a603034d734be56cac7212030c8e6781f0f8f8efb532728b92dd97c4c2b5e78e',
                                                           'Role': 'dfb99eeb7a32d650c0c18ff79c4ce6891fb3e7c3ef067e143558046243191fd8',
                                                           'RoleBinding': '0bb9d1eac042b2aef372508e14a6a9cb02cc521590f5ca029a67c7f23db88f2b',
                                                           'Secret': 'd9729fae86e90f823db01d1cc31b51b8c0d4cf1e1d594cd54ff8fe21120d0932',
                                                           'Service': 'ad6f7a13567a157e23d4b807e4234668b02ca031aaac690169edfd968d58e584',
                                                           'ServiceAccount': '4c22da20ff6f3ddaacf238e251a80d0b3bf8e67d7be398c177b836bd4641275b'},
                                                'scored_gangs': 1,
                                                'score_sum': 0.833333432674408,
                                                'bindings_sha256': '8d99c940166b99457c3e24defd26e0809d1de44bf65a6ac70400b7cb78029623'},
             'spread-serving.yaml': {'ticks': 4,
                                     'tree_sha256': '3099b90fd7267bc011176fdd24cf00537b438bcd44108b7030bb8b6f2100358f',
                                     'tree_lines': 12,
                                     'resource_version': 74,
                                     'census': {'ClusterTopology': [1, 1],
                                                'Event': [11, 37],
                                                'Pod': [8, 68],
                                                'PodClique': [2, 71],
                                                'PodCliqueSet': [1, 74],
                                                'PodGang': [1, 73],
                                                'Role': [1, 6],
                                                'RoleBinding': [1, 7],
                                                'Secret': [1, 8],
                                                'Service': [1, 9],
                                                'ServiceAccount': [1, 5]},
                                     'digest': {'ClusterTopology': '02b841404e7e330cdc38d9f771e094f47d83e7e69b9d047b64d95199fc940420',
                                                'Pod': '3a588f6dcce41e2e57551d588df78a9a9974b546454986bf30fb2938d11e6183',
                                                'PodClique': 'd818357b2a5b6056378387b596f2a5c99feec3522a6dd83ed1d417feef37ee0b',
                                                'PodCliqueSet': '948411d7d69cf0b3bc1a3611d923292dd143ca9c577c3b9afa0a3d901e43fd3f',
                                                'PodGang': '1b57f95b78385fbc791488458b139ad6ce718d0c44641ae089186be06055bb0a',
                                                'Role': 'bf848118e9d85f9b945b2b2d55786cd7ab8de0f936deea18f2bf3ced9581c9ee',
                                                'RoleBinding': '51de7793243d69df8c6a8890fed91669dfb639c6108309c00cf396e69e749447',
                                                'Secret': '49f8c5e476a432f7d9b799ce1717a35f38c4e5e1604dbfa62fb1af6447718ec8',
                                                'Service': '9427c49c8ffcf92aa5d208d859b71c8a2420c5268e59e86b8513f18c50c48566',
                                                'ServiceAccount': 'e5a547ee02caaaa83307368f1e1c0270534851f7b5bc9ff90bf824a0f922a9ba'},
                                     'scored_gangs': 1,
                                     'score_sum': 1.0,
                                     'bindings_sha256': 'ffc220ea09ee218786c435a726a81761fafb4758807949c38a7f431afecc4daf'}}}


def _pin_string_hash() -> None:
    """Re-run this script under PYTHONHASHSEED=0 unless it already is: the
    controllers iterate Python sets of strings (the store's label index, the
    kubelet's not-Ready set), so the order of commits, and with it every
    resourceVersion that [operator] holds to JAX_OPERATOR_REFERENCE, follows
    the string hash; the reference was taken under seed 0."""
    if os.environ.get("PYTHONHASHSEED") != "0":
        sys.stdout.flush()
        os.execve(sys.executable, [sys.executable] + sys.argv,
                  dict(os.environ, PYTHONHASHSEED="0"))


def _check_same(tag, got, want) -> None:
    if got != want:
        keys = sorted(set(got) | set(want)) if isinstance(got, dict) and isinstance(
            want, dict) else []
        diff = [k for k in keys if got.get(k) != want.get(k)]
        _fail(f"{tag}: {diff or got} differs from the JAX package's"
              + (f" ({got.get(diff[0])} != {want.get(diff[0])})" if diff else ""))


def _check_scored(tag, got, want) -> None:
    """Nested records equal, every "score_sum" at rtol 1e-6 (the card and
    the CPU agree on placement scores to that)."""
    if isinstance(got, dict) and isinstance(want, dict):
        if set(got) != set(want):
            _fail(f"{tag}: keys {sorted(set(got) ^ set(want))} differ from the JAX package's")
        for k in got:
            if k == "score_sum":
                if not np.isclose(got[k], want[k], rtol=1e-6, atol=0):
                    _fail(f"{tag}: score sum {got[k]} != {want[k]} (the JAX package's)")
            else:
                _check_scored(f"{tag} {k}", got[k], want[k])
    elif isinstance(got, (list, tuple)) and isinstance(want, (list, tuple)):
        if len(got) != len(want):
            _fail(f"{tag}: {len(got)} entries, the JAX package's {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_scored(f"{tag} {i}", g, w)
    elif got != want:
        _fail(f"{tag}: {got} differs from the JAX package's ({want})")


def _check_round(tag, got, want) -> None:
    """A recorded tick or round: its round_summary's score sum at rtol
    1e-6, everything else equal."""
    got, want = dict(got), dict(want)
    got_round, want_round = dict(got.pop("round")), dict(want.pop("round"))
    if not np.isclose(got_round.pop("score_sum"), want_round.pop("score_sum"), rtol=1e-6, atol=0):
        _fail(f"{tag}: score sum differs from the JAX package's")
    _check_same(tag, got, want)
    _check_same(f"{tag} round", got_round, want_round)


# the first fill launches of each solve kind in (iota) that [operator] holds
# against the plain fill, beside the first of every other shape
OPERATOR_FILL_CALLS = 8


class _RecordedKernelFills:
    """While active, every fill kernel launch (ops.fill._fill_batch_cuda)
    is tagged by the solve it came from (the scheduler's global
    solve_waves, the frontier's stacked dispatch or its residual
    solve_waves) and a copy of its arguments kept for the first `first`
    calls of each tag and the first call of each other shape."""

    def __init__(self, first):
        self.first, self.calls, self._tag = first, [], ["other"]
        self._per_tag, self._shapes = {}, set()

    def __enter__(self):
        from grove_tpu_torch.ops import fill as fill_mod
        from grove_tpu_torch.solver import frontier, scheduler

        self._saved = [(fill_mod, "_fill_batch_cuda"), (frontier, "solve_waves_stacked"),
                       (frontier, "solve_waves"), (scheduler, "solve_waves")]
        self._saved = [(m, name, getattr(m, name)) for m, name in self._saved]
        launch = fill_mod._fill_batch_cuda

        def record(free, mask, demand, count, with_free_after):
            tag = self._tag[-1]
            shape = (tag, tuple(free.shape), tuple(mask.shape), tuple(demand.shape),
                     with_free_after)
            n = self._per_tag.get(tag, 0)
            if n < self.first or shape not in self._shapes:
                self._per_tag[tag] = n + 1
                self._shapes.add(shape)
                self.calls.append((f"{tag} {'call ' + str(n) if n < self.first else 'shape'}",
                                   tuple(t.clone() for t in (free, mask, demand, count)),
                                   with_free_after))
            return launch(free, mask, demand, count, with_free_after)

        def tagged(tag, fn):
            def run(*args, **kw):
                self._tag.append(tag)
                try:
                    return fn(*args, **kw)
                finally:
                    self._tag.pop()
            return run

        fill_mod._fill_batch_cuda = record
        frontier.solve_waves_stacked = tagged("stacked", frontier.solve_waves_stacked)
        frontier.solve_waves = tagged("residual", frontier.solve_waves)
        scheduler.solve_waves = tagged("global", scheduler.solve_waves)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)
        return False

    @contextlib.contextmanager
    def paused(self):
        """Record nothing inside (a later phase run from this one records
        its own launches)."""
        self.__exit__()
        try:
            yield
        finally:
            self.__enter__()


def check_recorded_fills(recorded, phase, device="cuda"):
    """Each recorded fill call through the kernel and the plain fill on the
    same tensors: alloc, placed and free_after bit for bit. The launches
    made here are not counted (the counter is restored). A CPU rehearsal's
    plain fill never reaches the kernel's launcher, so it records nothing."""
    from grove_tpu_torch.ops.fill import fill_batch, fill_batch_ref

    if device == "cpu":
        return 0.0
    if not recorded.calls:
        _fail(f"{phase}: the run made no fill call")
    launches, max_err = fill_batch.launches, 0.0
    for i, (tag, args, with_free_after) in enumerate(recorded.calls):
        free, mask, demand, count = args
        out = fill_batch(*args, with_free_after=with_free_after)
        ref = fill_batch_ref(*args, with_free_after=with_free_after)
        name = f"{phase} fill {i} ({tag})"
        max_err = max(max_err, _check_equal(name, out, ref))
        if with_free_after and not torch.equal(out[2].view(torch.int32),
                                               ref[2].view(torch.int32)):
            _fail(f"fill kernel != plain ({name}: free_after bits)")
        c, p, r = demand.shape
        print(f"[{phase}] fill {i} ({tag}): C={c} P={p} N={mask.shape[-1]} R={r}, free"
              f" {'shared' if free.dim() == 2 else 'per-gang'} (max"
              f" {float(free.max()):.6g}), free_after {'yes' if with_free_after else 'no'},"
              f" placed {int(out[1].sum())}: kernel == plain bit for bit", flush=True)
    fill_batch.launches = launches
    return max_err



def phase_operator(card, device="cuda", n_sets=None, n_nodes=None, update_every=None,
                   reference=None, then=None) -> dict:
    """[operator]: (iota) at full width through the port's SimHarness on the
    card, every converge tick (tick_once's work, bound and started, and
    round_summary of its schedule) and after each converge the store's
    census, resourceVersion, reconcile counts, canonical digest, event
    counts and bindings hash held to JAX_OPERATOR_REFERENCE, every pod
    Ready; then the ten samples, each tree() and digest equal. The fill
    kernel must launch in (iota) and both DRF kernels in the samples (the
    Queue sample). The first fill calls of (iota) and the first of each
    other shape are held against the plain fill (_RecordedKernelFills).
    ``device``, a cut and its ``reference`` (the "operator"
    object of `scripts/scheduler_reference.py operator --sets N --nodes M`)
    rehearse the phase on the CPU. ``then(harness)`` runs on (iota)'s
    converged harness after the rolling update ([churn]); its launches
    are its own (the counts are saved around it, the recorder paused) and
    its result lands under ``"then"``."""
    from grove_tpu_torch.models.scenarios import (
        operator_missing, port_names, run_operator_world, run_samples_world)
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda

    ref = JAX_OPERATOR_REFERENCE if reference is None else reference
    pkg = port_names(device)
    def after_tick(step, index, wall_s, tick):
        ticks = ref["converges"][("converge", "rolling_update").index(step)]["ticks"]
        tag = f"operator {step} tick {index}"
        if index > len(ticks):
            _fail(f"{tag}: the JAX run converged in {len(ticks)} ticks")
        _check_round(tag, tick, ticks[index - 1])
        print(f"[operator] {step} tick {index}: {wall_s:.3f} s; work {tick['work']}, bound"
              f" {tick['bound']}, started {tick['started']}, events"
              f" {tick['round']['events_by_reason']}; equal to the JAX package's", flush=True)

    def then_apart(harness):
        counts = (fill_batch.launches, share_table_cuda.launches, merge_cuda.launches)
        try:
            with recorded.paused():
                return then(harness)
        finally:
            fill_batch.launches, share_table_cuda.launches, merge_cuda.launches = counts

    fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0
    with _RecordedKernelFills(OPERATOR_FILL_CALLS) as recorded:
        got = run_operator_world(pkg, n_sets, n_nodes, update_every, device=device,
                                 after_tick=after_tick,
                                 then=then_apart if then is not None else None)
    launches = {"fill": fill_batch.launches, "drf_shares": share_table_cuda.launches,
                "drf_merge": merge_cuda.launches}
    fill_err = check_recorded_fills(recorded, "operator", device)
    walls = got.pop("walls")
    _check_same("operator world", got["world"], ref["world"])
    _check_same("operator apply", got["apply"], ref["apply"])
    if len(got["converges"]) != len(ref["converges"]):
        _fail("operator: the converges differ in number from the JAX package's")
    for step, g, w in zip(("converge", "rolling_update"), got["converges"], ref["converges"]):
        if len(g["ticks"]) != len(w["ticks"]):
            _fail(f"operator {step}: {len(g['ticks'])} ticks, the JAX run {len(w['ticks'])}")
        _check_same(f"operator {step} events", g["events"], w["events"])
        got_summary, want_summary = dict(g["summary"]), dict(w["summary"])
        if not np.isclose(got_summary.pop("score_sum"), want_summary.pop("score_sum"),
                          rtol=1e-6, atol=0):
            _fail(f"operator {step}: score sum {g['summary']['score_sum']} != the JAX"
                  f" package's {w['summary']['score_sum']}")
        _check_same(f"operator {step} summary", got_summary, want_summary)
    missing = operator_missing(got)
    if missing:
        _fail(f"operator: the run did not show {missing}")
    fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0
    t0 = time.perf_counter()
    samples = run_samples_world(pkg, device=device)
    samples_s = time.perf_counter() - t0
    sample_launches = {"fill": fill_batch.launches, "drf_shares": share_table_cuda.launches,
                       "drf_merge": merge_cuda.launches}
    for name, want in ref["samples"].items():
        got_sample, want = dict(samples.get(name) or {}), dict(want)
        if not np.isclose(got_sample.pop("score_sum", None), want.pop("score_sum"), rtol=1e-6,
                          atol=0):
            _fail(f"operator sample {name}: score sum differs from the JAX package's")
        _check_same(f"operator sample {name}", got_sample, want)
    if set(samples) != set(ref["samples"]):
        _fail(f"operator: samples {sorted(samples)} != the JAX package's")
    if device != "cpu":
        if not launches["fill"]:
            _fail(f"operator: (iota) did not launch the fill kernel: {launches}")
        if not (sample_launches["drf_shares"] and sample_launches["drf_merge"]):
            _fail(f"operator: the samples did not launch both DRF kernels: {sample_launches}")
    conv, roll = walls["converge"], walls["rolling_update"]
    out = {
        "sets": got["world"]["n_sets"], "nodes": got["world"]["n_nodes"],
        "apply_s": walls["apply_s"], "converge_s": conv["wall_s"], "ticks": conv["ticks"],
        "solver_s": conv["solver_s"], "solver_share": conv["solver_s"] / conv["wall_s"],
        "reconciles": conv["reconciles"],
        "us_per_reconcile": 1e6 * conv["wall_s"] / max(conv["reconciles"], 1),
        "update_apply_s": walls["update_apply_s"], "rolling_update_s": roll["wall_s"],
        "rolling_update_ticks": roll["ticks"], "rolling_update_reconciles": roll["reconciles"],
        "pods": got["converges"][0]["summary"]["census"]["Pod"][0],
        "samples_s": samples_s,
        **{f"{k}_launches": v for k, v in launches.items()},
        **{f"samples_{k}_launches": v for k, v in sample_launches.items()},
        "fill_calls_checked": len(recorded.calls), "fill_max_abs_err": fill_err,
        "then": got.get("then"),
    }
    print(f"[operator] (iota) {out['sets']} sets on {out['nodes']} nodes, {out['pods']} pods"
          f" all Ready, every tick and digest equal to the JAX package's: apply"
          f" {out['apply_s']:.3f} s, converge {out['converge_s']:.3f} s in {out['ticks']} ticks"
          f" (solver {out['solver_s']:.3f} s, share {out['solver_share']:.4f};"
          f" {out['reconciles']:.0f} reconciles, {out['us_per_reconcile']:.1f} us each);"
          f" rolling update of {len(range(0, out['sets'], got['world']['update_every']))} sets"
          f" {out['rolling_update_s']:.3f} s in {out['rolling_update_ticks']} ticks; launches fill"
          f" {launches['fill']}, DRF {launches['drf_shares']} + {launches['drf_merge']};"
          f" ten samples {samples_s:.3f} s, each tree and digest equal, launches fill"
          f" {sample_launches['fill']}, DRF {sample_launches['drf_shares']} +"
          f" {sample_launches['drf_merge']}; {len(recorded.calls)} of (iota)'s fill calls"
          f" equal to the plain fill bit for bit | {card}", flush=True)
    return out


# [churn]: delta_artifact's churn ticks and comparison segment, cut from the
# bench's 96 and 32 (PERF.md section 4); selfcheck_every=16 and flap_every=32
# kept, and 33 ticks still reach the flap at tick 32 (a full fallback)
CHURN_SMOKE_TICKS = 33
CHURN_SMOKE_FULLPATH_TICKS = 8
CHURN_FILL_CALLS = 8  # the first fill calls of [churn] held against the plain fill

# scripts/scheduler_reference.py churn --churn-ticks 33 --fullpath-ticks 8 (PYTHONHASHSEED=0)
JAX_CHURN_REFERENCE = {'ticks': [{'bound': 3,
            'selfcheck': False,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47203,
                      'bindings_sha256': '319e67ae1e87a522700c964042062c869c64cbdf21572cc15e555e304a0bd4f0',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 0,
                      'drift_detected': 0,
                      'last_reencoded': 1,
                      'last_reused': 0}},
           {'bound': 6,
            'selfcheck': False,
            'round': {'admitted': 2,
                      'bound': 6,
                      'score_sum': 2.0,
                      'bindings': 47209,
                      'bindings_sha256': 'c0a4651a39cdfea550ebed5572139b61739f4ce17e23a45a7d8d9cb6429a4826',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 2},
                      'events_by_reason': {'GangAdmitted': 2, 'PodBound': 6}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 0,
                      'drift_detected': 0,
                      'last_reencoded': 2,
                      'last_reused': 0}},
           {'bound': 3,
            'selfcheck': False,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47212,
                      'bindings_sha256': 'cfbac7d1d2fad70ba665ed67b10638ae26c2d928de519563e5f8456bf1cacc75',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 1,
                      'drift_detected': 0,
                      'last_reencoded': 1,
                      'last_reused': 0}},
           {'bound': 6,
            'selfcheck': False,
            'round': {'admitted': 2,
                      'bound': 6,
                      'score_sum': 2.0,
                      'bindings': 47218,
                      'bindings_sha256': '2a4ceeee8842540d7eea1da1e6a3e79f801f2c125942fc049f65c4fd86ab2c55',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 2},
                      'events_by_reason': {'GangAdmitted': 2, 'PodBound': 6}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 1,
                      'drift_detected': 0,
                      'last_reencoded': 2,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47218,
                      'bindings_sha256': '2a4ceeee8842540d7eea1da1e6a3e79f801f2c125942fc049f65c4fd86ab2c55',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47200,
                      'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47200,
                      'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47200,
                      'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47200,
                      'bindings_sha256': 'cc50ecab4ee2245d7d6eed8d5635473a5a6ef759ff45258842356ce0287ab205',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 6,
            'selfcheck': True,
            'round': {'admitted': 2,
                      'bound': 6,
                      'score_sum': 2.0,
                      'bindings': 47206,
                      'bindings_sha256': 'a1c4e29fe0e5544037a5926db27ae14108b31927096246c8e18adafded1a8cf5',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 2},
                      'events_by_reason': {'GangAdmitted': 2, 'PodBound': 6}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 2,
                      'last_reused': 0}},
           {'bound': 3,
            'selfcheck': False,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47209,
                      'bindings_sha256': '0ca10815eed6aa318349a6a1728cec513dd01363a34a3bc32aea86288b228c1d',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 1,
                      'last_reused': 0}},
           {'bound': 3,
            'selfcheck': False,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47212,
                      'bindings_sha256': '29dc9be3ad9544ea5f07f23faab1e9fbdabb959f9242b3a6d6c3e57b65b65cda',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 1,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47212,
                      'bindings_sha256': '29dc9be3ad9544ea5f07f23faab1e9fbdabb959f9242b3a6d6c3e57b65b65cda',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47209,
                      'bindings_sha256': '182db34a23f66501a834e1a4c5e098b8d03636bd9aadd75deb7f140004438d86',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 3,
            'selfcheck': False,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47212,
                      'bindings_sha256': '0621c9759ceb514cd957739f7913f6f17507d02e82cae6ebeb9d523ebaeae89e',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 1,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47209,
                      'bindings_sha256': '0927671a2ececa7e97f5d0f9076bc92e3436bd7228e54dcc89d5302ef7c81df0',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47206,
                      'bindings_sha256': 'f005596ede1bed2ff52c55107f2bfd8dfbcca4aafcefffe4e9c2f69951acb97d',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47203,
                      'bindings_sha256': 'ba02e21bf015c99494d9ecd78e47c8ed0f8f08c2d8cff9667d62473f9ad7f037',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 6,
            'selfcheck': False,
            'round': {'admitted': 2,
                      'bound': 6,
                      'score_sum': 2.0,
                      'bindings': 47209,
                      'bindings_sha256': '4bcf73bb57d870ac01d29f3c8e76ca18f0057140fe0bd6f674042cd90914a56c',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 2},
                      'events_by_reason': {'GangAdmitted': 2, 'PodBound': 6}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 2,
                      'last_reused': 0}},
           {'bound': 3,
            'selfcheck': False,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47212,
                      'bindings_sha256': '345c4be6076ce1c57564e0bbdfd2bbbc635ad3cc2912d9036374ba5f016897cd',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 1,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47212,
                      'bindings_sha256': '345c4be6076ce1c57564e0bbdfd2bbbc635ad3cc2912d9036374ba5f016897cd',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 6,
            'selfcheck': False,
            'round': {'admitted': 2,
                      'bound': 6,
                      'score_sum': 2.0,
                      'bindings': 47218,
                      'bindings_sha256': '791a7112fd6430fd14be890be0e2b6fdf2344b40548f2f20ba7552646f01f11f',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 2},
                      'events_by_reason': {'GangAdmitted': 2, 'PodBound': 6}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 2,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47215,
                      'bindings_sha256': '1698da63432d731c1ccc43680b5ed06c028e66cd240de904b31a95749e6eb7bb',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47215,
                      'bindings_sha256': '1698da63432d731c1ccc43680b5ed06c028e66cd240de904b31a95749e6eb7bb',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47215,
                      'bindings_sha256': '1698da63432d731c1ccc43680b5ed06c028e66cd240de904b31a95749e6eb7bb',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 3,
            'selfcheck': True,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47218,
                      'bindings_sha256': 'd75964c5377fdc3aef42954c5583e1149799eb878741204fd0602309700fe1cf',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 1,
                      'last_reused': 0}},
           {'bound': 6,
            'selfcheck': False,
            'round': {'admitted': 2,
                      'bound': 6,
                      'score_sum': 2.0,
                      'bindings': 47224,
                      'bindings_sha256': '3bd26d8934ba461d91666eab1b025e27cd93f62cfe28165c174c8a1c49a77aa0',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 2},
                      'events_by_reason': {'GangAdmitted': 2, 'PodBound': 6}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 2,
                      'last_reused': 0}},
           {'bound': 3,
            'selfcheck': False,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47227,
                      'bindings_sha256': '39ebb57144c94df3379e1b5ae0d8906bf9c1c6b34ceb0877e95e300431c85351',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 1,
                      'last_reused': 0}},
           {'bound': 3,
            'selfcheck': False,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47230,
                      'bindings_sha256': 'd6e45ac9ce6e673959d95f56731051782ed885c175baec639ebb094bcc5b9d7b',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 1,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47227,
                      'bindings_sha256': '5449f246d8edc0a1eae516d0d7ebdfb463b59c06c65eff82f135826c2aa5d3a4',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47224,
                      'bindings_sha256': '248cc3abe14f33ff686c5bb22c640171af8528de93ce5bca58720709bf8d1313',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47224,
                      'bindings_sha256': '248cc3abe14f33ff686c5bb22c640171af8528de93ce5bca58720709bf8d1313',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47221,
                      'bindings_sha256': 'c2403696037f05dcefa3d4c52718e3e885f665c677084435aed22a2f64e16f4e',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 3,
            'selfcheck': False,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47224,
                      'bindings_sha256': '5e48eecf7daecf363d944476c97ee87f643fdb8ca08aff60f916ac4b821e768f',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 1,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47221,
                      'bindings_sha256': '49000df971781fa64ad18619c7aaa051ce6c6bc843c0ecd2953893aa8c334996',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 3,
            'selfcheck': False,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47224,
                      'bindings_sha256': 'd9160d602c63ab30a5c41f6d5666093b2264a219ad2bddd186bbe6e587cdd784',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 1,
                      'last_reused': 0}},
           {'bound': 6,
            'selfcheck': False,
            'round': {'admitted': 2,
                      'bound': 6,
                      'score_sum': 2.0,
                      'bindings': 47230,
                      'bindings_sha256': 'b93203bcdc5679581e83af4af9db76b1f7dae772e5f49f9f267a3a3ea0489441',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 2},
                      'events_by_reason': {'GangAdmitted': 2, 'PodBound': 6}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 2,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47230,
                      'bindings_sha256': 'b93203bcdc5679581e83af4af9db76b1f7dae772e5f49f9f267a3a3ea0489441',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 6,
            'selfcheck': False,
            'round': {'admitted': 2,
                      'bound': 6,
                      'score_sum': 2.0,
                      'bindings': 47236,
                      'bindings_sha256': '72cd74cae089cd45bad5709fe4cca701a45eb4fb6731bb6119f6a3d446dcb46c',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 2},
                      'events_by_reason': {'GangAdmitted': 2, 'PodBound': 6}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 2,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47236,
                      'bindings_sha256': '72cd74cae089cd45bad5709fe4cca701a45eb4fb6731bb6119f6a3d446dcb46c',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 3,
            'selfcheck': False,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47239,
                      'bindings_sha256': 'cc38556bba368f9ef28dbbb2039282eeab8ac64e9ab6a0bc469ec18e89b10489',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 2,
                      'drift_detected': 0,
                      'last_reencoded': 1,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': True,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47239,
                      'bindings_sha256': 'cc38556bba368f9ef28dbbb2039282eeab8ac64e9ab6a0bc469ec18e89b10489',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': {'warm_start_hits': 0,
                      'solve_reuses': 0,
                      'full_fallbacks': 3,
                      'drift_detected': 0,
                      'last_reencoded': 0,
                      'last_reused': 0}},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47239,
                      'bindings_sha256': 'cc38556bba368f9ef28dbbb2039282eeab8ac64e9ab6a0bc469ec18e89b10489',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': None},
           {'bound': 3,
            'selfcheck': False,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47242,
                      'bindings_sha256': 'fdf53c6adc036b4817c90fd1b4d55cd5c0af68b170e6ac40d72386a11204089e',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': None},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47242,
                      'bindings_sha256': 'fdf53c6adc036b4817c90fd1b4d55cd5c0af68b170e6ac40d72386a11204089e',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': None},
           {'bound': 6,
            'selfcheck': False,
            'round': {'admitted': 2,
                      'bound': 6,
                      'score_sum': 2.0,
                      'bindings': 47248,
                      'bindings_sha256': 'e86b9aa61a4976e55cb91c02d9fc881574c6348cea2bd3253c9e5b8c5d121cb0',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 2},
                      'events_by_reason': {'GangAdmitted': 2, 'PodBound': 6}},
            'delta': None},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47248,
                      'bindings_sha256': 'e86b9aa61a4976e55cb91c02d9fc881574c6348cea2bd3253c9e5b8c5d121cb0',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': None},
           {'bound': 3,
            'selfcheck': False,
            'round': {'admitted': 1,
                      'bound': 3,
                      'score_sum': 1.0,
                      'bindings': 47251,
                      'bindings_sha256': 'fa4c8808cd0562c6621f4b7f56875baeb1f459240fca8c4d96a0e1ccd4624408',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {'default': 1},
                      'events_by_reason': {'GangAdmitted': 1, 'PodBound': 3}},
            'delta': None},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47251,
                      'bindings_sha256': 'fa4c8808cd0562c6621f4b7f56875baeb1f459240fca8c4d96a0e1ccd4624408',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': None},
           {'bound': 0,
            'selfcheck': False,
            'round': {'admitted': 0,
                      'bound': 0,
                      'score_sum': 0.0,
                      'bindings': 47251,
                      'bindings_sha256': 'fa4c8808cd0562c6621f4b7f56875baeb1f459240fca8c4d96a0e1ccd4624408',
                      'evicted': 0,
                      'evicted_sha256': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
                      'admitted_per_queue': {},
                      'events_by_reason': {}},
            'delta': None}],
 'report': {'ticks': 33,
            'seed': 8,
            'ops': {'arrivals': 22, 'departures': 9, 'pod_fails': 4, 'flaps': 1},
            'spec_encodes': 22,
            'reencode_fraction': 1.0,
            'warm_start_hit_rate': 0.0,
            'warm_start_hits': 0,
            'solve_reuses': 0,
            'full_fallbacks': 1,
            'drift_detected': 0,
            'ab_ticks': 3,
            'ab_ok': True},
 'world': {'n_sets': 10240, 'n_nodes': 5120, 'update_every': 16, 'ticks': 33, 'fullpath_ticks': 8}}


def phase_churn(harness, card, device="cuda", ticks=CHURN_SMOKE_TICKS,
                fullpath_ticks=CHURN_SMOKE_FULLPATH_TICKS, reference=None) -> dict:
    """[churn] (kappa): the port's sim/deltachurn.delta_artifact on (iota)'s
    harness after [operator]'s converge and rolling update
    (models/scenarios.run_churn_world): warm-up, `ticks` churn ticks with
    the A/B self-check every 16th, `fullpath_ticks` ticks with the delta
    state detached. Every schedule call (round_summary, the delta counters,
    the self-check flag) and the report's counters equal to
    JAX_CHURN_REFERENCE; the fill must launch; the first fill calls and the
    first of each other shape held against the plain fill bit for bit.
    Run from [operator]'s `then`, so it sees the converged harness."""
    from grove_tpu_torch.models.scenarios import port_names, run_churn_world
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda

    ref = JAX_CHURN_REFERENCE if reference is None else reference
    want_world = ref["world"]
    if (want_world["ticks"], want_world["fullpath_ticks"]) != (ticks, fullpath_ticks):
        _fail(f"churn: the reference was taken at {want_world['ticks']} and"
              f" {want_world['fullpath_ticks']} ticks, the phase runs {ticks} and {fullpath_ticks}")
    walls = []

    def after_tick(index, wall_s, tick):
        tag = f"churn tick {index}"
        if index > len(ref["ticks"]):
            _fail(f"{tag}: the JAX run made {len(ref['ticks'])} schedule calls")
        _check_round(tag, tick, ref["ticks"][index - 1])
        walls.append(wall_s)
        if index % 8 == 0 or tick["selfcheck"] or index == len(ref["ticks"]):
            print(f"[churn] tick {index}: schedule {wall_s:.3f} s, bound {tick['bound']},"
                  f" self-check {tick['selfcheck']}, events {tick['round']['events_by_reason']};"
                  f" equal to the JAX package's", flush=True)

    pkg = port_names(device)
    fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0
    t0 = time.perf_counter()
    with _RecordedKernelFills(CHURN_FILL_CALLS) as recorded:
        got = run_churn_world(pkg, harness, ticks=ticks, fullpath_ticks=fullpath_ticks,
                              after_tick=after_tick)
    phase_s = time.perf_counter() - t0
    launches = {"fill": fill_batch.launches, "drf_shares": share_table_cuda.launches,
                "drf_merge": merge_cuda.launches}
    if len(got["ticks"]) != len(ref["ticks"]):
        _fail(f"churn: {len(got['ticks'])} schedule calls, the JAX run {len(ref['ticks'])}")
    _check_same("churn report", got["report"], ref["report"])
    if got["report"]["drift_detected"] or not got["report"]["ab_ok"]:
        _fail(f"churn: drift or a failed A/B: {got['report']}")
    if device != "cpu" and not launches["fill"]:
        _fail(f"churn: the fill kernel did not launch: {launches}")
    fill_err = check_recorded_fills(recorded, "churn", device)
    times = got["times"]
    out = {
        "ticks": ticks, "fullpath_ticks": fullpath_ticks, "schedule_calls": len(got["ticks"]),
        "phase_s": phase_s,
        "schedule_p50_ms": times["schedule_p50_ms"], "schedule_p99_ms": times["schedule_p99_ms"],
        "schedule_mean_ms": times["schedule_mean_ms"], "schedule_max_ms": times["schedule_max_ms"],
        "full_path": times["full_path"], "speedup_mean": times["speedup_mean"],
        "p99_lt_1s": times["p99_lt_1s"], "ab_overhead_ms": times["ab_overhead_ms"],
        "warmup_ms": times["warmup"]["wall_ms"], "report": got["report"],
        **{f"{k}_launches": v for k, v in launches.items()},
        "fill_calls_checked": len(recorded.calls), "fill_max_abs_err": fill_err,
    }
    fp = times["full_path"]
    print(f"[churn] (kappa) delta_artifact on (iota): {ticks} churn ticks and {fullpath_ticks}"
          f" full-path ticks, {len(got['ticks'])} schedule calls, every one and the counters"
          f" {got['report']} equal to the JAX package's; schedule p50"
          f" {times['schedule_p50_ms']} ms, p99 {times['schedule_p99_ms']} ms, mean"
          f" {times['schedule_mean_ms']} ms (p99_lt_1s {times['p99_lt_1s']}); full path p50"
          f" {fp['schedule_p50_ms']} ms, p99 {fp['schedule_p99_ms']} ms, mean"
          f" {fp['schedule_mean_ms']} ms; speedup_mean {times['speedup_mean']}; A/B self-check"
          f" {times['ab_overhead_ms']} ms; launches fill {launches['fill']}, DRF"
          f" {launches['drf_shares']} + {launches['drf_merge']}; {len(recorded.calls)} fill"
          f" calls equal to the plain fill bit for bit | {card}", flush=True)
    print(f"[smoke] phase_churn: {phase_s:.1f} s (inside phase_operator)", flush=True)
    return out


SCALE_FILL_CALLS = 2  # per solve kind ([scale] holds them against the plain fill)
# scripts/scheduler_reference.py scale (PYTHONHASHSEED=0)
JAX_SCALE_REFERENCE = {'world': {'frontier_shape': [4096, 6400], 'inert_shape': [192, 64], 'shards': 8},
 'frontier_arms': [{'shards': 1,
                    'pods': 128,
                    'all_ready': True,
                    'resource_version': 1057,
                    'shard_census': [{'shard': 0, 'objects': 417, 'rv': 1057}],
                    'reconciles': 240,
                    'dump': {'objects': 257,
                             'sha256': '36cc549383af1081fc743b8789351f41bf4b7ee7da2b53038306cc8c85094a47',
                             'score_sum': 48.0},
                    'frontier': None},
                   {'shards': 1,
                    'pods': 128,
                    'all_ready': True,
                    'resource_version': 1057,
                    'shard_census': [{'shard': 0, 'objects': 417, 'rv': 1057}],
                    'reconciles': 240,
                    'dump': {'objects': 257,
                             'sha256': 'ee8939197e01b4e0dd5aad5b6e3b72a9da12e45c4d59874c4b3e71cb7cd0aab8',
                             'score_sum': 48.0},
                    'frontier': {'solves': 1,
                                 'degenerate_ticks': 0,
                                 'subproblems_total': 16,
                                 'assigned_gangs_total': 16,
                                 'residual_gangs_total': 0,
                                 'batched_dispatches_total': 1,
                                 'residual_overlap_hits': 0,
                                 'residual_overlap_misses': 0}},
                   {'shards': 8,
                    'pods': 32768,
                    'all_ready': True,
                    'resource_version': 270337,
                    'shard_census': [{'shard': 0, 'objects': 9217, 'rv': 32257},
                                     {'shard': 1, 'objects': 8192, 'rv': 28672},
                                     {'shard': 2, 'objects': 8192, 'rv': 28672},
                                     {'shard': 3, 'objects': 7168, 'rv': 25088},
                                     {'shard': 4, 'objects': 8192, 'rv': 28672},
                                     {'shard': 5, 'objects': 7168, 'rv': 25088},
                                     {'shard': 6, 'objects': 9216, 'rv': 32256},
                                     {'shard': 7, 'objects': 9192, 'rv': 69632}],
                    'reconciles': 61440,
                    'dump': {'objects': 65537,
                             'sha256': '076f3446010b6a31841bff6e25a7b53184f1beba2064ed95810c5c075c433a67',
                             'score_sum': 12288.0},
                    'frontier': None},
                   {'shards': 8,
                    'pods': 32768,
                    'all_ready': True,
                    'resource_version': 270337,
                    'shard_census': [{'shard': 0, 'objects': 9217, 'rv': 32257},
                                     {'shard': 1, 'objects': 8192, 'rv': 28672},
                                     {'shard': 2, 'objects': 8192, 'rv': 28672},
                                     {'shard': 3, 'objects': 7168, 'rv': 25088},
                                     {'shard': 4, 'objects': 8192, 'rv': 28672},
                                     {'shard': 5, 'objects': 7168, 'rv': 25088},
                                     {'shard': 6, 'objects': 9216, 'rv': 32256},
                                     {'shard': 7, 'objects': 9192, 'rv': 69632}],
                    'reconciles': 61440,
                    'dump': {'objects': 65537,
                             'sha256': '66c5b52afea15fb8c677a6f010b18fd8d6a78c08d26f4e538381851d2cccf15a',
                             'score_sum': 12288.0},
                    'frontier': {'solves': 1,
                                 'degenerate_ticks': 0,
                                 'subproblems_total': 400,
                                 'assigned_gangs_total': 4096,
                                 'residual_gangs_total': 0,
                                 'batched_dispatches_total': 1,
                                 'residual_overlap_hits': 0,
                                 'residual_overlap_misses': 0}}],
 'frontier_ab': {'sets': 4096, 'nodes': 6400, 'all_ready_both': True},
 'spread_problems': [],
 'inert_arms': [{'shards': 1,
                 'pods': 128,
                 'all_ready': True,
                 'resource_version': 1057,
                 'shard_census': [{'shard': 0, 'objects': 417, 'rv': 1057}],
                 'reconciles': 240,
                 'dump': {'objects': 257,
                          'sha256': '92601567e078fbfa5522d9263719c10df0cc26ecf62b8f06192e452a8e44dd75',
                          'score_sum': 48.0},
                 'frontier': None},
                {'shards': 1,
                 'pods': 1536,
                 'all_ready': True,
                 'resource_version': 12673,
                 'shard_census': [{'shard': 0, 'objects': 4073, 'rv': 12673}],
                 'reconciles': 5760,
                 'dump': {'objects': 3073,
                          'sha256': '7ba3f83d3bb4b4782b2d095b086d95d50aa0924443a489589065468cc4ee477a',
                          'score_sum': 576.0},
                 'frontier': None},
                {'shards': 8,
                 'pods': 1536,
                 'all_ready': True,
                 'resource_version': 12673,
                 'shard_census': [{'shard': 0, 'objects': 433, 'rv': 1513},
                                  {'shard': 1, 'objects': 384, 'rv': 1344},
                                  {'shard': 2, 'objects': 384, 'rv': 1344},
                                  {'shard': 3, 'objects': 336, 'rv': 1176},
                                  {'shard': 4, 'objects': 384, 'rv': 1344},
                                  {'shard': 5, 'objects': 336, 'rv': 1176},
                                  {'shard': 6, 'objects': 432, 'rv': 1512},
                                  {'shard': 7, 'objects': 1384, 'rv': 3264}],
                 'reconciles': 0,
                 'dump': {'objects': 3073,
                          'sha256': '7ba3f83d3bb4b4782b2d095b086d95d50aa0924443a489589065468cc4ee477a',
                          'score_sum': 576.0},
                 'frontier': None}],
 'inert_ab': {'sets': 192,
              'shards_b': 8,
              'identical_content': True,
              'objects': 3073,
              'reconciles_s1': 2880,
              'reconciles_sharded': 2880,
              'identical_reconciles': True,
              'all_ready_both': True,
              'rv_scalar_s1': 12673,
              'rv_scalar_sharded': 12673,
              'identical_rv_scalar': True}}


def phase_scale(card, device="cuda", frontier_shape=None, inert_shape=None, num_shards=None,
                reference=None, parallel_reference=None, parts=None) -> dict:
    """[scale] (lambda): the port's sim/scale.frontier_ab at the bench's
    full-size shape (4,096 sets on 6,400 nodes, 8 shards) and inert_ab (192
    sets on 64 nodes, S=1 against 8) through models/scenarios.run_scale_world:
    each retired harness (warm-ups and arms) all Ready with the canonical
    dump's digest (rv-normalised, Events left out, placement scores summed
    apart), census, scalar resourceVersion, reconciles and frontier
    counters equal to JAX_SCALE_REFERENCE; the inert A/B identical; the
    sharded arms spread over two or more shards. The fill must launch in
    both arms of the frontier A/B; the first fill calls of each kind
    (global, stacked, residual) and the first of each other shape are held
    against the plain fill. Prints both walls, both solver times and the
    speedups (reported, not gated)."""
    from grove_tpu_torch.models.scenarios import (
        SCALE_FRONTIER_SHAPE, SCALE_INERT_SHAPE, SCALE_SHARDS, port_names, run_scale_world)
    from grove_tpu_torch.ops.fill import fill_batch

    ref = JAX_SCALE_REFERENCE if reference is None else reference
    frontier_shape = frontier_shape or SCALE_FRONTIER_SHAPE
    inert_shape = inert_shape or SCALE_INERT_SHAPE
    num_shards = num_shards or SCALE_SHARDS
    pkg = port_names(device)
    fill_batch.launches = 0
    with _RecordedKernelFills(SCALE_FILL_CALLS) as recorded:
        got = run_scale_world(pkg, frontier_shape, inert_shape, num_shards, device=device)
    launches = fill_batch.launches
    times = got.pop("times")
    _check_same("scale world", got["world"], ref["world"])
    for part in ("frontier_arms", "inert_arms"):
        if len(got[part]) != len(ref[part]):
            _fail(f"scale {part}: {len(got[part])} harnesses, the JAX run {len(ref[part])}")
        for i, (g, w) in enumerate(zip(got[part], ref[part])):
            g, w = dict(g), dict(w)
            gd, wd = dict(g.pop("dump")), dict(w.pop("dump"))
            if not np.isclose(gd.pop("score_sum"), wd.pop("score_sum"), rtol=1e-6, atol=0):
                _fail(f"scale {part} {i}: placement score sum differs from the JAX package's")
            _check_same(f"scale {part} {i} dump", gd, wd)
            _check_same(f"scale {part} {i}", g, w)
            if not g["all_ready"]:
                _fail(f"scale {part} {i}: not every pod Ready")
    _check_same("scale frontier_ab", got["frontier_ab"], ref["frontier_ab"])
    _check_same("scale inert_ab", got["inert_ab"], ref["inert_ab"])
    inert = got["inert_ab"]
    if not (inert["identical_content"] and inert["identical_reconciles"]
            and inert["identical_rv_scalar"]):
        _fail(f"scale: the inert A/B differs between S=1 and S={num_shards}: {inert}")
    if got["spread_problems"]:
        _fail(f"scale: {got['spread_problems']}")
    kinds = {}
    for tag, *_ in recorded.calls:
        kinds[tag.split()[0]] = kinds.get(tag.split()[0], 0) + 1
    if device != "cpu":
        for kind in ("global", "stacked"):
            if not kinds.get(kind):
                _fail(f"scale: no {kind} fill launch in the frontier A/B ({kinds})")
    fill_err = check_recorded_fills(recorded, "scale", device)
    on, off = got["frontier_arms"][3], got["frontier_arms"][2]
    ab = times["frontier_ab"]
    if parts is None:  # alone: (pi) and the codec A/B run here, after (lambda)
        pi = phase_scale_parallel(card, device, frontier_shape, num_shards, parallel_reference)
        codec = phase_scale_codec(card, device, parallel_reference)
    else:  # the smoke's main(): their processes ran beside (lambda)
        pi = parts[0].result()["phase_scale_parallel"]
        codec = parts[1].result()["phase_scale_codec"]
    _check_serial_twin(pi["converge"], on)
    print(f"[scale] (pi) against its serial twin, (lambda)'s frontier arm: dump, reconciles"
          f" {on['reconciles']}, rv {on['resource_version']} and pods equal | {card}", flush=True)
    out = {
        "frontier_shape": list(frontier_shape), "inert_shape": list(inert_shape),
        "shards": num_shards, **ab, "frontier_ab_s": times["frontier_ab_s"],
        "inert_ab_s": times["inert_ab_s"], "inert_walls": times["inert_ab"],
        "pods": off["pods"], "reconciles_off": off["reconciles"], "reconciles_on": on["reconciles"],
        "frontier": on["frontier"], "census_on": on["shard_census"],
        "fill_launches": launches + pi["fill_launches"] + codec["fill_launches"],
        "lambda_fill_launches": launches, "pi_fill_launches": pi["fill_launches"],
        "codec_ab_fill_launches": codec["fill_launches"], "fill_calls_by_kind": kinds,
        "fill_calls_checked": len(recorded.calls),
        "fill_max_abs_err": max(fill_err, pi["fill_max_abs_err"]),
        "pi": pi, "process_codec_ab": codec,
    }
    print(f"[scale] (lambda) frontier_ab {frontier_shape[0]} sets on {frontier_shape[1]} nodes,"
          f" {num_shards} shards, {off['pods']} pods each arm, all Ready, every arm's digest,"
          f" census, rv and reconciles equal to the JAX package's: global wall"
          f" {ab['wall_off']} s (solver {ab['solver_off']} s), frontier wall {ab['wall_on']} s"
          f" (solver {ab['solver_on']} s), speedup wall {ab['speedup_wall']}, solver"
          f" {ab['speedup_solver']}; reconciles {off['reconciles']} / {on['reconciles']};"
          f" frontier {on['frontier']}; inert_ab {inert_shape[0]} sets S=1 vs"
          f" S={num_shards} identical (content, reconciles {inert['reconciles_s1']}, rv"
          f" {inert['rv_scalar_s1']}), walls {times['inert_ab']}; fill launches {launches}"
          f" (recorded by kind {kinds}, each equal to the plain fill bit for bit) | {card}",
          flush=True)
    return out


# scripts/scheduler_reference.py durability parallel (PYTHONHASHSEED=0)
JAX_PARALLEL_REFERENCE = {'durability': {'world': {'sets': 4096,
                          'nodes': 6400,
                          'shards': 8,
                          'workers': 4,
                          'backend': 'process',
                          'torn_tail': 53},
                'converge': {'sets': 4096,
                             'nodes': 6400,
                             'shards': 8,
                             'tenants': 64,
                             'pods': 32768,
                             'all_ready': True,
                             'reconciles': 61440,
                             'pod_summary': {'total': 32768, 'ready': 32768},
                             'fold_depth_histogram': [8, 1],
                             'shard_census': [{'shard': 0, 'objects': 9217, 'rv': 32257},
                                              {'shard': 1, 'objects': 8192, 'rv': 28672},
                                              {'shard': 2, 'objects': 8192, 'rv': 28672},
                                              {'shard': 3, 'objects': 7168, 'rv': 25088},
                                              {'shard': 4, 'objects': 8192, 'rv': 28672},
                                              {'shard': 5, 'objects': 7168, 'rv': 25088},
                                              {'shard': 6, 'objects': 9216, 'rv': 32256},
                                              {'shard': 7, 'objects': 12192, 'rv': 69632}],
                             'workers': 4,
                             'parallel': {'backend': 'process',
                                          'workers': 4,
                                          'reconciles_by_worker': [16320, 14400, 16320, 14400],
                                          'worker_crashes': 0,
                                          'boundary_faults': {'drop': 0,
                                                              'dup': 0,
                                                              'delay': 0,
                                                              'retransmits': 0,
                                                              'deduped': 0}},
                             'resource_version': 270337,
                             'dump': {'objects': 65537,
                                      'sha256': '66c5b52afea15fb8c677a6f010b18fd8d6a78c08d26f4e538381851d2cccf15a',
                                      'score_sum': 12288.0},
                             'scheduled_gangs': 4096,
                             'frontier': {'solves': 1,
                                          'degenerate_ticks': 0,
                                          'subproblems_total': 400,
                                          'assigned_gangs_total': 4096,
                                          'residual_gangs_total': 0,
                                          'batched_dispatches_total': 1,
                                          'residual_overlap_hits': 0,
                                          'residual_overlap_misses': 0},
                             'overlap': {'hits': 0, 'stale': 64},
                             'wal': {'0': {'records': 10369,
                                           'durable': {'objects': 9217,
                                                       'sha256': '6f495f9b1f45a6fa0636a525b02239f203a1fbe098de02643d10e0a223a55e08',
                                                       'score_sum': 1728.0},
                                           'tombstones': 0},
                                     '1': {'records': 15360,
                                           'durable': {'objects': 8192,
                                                       'sha256': 'e8f0c666d814dcfe080285d95a2dc1f21f0be3ddf78dab1f8043ee59c9c489dd',
                                                       'score_sum': 1536.0},
                                           'tombstones': 0},
                                     '2': {'records': 15360,
                                           'durable': {'objects': 8192,
                                                       'sha256': 'c8ec91044ba39a3fb741d2f2ddcfd49093d27ee126b3219459cb40f84f86ebef',
                                                       'score_sum': 1536.0},
                                           'tombstones': 0},
                                     '3': {'records': 13440,
                                           'durable': {'objects': 7168,
                                                       'sha256': '617222aea2d836090d69adb35dcb4da7e3426ab5ccacbf87b7f788eecb11552d',
                                                       'score_sum': 1344.0},
                                           'tombstones': 0},
                                     '4': {'records': 9216,
                                           'durable': {'objects': 8192,
                                                       'sha256': '7c8c0305a2f63f2fe9aba03124456fef59b154b5e0c860b91f6baeeec7a03a86',
                                                       'score_sum': 1536.0},
                                           'tombstones': 0},
                                     '5': {'records': 13440,
                                           'durable': {'objects': 7168,
                                                       'sha256': '5552b6c83b023eb71b1bcd37f723aed17386239b132818d04c257b4af4221705',
                                                       'score_sum': 1344.0},
                                           'tombstones': 0},
                                     '6': {'records': 17280,
                                           'durable': {'objects': 9216,
                                                       'sha256': 'f2b86dea7d6b978cddd92953b225ba84933725085b1c1d4f7995008fe54d87dd',
                                                       'score_sum': 1728.0},
                                           'tombstones': 0},
                                     '7': {'records': 15360,
                                           'durable': {'objects': 8192,
                                                       'sha256': '10c26e818120cfeb885c90eded457bbbb2bbebf1b20ff46948325a0439c28e10',
                                                       'score_sum': 1536.0},
                                           'tombstones': 0}}},
                'crash': {'lost_unacked_records': 0,
                          'recovery': {'snapshot_rv': 262145,
                                       'replayed_records': 8192,
                                       'restored_objects': 65537,
                                       'resource_version': 270337,
                                       'torn_tail': True},
                          'reconverge_ticks': 2,
                          'reconverge_reconciles': 8192,
                          'reconverge_parallel': {'backend': 'process',
                                                  'workers': 4,
                                                  'reconciles_by_worker': [2176, 1920, 2176, 1920],
                                                  'worker_crashes': 0,
                                                  'boundary_faults': {'drop': 0,
                                                                      'dup': 0,
                                                                      'delay': 0,
                                                                      'retransmits': 0,
                                                                      'deduped': 0}},
                          'problems': []},
                'process_ab': {'shape': {'sets': 256,
                                         'nodes': 256,
                                         'shards': 4,
                                         'workers': 2,
                                         'backend': 'process'},
                               'reconciles': 3840,
                               'reconciles_identical': True}},
 'parallel': {'ab thread w2 s1234': {'sets': 48,
                                     'shards': 4,
                                     'workers': 2,
                                     'backend': 'thread',
                                     'seed': 1234,
                                     'boundaries_compared': 4,
                                     'reconciles': [[720, 720], [251, 251], [180, 180], [188, 188]],
                                     'identical': True,
                                     'problems': [],
                                     'wal_acked_identical': True,
                                     'worker_stats': {'backend': 'thread',
                                                      'workers': 2,
                                                      'reconciles_by_worker': [673, 666]}},
              'ab thread w2 s7': {'sets': 48,
                                  'shards': 4,
                                  'workers': 2,
                                  'backend': 'thread',
                                  'seed': 7,
                                  'boundaries_compared': 4,
                                  'reconciles': [[720, 720], [216, 216], [152, 152], [184, 184]],
                                  'identical': True,
                                  'problems': [],
                                  'wal_acked_identical': True,
                                  'worker_stats': {'backend': 'thread',
                                                   'workers': 2,
                                                   'reconciles_by_worker': [636, 636]}},
              'ab thread w4 s1234': {'sets': 48,
                                     'shards': 4,
                                     'workers': 4,
                                     'backend': 'thread',
                                     'seed': 1234,
                                     'boundaries_compared': 4,
                                     'reconciles': [[720, 720], [251, 251], [180, 180], [188, 188]],
                                     'identical': True,
                                     'problems': [],
                                     'wal_acked_identical': True,
                                     'worker_stats': {'backend': 'thread',
                                                      'workers': 4,
                                                      'reconciles_by_worker': [391,
                                                                               335,
                                                                               282,
                                                                               331]}},
              'ab thread w4 s7': {'sets': 48,
                                  'shards': 4,
                                  'workers': 4,
                                  'backend': 'thread',
                                  'seed': 7,
                                  'boundaries_compared': 4,
                                  'reconciles': [[720, 720], [216, 216], [152, 152], [184, 184]],
                                  'identical': True,
                                  'problems': [],
                                  'wal_acked_identical': True,
                                  'worker_stats': {'backend': 'thread',
                                                   'workers': 4,
                                                   'reconciles_by_worker': [310, 361, 326, 275]}},
              'ab process w2 s1234': {'sets': 48,
                                      'shards': 4,
                                      'workers': 2,
                                      'backend': 'process',
                                      'seed': 1234,
                                      'boundaries_compared': 4,
                                      'reconciles': [[720, 720],
                                                     [251, 251],
                                                     [180, 180],
                                                     [188, 188]],
                                      'identical': True,
                                      'problems': [],
                                      'wal_acked_identical': True,
                                      'worker_stats': {'backend': 'process',
                                                       'workers': 2,
                                                       'reconciles_by_worker': [673, 666],
                                                       'worker_crashes': 0,
                                                       'boundary_faults': {'drop': 0,
                                                                           'dup': 0,
                                                                           'delay': 0,
                                                                           'retransmits': 0,
                                                                           'deduped': 0}}},
              'ab process w2 s7': {'sets': 48,
                                   'shards': 4,
                                   'workers': 2,
                                   'backend': 'process',
                                   'seed': 7,
                                   'boundaries_compared': 4,
                                   'reconciles': [[720, 720], [216, 216], [152, 152], [184, 184]],
                                   'identical': True,
                                   'problems': [],
                                   'wal_acked_identical': True,
                                   'worker_stats': {'backend': 'process',
                                                    'workers': 2,
                                                    'reconciles_by_worker': [636, 636],
                                                    'worker_crashes': 0,
                                                    'boundary_faults': {'drop': 0,
                                                                        'dup': 0,
                                                                        'delay': 0,
                                                                        'retransmits': 0,
                                                                        'deduped': 0}}},
              'ab process w4 s1234': {'sets': 48,
                                      'shards': 4,
                                      'workers': 4,
                                      'backend': 'process',
                                      'seed': 1234,
                                      'boundaries_compared': 4,
                                      'reconciles': [[720, 720],
                                                     [251, 251],
                                                     [180, 180],
                                                     [188, 188]],
                                      'identical': True,
                                      'problems': [],
                                      'wal_acked_identical': True,
                                      'worker_stats': {'backend': 'process',
                                                       'workers': 4,
                                                       'reconciles_by_worker': [391, 335, 282, 331],
                                                       'worker_crashes': 0,
                                                       'boundary_faults': {'drop': 0,
                                                                           'dup': 0,
                                                                           'delay': 0,
                                                                           'retransmits': 0,
                                                                           'deduped': 0}}},
              'ab process w4 s7': {'sets': 48,
                                   'shards': 4,
                                   'workers': 4,
                                   'backend': 'process',
                                   'seed': 7,
                                   'boundaries_compared': 4,
                                   'reconciles': [[720, 720], [216, 216], [152, 152], [184, 184]],
                                   'identical': True,
                                   'problems': [],
                                   'wal_acked_identical': True,
                                   'worker_stats': {'backend': 'process',
                                                    'workers': 4,
                                                    'reconciles_by_worker': [310, 361, 326, 275],
                                                    'worker_crashes': 0,
                                                    'boundary_faults': {'drop': 0,
                                                                        'dup': 0,
                                                                        'delay': 0,
                                                                        'retransmits': 0,
                                                                        'deduped': 0}}},
              'worker_crash': {'identical': True,
                               'reconciles': [120, 120],
                               'dump': {'objects': 129,
                                        'sha256': '70afbe3d029715129db61da534fa5a3499b52d4c721010ad3a1026531f4f99a9',
                                        'score_sum': 24.0},
                               'worker_stats': {'backend': 'process',
                                                'workers': 2,
                                                'reconciles_by_worker': [108, 12],
                                                'worker_crashes': 1,
                                                'boundary_faults': {'drop': 0,
                                                                    'dup': 0,
                                                                    'delay': 0,
                                                                    'retransmits': 0,
                                                                    'deduped': 0}},
                               'crashes_total': 1},
              'boundary_faults': {'identical': True,
                                  'reconciles': [720, 720],
                                  'dump': {'objects': 769,
                                           'sha256': 'cf1c8dc19eb9c51fab2a4fbd8435e7f3573519c1e08eac5a60932abcdca5a36b',
                                           'score_sum': 144.0},
                                  'worker_stats': {'backend': 'process',
                                                   'workers': 2,
                                                   'reconciles_by_worker': [360, 360],
                                                   'worker_crashes': 0,
                                                   'boundary_faults': {'drop': 3,
                                                                       'dup': 4,
                                                                       'delay': 0,
                                                                       'retransmits': 4,
                                                                       'deduped': 3}},
                                  'crashes_total': 0},
              'sweep thread': {'sets': 192,
                               'nodes': 64,
                               'shards': 8,
                               'backend': 'thread',
                               'sweep': [{'workers': 1,
                                          'effective_workers': 1,
                                          'reconciles': 2880,
                                          'all_ready': True},
                                         {'workers': 2,
                                          'effective_workers': 2,
                                          'reconciles': 2880,
                                          'all_ready': True},
                                         {'workers': 4,
                                          'effective_workers': 4,
                                          'reconciles': 2880,
                                          'all_ready': True},
                                         {'workers': 8,
                                          'effective_workers': 8,
                                          'reconciles': 2880,
                                          'all_ready': True}]},
              'sweep process': {'sets': 192,
                                'nodes': 64,
                                'shards': 8,
                                'backend': 'process',
                                'sweep': [{'workers': 1,
                                           'effective_workers': 1,
                                           'reconciles': 2880,
                                           'all_ready': True},
                                          {'workers': 2,
                                           'effective_workers': 2,
                                           'reconciles': 2880,
                                           'all_ready': True},
                                          {'workers': 4,
                                           'effective_workers': 4,
                                           'reconciles': 2880,
                                           'all_ready': True},
                                          {'workers': 8,
                                           'effective_workers': 8,
                                           'reconciles': 2880,
                                           'all_ready': True}]},
              'durability': {'inert_ab_identical': True,
                             'wal_records': 2689,
                             'wal_snapshots': 0,
                             'replayed_records': 1344,
                             'torn_tail_truncated': True,
                             'recovery_ok': True}}}


def _check_serial_twin(conv, twin) -> None:
    """(pi)'s converge against its serial twin, (lambda)'s frontier arm (the
    same population on a serial drain): reconciles, scalar rv, pods and the
    canonical dump (admissions included)."""
    for key in ("reconciles", "resource_version", "pods"):
        if conv[key] != twin[key]:
            _fail(f"scale (pi): {key} {conv[key]} differs from its serial twin's ({twin[key]})")
    _check_scored("scale (pi) dump against its serial twin", conv["dump"], twin["dump"])


def phase_scale_parallel(card, device="cuda", frontier_shape=None, num_shards=None,
                         reference=None) -> dict:
    """[scale]'s (pi) part: models/scenarios.run_parallel_world at (lambda)'s
    frontier shape, held to JAX_PARALLEL_REFERENCE["durability"] (the crash's
    problems empty, 0 repatriations); the first fill calls of (pi) against
    the plain fill. phase_scale holds the converge to its serial twin.
    Returns JSON-ready records."""
    from grove_tpu_torch.models.scenarios import (
        SCALE_FRONTIER_SHAPE, SCALE_SHARDS, port_names, run_parallel_world)
    from grove_tpu_torch.ops.fill import fill_batch

    ref = (JAX_PARALLEL_REFERENCE if reference is None else reference)["durability"]
    frontier_shape = frontier_shape or SCALE_FRONTIER_SHAPE
    num_shards = num_shards or SCALE_SHARDS
    t_part = time.perf_counter()
    fill_batch.launches = 0
    with tempfile.TemporaryDirectory(prefix="grove-pi-") as wal_dir, \
            _RecordedKernelFills(SCALE_FILL_CALLS) as recorded:
        got = run_parallel_world(port_names(device), wal_dir, frontier_shape[0],
                                 frontier_shape[1], num_shards, device=device)
    launches = fill_batch.launches
    times = got.pop("times")
    crash = got["crash"]
    if crash["problems"]:
        _fail(f"scale (pi): {crash['problems']}")
    conv = got["converge"]
    for tag, stats in (("converge", conv["parallel"]), ("cold restart",
                                                       crash["reconverge_parallel"])):
        if stats.get("backend") != "process" or stats.get("worker_crashes") != 0:
            _fail(f"scale (pi) {tag}: the process drain repatriated or did not run: {stats}")
    if not conv["all_ready"]:
        _fail("scale (pi): not every pod Ready")
    _check_scored("scale (pi)", got, {k: v for k, v in ref.items() if k != "process_ab"})
    fill_err = check_recorded_fills(recorded, "scale (pi)", device)
    rep = times["report"]
    wal = conv["wal"]
    print(f"[scale] (pi) {frontier_shape[0]} sets on {frontier_shape[1]} nodes, {num_shards}"
          f" shards, {conv['workers']} process workers, per-shard WAL: converge"
          f" {times['converge_s']:.1f} s (wall {rep['wall_seconds']} s, solver"
          f" {rep['solver_seconds']} s, {rep['us_per_reconcile']} us a reconcile), reconciles"
          f" by worker {conv['parallel']['reconciles_by_worker']}, busy shares"
          f" {times['parallel'].get('utilization')}, boundary bytes"
          f" {times['parallel'].get('boundary_bytes')}, overlap hits {conv['overlap']['hits']}"
          f" / stale {conv['overlap']['stale']}, WAL records"
          f" {sum(w['records'] for w in wal.values())} over {len(wal)} streams; equal to the"
          f" JAX run (dump, reconciles {conv['reconciles']}, rv {conv['resource_version']});"
          f" crash lost {crash['lost_unacked_records']}, replayed"
          f" {crash['recovery']['replayed_records']} records and restored"
          f" {crash['recovery']['restored_objects']} objects in"
          f" {times['recovery']['wall_seconds']} s ({times['recovery']['replay_records_per_sec']}"
          f" records/s), audit clean, recovered dump equal, cold restart reconverged in"
          f" {times['reconverge_s']:.2f} s ({crash['reconverge_ticks']} ticks, reconciles"
          f" {crash['reconverge_reconciles']}), repatriations 0; fill launches {launches}"
          f" | {card}", flush=True)
    got["times"] = times
    got["fill_launches"] = launches
    got["fill_max_abs_err"] = fill_err
    got["wall_s"] = time.perf_counter() - t_part
    return got


def phase_scale_codec(card, device="cuda", reference=None) -> dict:
    """[scale]'s codec A/B: sim/parallel.process_codec_ab at its own shape
    (256 sets, 256 nodes, 4 shards, 2 process workers), its reconciles held
    to JAX_PARALLEL_REFERENCE["durability"]["process_ab"]; prints both arms'
    us a reconcile and the host block."""
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.sim.parallel import process_codec_ab

    ref = (JAX_PARALLEL_REFERENCE if reference is None else reference)["durability"]
    fill_batch.launches = 0
    t0 = time.perf_counter()
    codec = process_codec_ab(device=device)
    codec_s = time.perf_counter() - t0
    codec_launches = fill_batch.launches
    _check_same("scale process_codec_ab", {"shape": codec["shape"],
                                           "reconciles": codec["on"]["reconciles"],
                                           "reconciles_identical": codec["reconciles_identical"]},
                ref["process_ab"])
    print(f"[scale] process_codec_ab {codec['shape']}: reconciles {codec['on']['reconciles']}"
          f" both arms (equal to the JAX package's); us a reconcile off"
          f" {codec['off']['us_per_reconcile']} / on {codec['on']['us_per_reconcile']}"
          f" ({codec['us_per_reconcile_reduction_pct']} %), boundary bytes"
          f" {codec['off']['boundary_bytes']} / {codec['on']['boundary_bytes']}, host"
          f" {json.dumps(codec['host'])}; {codec_s:.1f} s, fill launches {codec_launches}"
          f" | {card}", flush=True)
    return {**codec, "wall_s": codec_s, "fill_launches": codec_launches}


# how long main() waits for a phase in its own process beyond its own work
PHASE_PROCESS_TIMEOUT_S = 900.0
# the scheduling priority the [parallel] process lowers itself by (os.nice)
PARALLEL_NICE = 10


class _PhaseProcess:
    """One phase in a python process of its own, started now beside this
    one's (its own CUDA context on the same card; its lines go to this
    process's output): ``phases`` maps each phase function's name, called in
    turn with ``card``, to its keyword arguments (JSON). The process prints
    each phase's wall as a ``[smoke]`` line. The results come back as one
    JSON object by function name, through a file. The process is started
    with fork and exec, so it inherits no thread of this one; with ``nice``
    > 0 it lowers its own scheduling priority first (its workers inherit
    it), so a process whose work has slack yields the cores to the one that
    sets the phase's wall."""

    def __init__(self, card: str, phases: dict, nice: int = 0) -> None:
        import subprocess

        fd, self.path = tempfile.mkstemp(prefix="grove-phases-", suffix=".json")
        os.close(fd)
        self.name = "+".join(phases)
        self._result = None
        code = ("import json, os, sys, time, chip_smoke as c; os.nice(int(sys.argv[4]))\n"
                "r = {}\n"
                "for n, kw in json.loads(sys.argv[2]).items():\n"
                "    t0 = time.perf_counter()\n"
                "    r[n] = getattr(c, n)(sys.argv[1], **kw)\n"
                "    print(f'[smoke] {n}: {time.perf_counter() - t0:.1f} s in its own process',"
                " flush=True)\n"
                "json.dump(r, open(sys.argv[3], 'w'), default=str)")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code, card, json.dumps(phases), self.path, str(nice)],
            cwd=os.path.dirname(os.path.abspath(__file__)))

    def result(self, timeout: float = PHASE_PROCESS_TIMEOUT_S) -> dict:
        """The phases' results (waits for the process the first time)."""
        import subprocess

        if self._result is not None:
            return self._result
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            _fail(f"[{self.name}] did not end within {timeout:.0f} s")
        try:
            if rc != 0:
                _fail(f"[{self.name}] failed in its process (exit {rc}; its error is above)")
            with open(self.path) as f:
                self._result = json.load(f)
        finally:
            os.unlink(self.path)
        return self._result

    def kill(self) -> None:
        """Kills the process and every process it started (rank worlds,
        workers, phase processes of its own) that is still running."""
        if self.proc.poll() is None:
            tree = _descendants(self.proc.pid)
            self.proc.kill()
            self.proc.wait()
            for pid in tree:
                with contextlib.suppress(OSError):
                    os.kill(pid, 9)  # SIGKILL


def _descendants(pid: int) -> list:
    """The pids of every live descendant of ``pid`` (Linux /proc)."""
    out, todo = [], [pid]
    while todo:
        parent = todo.pop()
        with contextlib.suppress(OSError):
            for task in os.listdir(f"/proc/{parent}/task"):
                with contextlib.suppress(OSError), open(
                        f"/proc/{parent}/task/{task}/children") as f:
                    kids = [int(k) for k in f.read().split()]
                    out += kids
                    todo += kids
    return out


PARALLEL_FILL_CALLS = 2  # per solve kind ([parallel] holds them against the plain fill)
# worker_sweep's counts in [parallel]: (1, 4), cut from the JAX package's
# (1, 2, 4, 8) to keep the smoke's phases near 1,000 s (PERF.md section 4)
PARALLEL_SMOKE_SWEEP = (1, 4)


def phase_parallel(card, device="cuda", reference=None, sweep_counts=None) -> dict:
    """[parallel]: models/scenarios.run_parallel_suite at the JAX package's
    own shapes, every step's report less its times equal to
    JAX_PARALLEL_REFERENCE["parallel"] (the sweeps' rows of the counts run),
    nothing missing (parallel_missing); the fill must launch and its first
    calls equal the plain fill."""
    from grove_tpu_torch.models.scenarios import (
        parallel_missing, port_names, run_parallel_suite)
    from grove_tpu_torch.ops.fill import fill_batch

    ref = (JAX_PARALLEL_REFERENCE if reference is None else reference)["parallel"]
    counts = tuple(sweep_counts or PARALLEL_SMOKE_SWEEP)
    steps, seen = {}, [0]
    t_phase = time.perf_counter()

    def want(name):
        w = ref[name]
        if name.startswith("sweep "):
            w = {**w, "sweep": [r for r in w["sweep"] if r["workers"] in counts]}
        return w

    def after(name, wall_s, result):
        _check_scored(f"parallel {name}", result, want(name))
        fill = fill_batch.launches - seen[0]
        seen[0] = fill_batch.launches
        steps[name] = {"wall_s": wall_s, "fill_launches": fill}
        print(f"[parallel] {name}: {wall_s:.3f} s, equal to the JAX package's; fill launches"
              f" {fill}", flush=True)

    fill_batch.launches = 0
    with tempfile.TemporaryDirectory(prefix="grove-par-") as tmp, \
            _RecordedKernelFills(PARALLEL_FILL_CALLS) as recorded:
        got = run_parallel_suite(port_names(device), tmp, device=device, sweep_counts=counts,
                                 after=after)
    launches = fill_batch.launches
    times = got.pop("times")
    missing = parallel_missing(got)
    if missing:
        _fail(f"parallel: {missing}")
    if set(got) != set(ref):
        _fail(f"parallel: steps {sorted(set(got) ^ set(ref))} differ from the JAX run's")
    if device != "cpu" and not launches:
        _fail("parallel: the fill kernel did not launch")
    fill_err = check_recorded_fills(recorded, "parallel", device)
    sweeps = {b: [{**row, **timed} for row, timed in zip(got[f"sweep {b}"]["sweep"],
                                                       times[f"sweep {b}"]["rows"])]
              for b in ("thread", "process")}
    for b, rows in sweeps.items():
        print(f"[parallel] worker_sweep {b}: " + "; ".join(
            f"{r['workers']} workers {r['us_per_reconcile']} us a reconcile (speedup"
            f" {r['speedup']}, busy {r['utilization']})" for r in rows), flush=True)
    dur = {**got["durability"], **times["durability"]}
    print(f"[parallel] durability_artifact {dur}", flush=True)
    print(f"[parallel] {len(steps)} runs equal to the JAX package's, every serial twin"
          f" identical, 0 repatriations but the killed worker's; fill launches {launches}"
          f" | {card}", flush=True)
    return {"steps": steps, "times": times, "sweeps": sweeps, "durability": dur,
            "fill_launches": launches, "fill_calls_checked": len(recorded.calls),
            "fill_max_abs_err": fill_err, "wall_s": time.perf_counter() - t_phase}


# scripts/scheduler_reference.py sims (PYTHONHASHSEED=0)
JAX_SIMS_REFERENCE = {'contended': {'tenants': {'team-a': {'deserved_gangs': 6.0,
                                      'achieved_gangs': 6,
                                      'dominant_share': 1.0,
                                      'within_one_gang': True},
                           'team-b': {'deserved_gangs': 4.0,
                                      'achieved_gangs': 4,
                                      'dominant_share': 1.0,
                                      'within_one_gang': True},
                           'team-c': {'deserved_gangs': 2.0,
                                      'achieved_gangs': 2,
                                      'dominant_share': 1.0,
                                      'within_one_gang': True}},
               'within_one_gang': True,
               'reclaims': 6},
 'single_queue_ab': {'identical_admissions': True, 'admitted_pods': 24},
 'explain': {'refs': {'frag': 'frag-0',
                      'fits': 'capped-1-0',
                      'capped': 'capped-2-0',
                      'bridge': 'bridge-0',
                      'bridge_node': 'node-0',
                      'filler_queue': 'tenant-z'},
             'docs': {'explain frag': {'sha256': '1aa084fbf39aa230c744b99359e0b4a204246f13b78ae3ec5fe7181876966803',
                                       'state': 'pending',
                                       'fits_now': False,
                                       'binding_constraint': 'topology',
                                       'detail': 'topology-fragmentation'},
                      'explain fits': {'sha256': '4e99bdfdb0920fe605bf66dd46cd6c14782b34b7b81e158115d26ff30db019b1',
                                       'state': 'pending',
                                       'fits_now': True,
                                       'binding_constraint': None,
                                       'detail': None},
                      'explain capped': {'sha256': '842b9fd53b4b65767d591da5cf6613a286fb705f9d2feb9e4ae58cb71528a049',
                                         'state': 'pending',
                                         'fits_now': False,
                                         'binding_constraint': 'quota',
                                         'detail': 'quota-ceiling'},
                      'explain bridge': {'sha256': 'd929a3d79d5ecfe97432b43936014eb01d678fa01c2a9af81bb24e1792477c2f',
                                         'state': 'scheduled',
                                         'fits_now': True,
                                         'binding_constraint': None},
                      'capacity': {'sha256': 'aa57232d997b02803415294ddc800249a55104cf1356b624804097c37a7e2dcd'},
                      'whatif drain-node': {'sha256': '6cf5cdffbbc3e976c104a6f6df06a229f747968cfc68e4a04cd97d3a0cd63c13',
                                            'state': 'pending',
                                            'fits_now': True,
                                            'binding_constraint': None,
                                            'detail': None,
                                            'flipped': True}}},
 'drain': {'sets': 3,
           'nodes': 12,
           'drained_node': 'node-1',
           'gangs_on_node': 2,
           'drain_evictions': 2,
           'pre_placed': 2,
           'budget_cap': 1,
           'budget_max_observed': 1,
           'budget_exceeded': False,
           'gang_whole_violations': 0,
           'ticks_to_drained': 4,
           'node_drained': True,
           'node_empty': True,
           'readmitted': True,
           'breaker': {'burst': 3,
                       'granted': 3,
                       'denied': 3,
                       'opened': True,
                       'denied_while_open': True,
                       'closed_after_quiet': True,
                       'breaker_open_event': True,
                       'breaker_closed_event': True},
           'ab': {'identical_admissions': True, 'admitted_pods': 24},
           'ok': True},
 'smoke_ab': {'delta': {'bindings': 78,
                        'bindings_sha256': '01616b1be2aafbd357c639f4e34c2f4ce1fba8c4dd1186295dbcf209b2df7a5f',
                        'phases_sha256': 'a341c34ff37ac6ca8e7cbe6d88918fada645b6fc3dbface715248428f293a6ae'},
              'full': {'bindings': 78,
                       'bindings_sha256': '01616b1be2aafbd357c639f4e34c2f4ce1fba8c4dd1186295dbcf209b2df7a5f',
                       'phases_sha256': 'a341c34ff37ac6ca8e7cbe6d88918fada645b6fc3dbface715248428f293a6ae'}},
 'demo': {'sha256': 'b927a842489cba47dde429917412672f085c425281333e1a45019905ee87e15d',
          'lines': 18}}


def phase_sims(card, device="cuda", reference=None) -> dict:
    """[sims] (nu): the port's sim/multitenant, sim/voluntary,
    sim/deltachurn and sim/demo scenarios at the JAX package's own shapes
    (models/scenarios.run_sims_world): the contended three-tenant run, the
    single-queue A/B, the explain scenario's documents, the drain artifact,
    the run-level churn A/B and the demo on simple1.yaml, each equal to
    JAX_SIMS_REFERENCE, nothing missing (sims_missing); the fill and both
    DRF kernels must launch."""
    from grove_tpu_torch.models.scenarios import port_names, run_sims_world, sims_missing
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda

    ref = JAX_SIMS_REFERENCE if reference is None else reference
    steps, seen = {}, [0, 0, 0]

    def after(name, wall_s, result):
        _check_same(f"sims {name}", result, ref[name])
        counts = [fill_batch.launches, share_table_cuda.launches, merge_cuda.launches]
        fill, shares, merge = (c - s for c, s in zip(counts, seen))
        seen[:] = counts
        steps[name] = {"wall_s": wall_s, "fill_launches": fill, "drf_shares_launches": shares,
                       "drf_merge_launches": merge}
        print(f"[sims] {name}: {wall_s:.3f} s, equal to the JAX package's; launches fill {fill},"
              f" DRF {shares} + {merge}", flush=True)

    fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0
    got = run_sims_world(port_names(device), device=device, after=after)
    launches = {"fill": fill_batch.launches, "drf_shares": share_table_cuda.launches,
                "drf_merge": merge_cuda.launches}
    got.pop("times")
    _check_same("sims", got, ref)
    missing = sims_missing(got)
    if missing:
        _fail(f"sims: the scenarios did not show {missing}")
    if device != "cpu" and not (launches["fill"] and launches["drf_shares"]
                                and launches["drf_merge"]):
        _fail(f"sims: the fill and both DRF kernels must launch: {launches}")
    out = {"steps": steps, **{f"{k}_launches": v for k, v in launches.items()},
           "contended": got["contended"], "drain_ok": got["drain"]["ok"]}
    print(f"[sims] (nu) contended quota (reclaims {got['contended']['reclaims']}), single-queue"
          f" A/B, explain, drain (ok {got['drain']['ok']}), run-level churn A/B and demo equal to"
          f" the JAX package's; launches fill {launches['fill']}, DRF {launches['drf_shares']} +"
          f" {launches['drf_merge']} | {card}", flush=True)
    return out

# [cluster] (tau): the first CLUSTER_SETS sets of (iota) over the port's
# real-cluster tier on 5,120 nodes (models/scenarios.run_cluster_world)
CLUSTER_FILL_CALLS = 8  # the first fill calls of (tau) held against the plain fill
CLUSTER_EXT_NODES = 16  # the external scheduler's nodes
CLUSTER_EXT_TIMEOUT_S = 300.0

# scripts/scheduler_reference.py cluster (PYTHONHASHSEED=0)
JAX_CLUSTER_REFERENCE = {'bindings_repeat': True,
                         'bindings_sha256': 'ad974e6072435a1f60f01bec70599d207d2bf630369bb5abdbee469d7bdf955f',
                         'census': {'ClusterTopology': 1,
                                    'Event': 253,
                                    'HorizontalPodAutoscaler': 4,
                                    'Pod': 152,
                                    'PodClique': 74,
                                    'PodCliqueScalingGroup': 4,
                                    'PodCliqueSet': 32,
                                    'PodGang': 33,
                                    'Role': 32,
                                    'RoleBinding': 32,
                                    'Secret': 32,
                                    'Service': 32,
                                    'ServiceAccount': 32},
                         'events': {'Pod/PodBound': 152,
                                    'Pod/PodCreateSuccessful': 152,
                                    'PodClique/PodCliqueCreateSuccessful': 64,
                                    'PodCliqueScalingGroup/PCSGCreateSuccessful': 4,
                                    'PodGang/GangAdmitted': 33,
                                    'PodGang/PodGangCreateSuccessful': 33},
                         'gangs': {'Running': 33},
                         'pods': {'bound': 152, 'ready': 152, 'total': 152},
                         'world': {'n_nodes': 5120, 'n_sets': 32}}

# the external scheduler's process: run_external_scheduler on the card until
# SIGTERM, then one line with its kernels' launch counts
_EXT_SCHEDULER = """
import json, signal, sys, threading
from grove_tpu_torch.cluster.extscheduler import run_external_scheduler
from grove_tpu_torch.ops.fill import fill_batch
from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda
from grove_tpu_torch.sim.cluster import make_nodes
stop = threading.Event()
signal.signal(signal.SIGTERM, lambda *_: stop.set())
run_external_scheduler(sys.argv[1], make_nodes(int(sys.argv[2])), poll=0.05, stop=stop,
                       kubelet=True, device=sys.argv[3])
print("launches " + json.dumps({"fill": fill_batch.launches,
                                "drf_shares": share_table_cuda.launches,
                                "drf_merge": merge_cuda.launches}), flush=True)
"""


def _external_scheduler_world(device="cuda") -> dict:
    """The port's operator without its scheduler (threaded drain, TLS
    webhooks when openssl is there) and the port's external scheduler in a
    process of its own on the card (cluster/extscheduler.py, its own CUDA
    context, the kernels this smoke built): the four BASELINE samples
    POSTed, every gang Running, every pod Ready and bound. Returns the
    walls, the census and the external process's launch counts."""
    import shutil
    import signal
    import subprocess
    import urllib.request

    import yaml

    from grove_tpu_torch.api.pod import is_ready
    from grove_tpu_torch.cluster.manager import start_operator
    from grove_tpu_torch.models.scenarios import BASELINE_SAMPLES, SAMPLES_DIR

    t0 = time.perf_counter()
    rt = start_operator(with_scheduler=False, threaded=True, with_tls=bool(shutil.which("openssl")),
                        with_authorizer=True, device=device)
    proc = subprocess.Popen(
        [sys.executable, "-c", _EXT_SCHEDULER, rt.apiserver.address, str(CLUSTER_EXT_NODES),
         device], cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        text=True)
    try:
        base = rt.apiserver.address
        for filename in BASELINE_SAMPLES.values():
            doc = yaml.safe_load((SAMPLES_DIR / filename).read_text())
            req = urllib.request.Request(
                base + "/apis/grove.io/v1alpha1/namespaces/default/podcliquesets",
                data=json.dumps(doc).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=60).read()
        store, rounds = rt.apiserver.store, 0
        deadline = time.perf_counter() + CLUSTER_EXT_TIMEOUT_S
        while True:
            if proc.poll() is not None:
                _fail(f"cluster: the external scheduler exited ({proc.returncode})")
            if time.perf_counter() > deadline:
                _fail(f"cluster: the external scheduler did not bind every gang within"
                      f" {CLUSTER_EXT_TIMEOUT_S:.0f} s")
            rt.converge_once()
            rounds += 1
            with rt.apiserver.lock:
                gangs = list(store.scan("PodGang"))
                pods = list(store.scan("Pod"))
            if (len(gangs) >= len(BASELINE_SAMPLES) and pods
                    and all(g.status.phase == "Running" for g in gangs)
                    and all(is_ready(p) and p.status.node_name for p in pods)):
                break
            time.sleep(0.05)
        wall = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        rt.shutdown()
    line = [ln for ln in out.splitlines() if ln.startswith("launches ")]
    if not line:
        _fail("cluster: the external scheduler printed no launch counts")
    launches = json.loads(line[-1][len("launches "):])
    if device != "cpu" and not launches["fill"]:
        _fail(f"cluster: the external scheduler did not launch the fill kernel: {launches}")
    return {"wall_s": wall, "rounds": rounds, "gangs": len(gangs), "pods": len(pods),
            "launches": launches}


def phase_cluster(card, device="cuda", n_sets=None, n_nodes=None, reference=None) -> dict:
    """[cluster] (tau): the port's real-cluster tier on the card
    (models/scenarios.run_cluster_world): cluster/manager.start_operator
    (the HTTP apiserver, the admission webhooks over TLS with certificates
    from openssl, the authorizer, the HttpStore, the engine, the
    controllers, the card-side GangScheduler with its node monitor, broker,
    drainer and explain engine) on 5,120 nodes under deploy/operator.yaml's
    configuration; the first CLUSTER_SETS sets of (iota) POSTed as JSON and
    converged with converge_once until every gang is Running and every pod
    Ready. The census by kind, the gangs by phase, the pods, the GET
    /events records by reason and (when the JAX runs repeated it) the
    bindings' sha256 equal to JAX_CLUSTER_REFERENCE; every binding valid
    (check_world_valid on the apiserver's store); the fill must launch and
    its first calls equal the plain fill bit for bit. Then the external
    scheduler in a process of its own on the card against an operator
    without a scheduler, over the four BASELINE samples
    (_external_scheduler_world). Prints the apply and converge walls, the
    rounds, the µs a reconcile, the schedule passes' share of the wall and
    the launches."""
    import shutil

    from grove_tpu_torch.models.scenarios import port_names, run_cluster_world
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda

    ref = JAX_CLUSTER_REFERENCE if reference is None else reference
    if ref is None:
        _fail("cluster: JAX_CLUSTER_REFERENCE is missing")
    tls = shutil.which("openssl") is not None
    t_phase = time.perf_counter()

    def after_round(index, wall_s, work):
        print(f"[cluster] round {index}: {wall_s:.3f} s, work {work}", flush=True)

    def inspect(rt):
        with rt.apiserver.lock:
            check_world_valid("cluster", rt.apiserver.store, rt.cluster)
        return True

    fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0
    with _RecordedKernelFills(CLUSTER_FILL_CALLS) as recorded:
        got = run_cluster_world(port_names(device), n_sets, n_nodes, device=device,
                                with_tls=tls, after_round=after_round, inspect=inspect)
    launches = {"fill": fill_batch.launches, "drf_shares": share_table_cuda.launches,
                "drf_merge": merge_cuda.launches}
    walls = got.pop("walls")
    got.pop("inspect")
    for key in ("world", "census", "gangs", "pods", "events"):
        _check_same(f"cluster {key}", got[key], ref[key])
    if ref.get("bindings_repeat"):
        _check_same("cluster bindings", got["bindings_sha256"], ref["bindings_sha256"])
    if got["pods"]["ready"] != got["pods"]["total"]:
        _fail(f"cluster: not every pod Ready: {got['pods']}")
    if device != "cpu" and not launches["fill"]:
        _fail(f"cluster: (tau) did not launch the fill kernel: {launches}")
    fill_err = check_recorded_fills(recorded, "cluster", device)
    ext = _external_scheduler_world(device)
    out = {
        "sets": got["world"]["n_sets"], "nodes": got["world"]["n_nodes"], "tls": tls,
        **walls, "pods": got["pods"]["total"], "gangs": sum(got["gangs"].values()),
        "bindings_sha256": got["bindings_sha256"],
        "bindings_held": bool(ref.get("bindings_repeat")),
        **{f"{k}_launches": v for k, v in launches.items()},
        "fill_calls_checked": len(recorded.calls), "fill_max_abs_err": fill_err,
        "external": ext,
        "ext_fill_launches": ext["launches"]["fill"],
        "ext_drf_shares_launches": ext["launches"]["drf_shares"],
        "ext_drf_merge_launches": ext["launches"]["drf_merge"],
        "wall_s": time.perf_counter() - t_phase,
    }
    print(f"[cluster] (tau) {out['sets']} sets on {out['nodes']} nodes over HTTP (TLS webhooks"
          f" {'on' if tls else 'off: no openssl'}, authorizer on), {out['pods']} pods all Ready,"
          f" {out['gangs']} gangs Running, census, events and"
          f" {'bindings' if out['bindings_held'] else 'counts'} equal to the JAX package's:"
          f" apply {walls['apply_s']:.3f} s, converge {walls['converge_s']:.3f} s in"
          f" {walls['rounds']} rounds ({walls['reconciles']:.0f} reconciles,"
          f" {walls['us_per_reconcile']:.1f} us each), schedule passes"
          f" {walls['schedule_s']:.3f} s (share {walls['schedule_share']:.4f}, solver"
          f" {walls['solver_s']:.3f} s); launches fill {launches['fill']}, DRF"
          f" {launches['drf_shares']} + {launches['drf_merge']}; {len(recorded.calls)} fill calls"
          f" equal to the plain fill bit for bit; the external scheduler on the card bound the"
          f" four BASELINE samples ({ext['gangs']} gangs, {ext['pods']} pods) in"
          f" {ext['wall_s']:.3f} s, {ext['rounds']} operator rounds, launches"
          f" {ext['launches']} | {card}", flush=True)
    return out


FEDERATION_FILL_CALLS = 8  # the first fill calls of (psi) held against the plain fill
FEDERATION_DRF_CALLS = 4  # and its first global-usage DRF passes against the plain twin
JAX_FEDERATION_REFERENCE = {'mu': {'serving': {'seed': 2026,
                    'tenants': 2,
                    'duration_vt_s': 900.0,
                    'flash_crowds': 2,
                    'fault_injected': True,
                    'objectives': {'admission_latency_vt': {'attainment': 1.0,
                                                            'budget_remaining': 1.0,
                                                            'state': 'ok',
                                                            'breaches': 0,
                                                            'recoveries': 0},
                                   'ready_fraction': {'attainment': 0.6666666666666666,
                                                      'budget_remaining': 0.0,
                                                      'state': 'breached',
                                                      'breaches': 1,
                                                      'recoveries': 0},
                                   'scaleup_latency_vt': {'attainment': 1.0,
                                                          'budget_remaining': 1.0,
                                                          'state': 'ok',
                                                          'breaches': 0,
                                                          'recoveries': 0}},
                    'breaches': 1,
                    'recoveries': 0,
                    'scale_ups': 79,
                    'scale_downs': 44,
                    'scaleup_latency_vt': {'n': 19, 'p50_s': 10.0, 'p99_s': 33.001},
                    'time_under_min_vt_s': 0.0,
                    'queue_wait_vt': {'tenant-0': {'mean_s': 0.0, 'max_s': 0.0},
                                      'tenant-1': {'mean_s': 0.043, 'max_s': 1.0}}},
        'remediation': {'seed': 2026,
                        'duration_vt_s': 1200.0,
                        'actions_by_kind': {'scale-up': {'skipped': 12, 'executed': 21}},
                        'executed': 21,
                        'skipped': 12,
                        'flip_confirmed_rate': None,
                        'mean_budget_delta': 0.15789473684210525,
                        'forecast_skill_mean': 1.1565,
                        'forecast_beats_naive': True,
                        'budget_remaining_on': 1.0,
                        'budget_remaining_off': 0.0,
                        'budget_recovery_ratio': 1000000001.0,
                        'disruption_budget_violations': 0,
                        'objectives_on': {'admission_latency_vt': {'attainment': None,
                                                                   'budget_remaining': None,
                                                                   'state': 'ok',
                                                                   'breaches': 0,
                                                                   'recoveries': 0},
                                          'ready_fraction': {'attainment': 1.0,
                                                             'budget_remaining': 1.0,
                                                             'state': 'ok',
                                                             'breaches': 1,
                                                             'recoveries': 1},
                                          'scaleup_latency_vt': {'attainment': 1.0,
                                                                 'budget_remaining': 1.0,
                                                                 'state': 'ok',
                                                                 'breaches': 0,
                                                                 'recoveries': 0}},
                        'objectives_off': {'admission_latency_vt': {'attainment': None,
                                                                    'budget_remaining': None,
                                                                    'state': 'ok',
                                                                    'breaches': 0,
                                                                    'recoveries': 0},
                                           'ready_fraction': {'attainment': 0.7058823529411765,
                                                              'budget_remaining': 0.0,
                                                              'state': 'breached',
                                                              'breaches': 2,
                                                              'recoveries': 1},
                                           'scaleup_latency_vt': {'attainment': 1.0,
                                                                  'budget_remaining': 1.0,
                                                                  'state': 'ok',
                                                                  'breaches': 0,
                                                                  'recoveries': 0}}}},
 'chi': {'1234': {'seed': 1234,
                  'ticks': 35,
                  'faults': [{'at': 2.93,
                              'kind': 'crash',
                              'target': 'node-0',
                              'note': 'loss→rescue (packed)'},
                             {'at': 4.88,
                              'kind': 'crash',
                              'target': 'node-5',
                              'note': 'loss→requeue (strict)'},
                             {'at': 7.01,
                              'kind': 'crash',
                              'target': 'node-13',
                              'note': 'flap begin'},
                             {'at': 13.76,
                              'kind': 'outage_begin',
                              'target': '',
                              'note': 'store outage'},
                             {'at': 16.92, 'kind': 'outage_end', 'target': '', 'note': ''},
                             {'at': 19.17,
                              'kind': 'drain',
                              'target': 'node-3',
                              'note': 'voluntary drain (budgeted)'},
                             {'at': 19.39,
                              'kind': 'restart',
                              'target': 'node-13',
                              'note': 'flap end (inside grace)'},
                             {'at': 19.76,
                              'kind': 'leader_crash',
                              'target': '',
                              'note': 'failover mid-drain'},
                             {'at': 23.3,
                              'kind': 'restart',
                              'target': 'node-0',
                              'note': 'capacity returns'},
                             {'at': 23.71,
                              'kind': 'restart',
                              'target': 'node-5',
                              'note': 'capacity returns'},
                             {'at': 27.06,
                              'kind': 'uncordon',
                              'target': 'node-3',
                              'note': 'drained node returns to service'}],
                  'node_losses': 2,
                  'flaps': 1,
                  'rescues': 1,
                  'pin_verified_rescues': 1,
                  'requeues': 1,
                  'drain_evictions': 1,
                  'drains_completed': 1,
                  'failovers': 1,
                  'recoveries': 0,
                  'replayed_records': 0,
                  'torn_tails': 0,
                  'lost_unacked_records': 0,
                  'scheduler_errors': 0,
                  'invariant_violations': [],
                  'flight_bundles': [],
                  'remediator_armed': False,
                  'remediations_executed': 0,
                  'remediations_skipped': 0,
                  'worker_crashes': 0,
                  'failslow_degraded': 0,
                  'failslow_recovered': 0,
                  'converged': True,
                  'signature_matches_fault_free': True,
                  'ok': True,
                  'sanitized': False},
         '7 controlplane_crash': {'seed': 7,
                                  'ticks': 35,
                                  'faults': [{'at': 1.65,
                                              'kind': 'crash',
                                              'target': 'node-0',
                                              'note': 'loss→rescue (packed)'},
                                             {'at': 4.3,
                                              'kind': 'crash',
                                              'target': 'node-5',
                                              'note': 'loss→requeue (strict)'},
                                             {'at': 8.3,
                                              'kind': 'crash',
                                              'target': 'node-13',
                                              'note': 'flap begin'},
                                             {'at': 12.14,
                                              'kind': 'outage_begin',
                                              'target': '',
                                              'note': 'store outage'},
                                             {'at': 14.81,
                                              'kind': 'restart',
                                              'target': 'node-13',
                                              'note': 'flap end (inside grace)'},
                                             {'at': 14.87,
                                              'kind': 'outage_end',
                                              'target': '',
                                              'note': ''},
                                             {'at': 18.56,
                                              'kind': 'drain',
                                              'target': 'node-3',
                                              'note': 'voluntary drain (budgeted)'},
                                             {'at': 19.57,
                                              'kind': 'leader_crash',
                                              'target': '',
                                              'note': 'failover mid-drain'},
                                             {'at': 21.11,
                                              'kind': 'restart',
                                              'target': 'node-0',
                                              'note': 'capacity returns'},
                                             {'at': 24.3,
                                              'kind': 'restart',
                                              'target': 'node-5',
                                              'note': 'capacity returns'},
                                             {'at': 26.24,
                                              'kind': 'controlplane_crash',
                                              'target': '',
                                              'note': 'store+engine crash, recover from disk'},
                                             {'at': 27.18,
                                              'kind': 'uncordon',
                                              'target': 'node-3',
                                              'note': 'drained node returns to service'}],
                                  'node_losses': 2,
                                  'flaps': 1,
                                  'rescues': 1,
                                  'pin_verified_rescues': 1,
                                  'requeues': 1,
                                  'drain_evictions': 1,
                                  'drains_completed': 1,
                                  'failovers': 1,
                                  'recoveries': 1,
                                  'replayed_records': 111,
                                  'torn_tails': 1,
                                  'lost_unacked_records': 0,
                                  'scheduler_errors': 0,
                                  'invariant_violations': [],
                                  'flight_bundles': [],
                                  'remediator_armed': False,
                                  'remediations_executed': 0,
                                  'remediations_skipped': 0,
                                  'worker_crashes': 0,
                                  'failslow_degraded': 0,
                                  'failslow_recovered': 0,
                                  'converged': True,
                                  'signature_matches_fault_free': True,
                                  'ok': True,
                                  'sanitized': False},
         '42 sanitized': {'seed': 42,
                          'ticks': 37,
                          'faults': [{'at': 2.28,
                                      'kind': 'crash',
                                      'target': 'node-0',
                                      'note': 'loss→rescue (packed)'},
                                     {'at': 4.05,
                                      'kind': 'crash',
                                      'target': 'node-5',
                                      'note': 'loss→requeue (strict)'},
                                     {'at': 7.55,
                                      'kind': 'crash',
                                      'target': 'node-13',
                                      'note': 'flap begin'},
                                     {'at': 12.95,
                                      'kind': 'outage_begin',
                                      'target': '',
                                      'note': 'store outage'},
                                     {'at': 15.11,
                                      'kind': 'restart',
                                      'target': 'node-13',
                                      'note': 'flap end (inside grace)'},
                                     {'at': 16.3, 'kind': 'outage_end', 'target': '', 'note': ''},
                                     {'at': 19.39,
                                      'kind': 'drain',
                                      'target': 'node-3',
                                      'note': 'voluntary drain (budgeted)'},
                                     {'at': 19.98,
                                      'kind': 'leader_crash',
                                      'target': '',
                                      'note': 'failover mid-drain'},
                                     {'at': 22.27,
                                      'kind': 'restart',
                                      'target': 'node-0',
                                      'note': 'capacity returns'},
                                     {'at': 23.09,
                                      'kind': 'restart',
                                      'target': 'node-5',
                                      'note': 'capacity returns'},
                                     {'at': 27.44,
                                      'kind': 'uncordon',
                                      'target': 'node-3',
                                      'note': 'drained node returns to service'}],
                          'node_losses': 2,
                          'flaps': 1,
                          'rescues': 1,
                          'pin_verified_rescues': 1,
                          'requeues': 1,
                          'drain_evictions': 1,
                          'drains_completed': 1,
                          'failovers': 1,
                          'recoveries': 0,
                          'replayed_records': 0,
                          'torn_tails': 0,
                          'lost_unacked_records': 0,
                          'scheduler_errors': 0,
                          'invariant_violations': [],
                          'flight_bundles': [],
                          'remediator_armed': False,
                          'remediations_executed': 0,
                          'remediations_skipped': 0,
                          'worker_crashes': 0,
                          'failslow_degraded': 0,
                          'failslow_recovered': 0,
                          'converged': True,
                          'signature_matches_fault_free': True,
                          'ok': True,
                          'sanitized': True},
         '99 remediator': {'seed': 99,
                           'ticks': 36,
                           'faults': [{'at': 1.81,
                                       'kind': 'crash',
                                       'target': 'node-0',
                                       'note': 'loss→rescue (packed)'},
                                      {'at': 4.4,
                                       'kind': 'crash',
                                       'target': 'node-5',
                                       'note': 'loss→requeue (strict)'},
                                      {'at': 7.36,
                                       'kind': 'crash',
                                       'target': 'node-13',
                                       'note': 'flap begin'},
                                      {'at': 13.04,
                                       'kind': 'outage_begin',
                                       'target': '',
                                       'note': 'store outage'},
                                      {'at': 15.1,
                                       'kind': 'restart',
                                       'target': 'node-13',
                                       'note': 'flap end (inside grace)'},
                                      {'at': 15.54, 'kind': 'outage_end', 'target': '', 'note': ''},
                                      {'at': 18.88,
                                       'kind': 'drain',
                                       'target': 'node-3',
                                       'note': 'voluntary drain (budgeted)'},
                                      {'at': 20.07,
                                       'kind': 'leader_crash',
                                       'target': '',
                                       'note': 'failover mid-drain'},
                                      {'at': 22.62,
                                       'kind': 'restart',
                                       'target': 'node-0',
                                       'note': 'capacity returns'},
                                      {'at': 25.82,
                                       'kind': 'restart',
                                       'target': 'node-5',
                                       'note': 'capacity returns'},
                                      {'at': 27.98,
                                       'kind': 'uncordon',
                                       'target': 'node-3',
                                       'note': 'drained node returns to service'}],
                           'node_losses': 2,
                           'flaps': 1,
                           'rescues': 1,
                           'pin_verified_rescues': 1,
                           'requeues': 1,
                           'drain_evictions': 1,
                           'drains_completed': 1,
                           'failovers': 1,
                           'recoveries': 0,
                           'replayed_records': 0,
                           'torn_tails': 0,
                           'lost_unacked_records': 0,
                           'scheduler_errors': 0,
                           'invariant_violations': [],
                           'flight_bundles': [],
                           'remediator_armed': True,
                           'remediations_executed': 0,
                           'remediations_skipped': 0,
                           'worker_crashes': 0,
                           'failslow_degraded': 0,
                           'failslow_recovered': 0,
                           'converged': True,
                           'signature_matches_fault_free': True,
                           'ok': True,
                           'sanitized': False},
         '2026 failslow': {'seed': 2026,
                           'ticks': 64,
                           'faults': [{'at': 1.24,
                                       'kind': 'crash',
                                       'target': 'node-0',
                                       'note': 'loss→rescue (packed)'},
                                      {'at': 5.01,
                                       'kind': 'crash',
                                       'target': 'node-5',
                                       'note': 'loss→requeue (strict)'},
                                      {'at': 8.02,
                                       'kind': 'crash',
                                       'target': 'node-13',
                                       'note': 'flap begin'},
                                      {'at': 10.41,
                                       'kind': 'outage_begin',
                                       'target': '',
                                       'note': 'store outage'},
                                      {'at': 12.54,
                                       'kind': 'failslow_begin',
                                       'target': 'node-1',
                                       'note': 'gray failure: heartbeats late, below binary grace'},
                                      {'at': 12.86, 'kind': 'outage_end', 'target': '', 'note': ''},
                                      {'at': 19.1,
                                       'kind': 'drain',
                                       'target': 'node-3',
                                       'note': 'voluntary drain (budgeted)'},
                                      {'at': 20.04,
                                       'kind': 'restart',
                                       'target': 'node-13',
                                       'note': 'flap end (inside grace)'},
                                      {'at': 20.16,
                                       'kind': 'leader_crash',
                                       'target': '',
                                       'note': 'failover mid-drain'},
                                      {'at': 23.35,
                                       'kind': 'restart',
                                       'target': 'node-0',
                                       'note': 'capacity returns'},
                                      {'at': 24.64,
                                       'kind': 'restart',
                                       'target': 'node-5',
                                       'note': 'capacity returns'},
                                      {'at': 28.46,
                                       'kind': 'uncordon',
                                       'target': 'node-3',
                                       'note': 'drained node returns to service'},
                                      {'at': 30.75,
                                       'kind': 'failslow_end',
                                       'target': 'node-1',
                                       'note': 'fail-slow healed (suspicion must decay to Ready)'}],
                           'node_losses': 2,
                           'flaps': 1,
                           'rescues': 1,
                           'pin_verified_rescues': 1,
                           'requeues': 1,
                           'drain_evictions': 1,
                           'drains_completed': 1,
                           'failovers': 1,
                           'recoveries': 0,
                           'replayed_records': 0,
                           'torn_tails': 0,
                           'lost_unacked_records': 0,
                           'scheduler_errors': 0,
                           'invariant_violations': [],
                           'flight_bundles': [],
                           'remediator_armed': False,
                           'remediations_executed': 0,
                           'remediations_skipped': 0,
                           'worker_crashes': 0,
                           'failslow_degraded': 2,
                           'failslow_recovered': 2,
                           'converged': True,
                           'signature_matches_fault_free': True,
                           'ok': True,
                           'sanitized': False},
         '7 controlplane_crash 3 shards': {'seed': 7,
                                           'ticks': 35,
                                           'faults': [{'at': 1.65,
                                                       'kind': 'crash',
                                                       'target': 'node-0',
                                                       'note': 'loss→rescue (packed)'},
                                                      {'at': 4.3,
                                                       'kind': 'crash',
                                                       'target': 'node-5',
                                                       'note': 'loss→requeue (strict)'},
                                                      {'at': 8.3,
                                                       'kind': 'crash',
                                                       'target': 'node-13',
                                                       'note': 'flap begin'},
                                                      {'at': 12.14,
                                                       'kind': 'outage_begin',
                                                       'target': '',
                                                       'note': 'store outage'},
                                                      {'at': 14.81,
                                                       'kind': 'restart',
                                                       'target': 'node-13',
                                                       'note': 'flap end (inside grace)'},
                                                      {'at': 14.87,
                                                       'kind': 'outage_end',
                                                       'target': '',
                                                       'note': ''},
                                                      {'at': 18.56,
                                                       'kind': 'drain',
                                                       'target': 'node-3',
                                                       'note': 'voluntary drain (budgeted)'},
                                                      {'at': 19.57,
                                                       'kind': 'leader_crash',
                                                       'target': '',
                                                       'note': 'failover mid-drain'},
                                                      {'at': 21.11,
                                                       'kind': 'restart',
                                                       'target': 'node-0',
                                                       'note': 'capacity returns'},
                                                      {'at': 24.3,
                                                       'kind': 'restart',
                                                       'target': 'node-5',
                                                       'note': 'capacity returns'},
                                                      {'at': 26.24,
                                                       'kind': 'controlplane_crash',
                                                       'target': '',
                                                       'note': 'store+engine crash, recover from '
                                                               'disk'},
                                                      {'at': 27.18,
                                                       'kind': 'uncordon',
                                                       'target': 'node-3',
                                                       'note': 'drained node returns to service'}],
                                           'node_losses': 2,
                                           'flaps': 1,
                                           'rescues': 1,
                                           'pin_verified_rescues': 1,
                                           'requeues': 1,
                                           'drain_evictions': 1,
                                           'drains_completed': 1,
                                           'failovers': 1,
                                           'recoveries': 1,
                                           'replayed_records': 111,
                                           'torn_tails': 1,
                                           'lost_unacked_records': 0,
                                           'scheduler_errors': 0,
                                           'invariant_violations': [],
                                           'flight_bundles': [],
                                           'remediator_armed': False,
                                           'remediations_executed': 0,
                                           'remediations_skipped': 0,
                                           'worker_crashes': 0,
                                           'failslow_degraded': 0,
                                           'failslow_recovered': 0,
                                           'converged': True,
                                           'signature_matches_fault_free': True,
                                           'ok': True,
                                           'sanitized': False},
         '1234 3 shards 2 process workers': {'seed': 1234,
                                             'ticks': 37,
                                             'faults': [{'at': 2.93,
                                                         'kind': 'crash',
                                                         'target': 'node-0',
                                                         'note': 'loss→rescue (packed)'},
                                                        {'at': 4.88,
                                                         'kind': 'crash',
                                                         'target': 'node-5',
                                                         'note': 'loss→requeue (strict)'},
                                                        {'at': 7.01,
                                                         'kind': 'crash',
                                                         'target': 'node-13',
                                                         'note': 'flap begin'},
                                                        {'at': 13.76,
                                                         'kind': 'outage_begin',
                                                         'target': '',
                                                         'note': 'store outage'},
                                                        {'at': 16.92,
                                                         'kind': 'outage_end',
                                                         'target': '',
                                                         'note': ''},
                                                        {'at': 19.17,
                                                         'kind': 'drain',
                                                         'target': 'node-3',
                                                         'note': 'voluntary drain (budgeted)'},
                                                        {'at': 19.39,
                                                         'kind': 'restart',
                                                         'target': 'node-13',
                                                         'note': 'flap end (inside grace)'},
                                                        {'at': 19.76,
                                                         'kind': 'leader_crash',
                                                         'target': '',
                                                         'note': 'failover mid-drain'},
                                                        {'at': 21.71,
                                                         'kind': 'restart',
                                                         'target': 'node-0',
                                                         'note': 'capacity returns'},
                                                        {'at': 22.77,
                                                         'kind': 'worker_crash',
                                                         'target': '',
                                                         'note': 'SIGKILL reconcile worker '
                                                                 'mid-round (process executor); '
                                                                 'repatriate + inline '
                                                                 're-execution'},
                                                        {'at': 23.09,
                                                         'kind': 'restart',
                                                         'target': 'node-5',
                                                         'note': 'capacity returns'},
                                                        {'at': 28.58,
                                                         'kind': 'uncordon',
                                                         'target': 'node-3',
                                                         'note': 'drained node returns to '
                                                                 'service'}],
                                             'node_losses': 2,
                                             'flaps': 1,
                                             'rescues': 1,
                                             'pin_verified_rescues': 1,
                                             'requeues': 1,
                                             'drain_evictions': 1,
                                             'drains_completed': 1,
                                             'failovers': 1,
                                             'recoveries': 0,
                                             'replayed_records': 0,
                                             'torn_tails': 0,
                                             'lost_unacked_records': 0,
                                             'scheduler_errors': 0,
                                             'invariant_violations': [],
                                             'flight_bundles': [],
                                             'remediator_armed': False,
                                             'remediations_executed': 0,
                                             'remediations_skipped': 0,
                                             'worker_crashes': 1,
                                             'failslow_degraded': 0,
                                             'failslow_recovered': 0,
                                             'converged': True,
                                             'signature_matches_fault_free': True,
                                             'ok': True,
                                             'sanitized': False},
         'federation 4242': {'seed': 4242,
                             'regions': 3,
                             'ticks': 22,
                             'faults': [{'at': 6.0,
                                         'kind': 'cluster_crash',
                                         'target': 'region-0',
                                         'note': '6 placements'},
                                        {'at': 16.0,
                                         'kind': 'cluster_rejoin',
                                         'target': 'region-0',
                                         'note': ''}],
                             'applied': 18,
                             'cluster_crashes': 1,
                             'rejoins': 1,
                             'reroutes': 6,
                             'spillovers': 2,
                             'stranded': 0,
                             'invariant_checks': 4,
                             'invariant_violations': [],
                             'converged': True,
                             'ok': True},
         'partition 4242': {'seed': 4242,
                            'regions': 3,
                            'ticks': 33,
                            'faults': [{'at': 3.0,
                                        'kind': 'cluster_partition',
                                        'target': 'region-1',
                                        'note': '4 placements, 4 Scheduled inside'},
                                       {'at': 11.0,
                                        'kind': 'cluster_heal',
                                        'target': 'region-1',
                                        'note': ''}],
                            'applied': 18,
                            'partitions': 1,
                            'heals': 1,
                            'partition_spills': 3,
                            'placements_kept': 4,
                            'placements_in_partition': 4,
                            'invariant_checks': 9,
                            'invariant_violations': [],
                            'converged': True,
                            'ok': True},
         'federation_artifact': {'seed': 2026,
                                 'regions': 3,
                                 'nodes_per_region': 8,
                                 'applied': 9,
                                 'spillovers': 0,
                                 'reroutes': 2,
                                 'decisions': 12,
                                 'fold_depth_histogram': [3, 1],
                                 'crash': {'victims': 2, 'rerouted': 2, 'stranded': 0}}},
 'psi': {'world': {'regions': ['us', 'eu', 'ap'],
                   'nodes_per_region': 5120,
                   'stage1_each': 64,
                   'stage2_each': 2048,
                   'stage2_ticks': 10},
         'setup queues': {'spillovers': 0,
                          'reroutes': 0,
                          'decisions': 0,
                          'decisions_by_kind': {},
                          'decisions_sha256': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
                          'foldDepthHistogram': [3, 1],
                          'foldDepth': 2,
                          'globalUsage': {},
                          'clusters': [{'region': 'us',
                                        'state': 'Ready',
                                        'phaseOffset': 0.0,
                                        'crashes': 0,
                                        'reachable': True,
                                        'partitions': 0,
                                        'placements': 0,
                                        'nodes': 5120,
                                        'resourceVersion': 9,
                                        'pendingGangs': 0},
                                       {'region': 'eu',
                                        'state': 'Ready',
                                        'phaseOffset': 200.0,
                                        'crashes': 0,
                                        'reachable': True,
                                        'partitions': 0,
                                        'placements': 0,
                                        'nodes': 5120,
                                        'resourceVersion': 9,
                                        'pendingGangs': 0},
                                       {'region': 'ap',
                                        'state': 'Ready',
                                        'phaseOffset': 400.0,
                                        'crashes': 0,
                                        'reachable': True,
                                        'partitions': 0,
                                        'placements': 0,
                                        'nodes': 5120,
                                        'resourceVersion': 9,
                                        'pendingGangs': 0}]},
         'stage1 apply': {'spillovers': 0,
                          'reroutes': 0,
                          'decisions': 192,
                          'decisions_by_kind': {'place': 192},
                          'decisions_sha256': '9a7c9c6c326b1d3b9090863d9fdcafaa11062cd3d4c151f55526971dd36ec6c8',
                          'foldDepthHistogram': [3, 1],
                          'foldDepth': 2,
                          'globalUsage': {},
                          'clusters': [{'region': 'us',
                                        'state': 'Ready',
                                        'phaseOffset': 0.0,
                                        'crashes': 0,
                                        'reachable': True,
                                        'partitions': 0,
                                        'placements': 132,
                                        'nodes': 5120,
                                        'resourceVersion': 141,
                                        'pendingGangs': 0},
                                       {'region': 'eu',
                                        'state': 'Ready',
                                        'phaseOffset': 200.0,
                                        'crashes': 0,
                                        'reachable': True,
                                        'partitions': 0,
                                        'placements': 31,
                                        'nodes': 5120,
                                        'resourceVersion': 40,
                                        'pendingGangs': 0},
                                       {'region': 'ap',
                                        'state': 'Ready',
                                        'phaseOffset': 400.0,
                                        'crashes': 0,
                                        'reachable': True,
                                        'partitions': 0,
                                        'placements': 29,
                                        'nodes': 5120,
                                        'resourceVersion': 38,
                                        'pendingGangs': 0}]},
         'stage1 converge': {'spillovers': 0,
                             'reroutes': 0,
                             'decisions': 192,
                             'decisions_by_kind': {'place': 192},
                             'decisions_sha256': '9a7c9c6c326b1d3b9090863d9fdcafaa11062cd3d4c151f55526971dd36ec6c8',
                             'foldDepthHistogram': [3, 1],
                             'foldDepth': 2,
                             'globalUsage': {'tenant-0': {'cpu': 216.0},
                                             'tenant-1': {'cpu': 216.0},
                                             'tenant-2': {'cpu': 216.0},
                                             'tenant-3': {'cpu': 216.0},
                                             'tenant-4': {'cpu': 216.0},
                                             'tenant-5': {'cpu': 216.0},
                                             'tenant-6': {'cpu': 216.0},
                                             'tenant-7': {'cpu': 216.0}},
                             'clusters': [{'region': 'us',
                                           'state': 'Ready',
                                           'phaseOffset': 0.0,
                                           'crashes': 0,
                                           'reachable': True,
                                           'partitions': 0,
                                           'placements': 132,
                                           'nodes': 5120,
                                           'resourceVersion': 5222,
                                           'pendingGangs': 0},
                                          {'region': 'eu',
                                           'state': 'Ready',
                                           'phaseOffset': 200.0,
                                           'crashes': 0,
                                           'reachable': True,
                                           'partitions': 0,
                                           'placements': 31,
                                           'nodes': 5120,
                                           'resourceVersion': 1241,
                                           'pendingGangs': 0},
                                          {'region': 'ap',
                                           'state': 'Ready',
                                           'phaseOffset': 400.0,
                                           'crashes': 0,
                                           'reachable': True,
                                           'partitions': 0,
                                           'placements': 29,
                                           'nodes': 5120,
                                           'resourceVersion': 1164,
                                           'pendingGangs': 0}]},
         'stage1 crash': {'spillovers': 0,
                          'reroutes': 132,
                          'decisions': 324,
                          'decisions_by_kind': {'place': 192, 'reroute': 132},
                          'decisions_sha256': '6f1a401144f52637ce65773ceb0712b23e8fe3921ac21f3c74fdd8e7e2ac22f9',
                          'foldDepthHistogram': [3, 1],
                          'foldDepth': 2,
                          'globalUsage': {'tenant-0': {'cpu': 54.0},
                                          'tenant-1': {'cpu': 87.0},
                                          'tenant-2': {'cpu': 63.0},
                                          'tenant-3': {'cpu': 126.0},
                                          'tenant-4': {'cpu': 75.0},
                                          'tenant-5': {'cpu': 30.0},
                                          'tenant-6': {'cpu': 60.0},
                                          'tenant-7': {'cpu': 36.0}},
                          'clusters': [{'region': 'us',
                                        'state': 'Lost',
                                        'phaseOffset': 0.0,
                                        'crashes': 1,
                                        'reachable': True,
                                        'partitions': 0,
                                        'placements': 0,
                                        'lostAt': 3.0},
                                       {'region': 'eu',
                                        'state': 'Ready',
                                        'phaseOffset': 200.0,
                                        'crashes': 0,
                                        'reachable': True,
                                        'partitions': 0,
                                        'placements': 31,
                                        'nodes': 5120,
                                        'resourceVersion': 1241,
                                        'pendingGangs': 0},
                                       {'region': 'ap',
                                        'state': 'Ready',
                                        'phaseOffset': 400.0,
                                        'crashes': 0,
                                        'reachable': True,
                                        'partitions': 0,
                                        'placements': 161,
                                        'nodes': 5120,
                                        'resourceVersion': 1296,
                                        'pendingGangs': 0}]},
         'stage1 crash result': {'victims': 132, 'rerouted': 132, 'stranded': 0},
         'stage1 reconverge': {'spillovers': 0,
                               'reroutes': 132,
                               'decisions': 324,
                               'decisions_by_kind': {'place': 192, 'reroute': 132},
                               'decisions_sha256': '6f1a401144f52637ce65773ceb0712b23e8fe3921ac21f3c74fdd8e7e2ac22f9',
                               'foldDepthHistogram': [3, 1],
                               'foldDepth': 2,
                               'globalUsage': {'tenant-0': {'cpu': 216.0},
                                               'tenant-1': {'cpu': 216.0},
                                               'tenant-2': {'cpu': 216.0},
                                               'tenant-3': {'cpu': 216.0},
                                               'tenant-4': {'cpu': 216.0},
                                               'tenant-5': {'cpu': 216.0},
                                               'tenant-6': {'cpu': 216.0},
                                               'tenant-7': {'cpu': 216.0}},
                               'clusters': [{'region': 'us',
                                             'state': 'Lost',
                                             'phaseOffset': 0.0,
                                             'crashes': 1,
                                             'reachable': True,
                                             'partitions': 0,
                                             'placements': 0,
                                             'lostAt': 3.0},
                                            {'region': 'eu',
                                             'state': 'Ready',
                                             'phaseOffset': 200.0,
                                             'crashes': 0,
                                             'reachable': True,
                                             'partitions': 0,
                                             'placements': 31,
                                             'nodes': 5120,
                                             'resourceVersion': 1241,
                                             'pendingGangs': 0},
                                            {'region': 'ap',
                                             'state': 'Ready',
                                             'phaseOffset': 400.0,
                                             'crashes': 0,
                                             'reachable': True,
                                             'partitions': 0,
                                             'placements': 161,
                                             'nodes': 5120,
                                             'resourceVersion': 6377,
                                             'pendingGangs': 0}]},
         'stage1 rejoin': {'spillovers': 0,
                           'reroutes': 132,
                           'decisions': 325,
                           'decisions_by_kind': {'place': 192, 'rejoin': 1, 'reroute': 132},
                           'decisions_sha256': '719a0820582c24aec9ce01b8443fc05b07ae9b981d47cde3aad49542dcc2f0e3',
                           'foldDepthHistogram': [3, 1],
                           'foldDepth': 2,
                           'globalUsage': {'tenant-0': {'cpu': 216.0},
                                           'tenant-1': {'cpu': 216.0},
                                           'tenant-2': {'cpu': 216.0},
                                           'tenant-3': {'cpu': 216.0},
                                           'tenant-4': {'cpu': 216.0},
                                           'tenant-5': {'cpu': 216.0},
                                           'tenant-6': {'cpu': 216.0},
                                           'tenant-7': {'cpu': 216.0}},
                           'clusters': [{'region': 'us',
                                         'state': 'Ready',
                                         'phaseOffset': 0.0,
                                         'crashes': 1,
                                         'reachable': True,
                                         'partitions': 0,
                                         'placements': 0,
                                         'nodes': 5120,
                                         'resourceVersion': 9,
                                         'pendingGangs': 0},
                                        {'region': 'eu',
                                         'state': 'Ready',
                                         'phaseOffset': 200.0,
                                         'crashes': 0,
                                         'reachable': True,
                                         'partitions': 0,
                                         'placements': 31,
                                         'nodes': 5120,
                                         'resourceVersion': 1241,
                                         'pendingGangs': 0},
                                        {'region': 'ap',
                                         'state': 'Ready',
                                         'phaseOffset': 400.0,
                                         'crashes': 0,
                                         'reachable': True,
                                         'partitions': 0,
                                         'placements': 161,
                                         'nodes': 5120,
                                         'resourceVersion': 6377,
                                         'pendingGangs': 0}]},
         'stage1 rejoin converge': {'spillovers': 0,
                                    'reroutes': 132,
                                    'decisions': 325,
                                    'decisions_by_kind': {'place': 192,
                                                          'rejoin': 1,
                                                          'reroute': 132},
                                    'decisions_sha256': '719a0820582c24aec9ce01b8443fc05b07ae9b981d47cde3aad49542dcc2f0e3',
                                    'foldDepthHistogram': [3, 1],
                                    'foldDepth': 2,
                                    'globalUsage': {'tenant-0': {'cpu': 216.0},
                                                    'tenant-1': {'cpu': 216.0},
                                                    'tenant-2': {'cpu': 216.0},
                                                    'tenant-3': {'cpu': 216.0},
                                                    'tenant-4': {'cpu': 216.0},
                                                    'tenant-5': {'cpu': 216.0},
                                                    'tenant-6': {'cpu': 216.0},
                                                    'tenant-7': {'cpu': 216.0}},
                                    'clusters': [{'region': 'us',
                                                  'state': 'Ready',
                                                  'phaseOffset': 0.0,
                                                  'crashes': 1,
                                                  'reachable': True,
                                                  'partitions': 0,
                                                  'placements': 0,
                                                  'nodes': 5120,
                                                  'resourceVersion': 9,
                                                  'pendingGangs': 0},
                                                 {'region': 'eu',
                                                  'state': 'Ready',
                                                  'phaseOffset': 200.0,
                                                  'crashes': 0,
                                                  'reachable': True,
                                                  'partitions': 0,
                                                  'placements': 31,
                                                  'nodes': 5120,
                                                  'resourceVersion': 1241,
                                                  'pendingGangs': 0},
                                                 {'region': 'ap',
                                                  'state': 'Ready',
                                                  'phaseOffset': 400.0,
                                                  'crashes': 0,
                                                  'reachable': True,
                                                  'partitions': 0,
                                                  'placements': 161,
                                                  'nodes': 5120,
                                                  'resourceVersion': 6377,
                                                  'pendingGangs': 0}]},
         'stage2 apply': {'spillovers': 0,
                          'reroutes': 132,
                          'decisions': 6469,
                          'decisions_by_kind': {'place': 6336, 'rejoin': 1, 'reroute': 132},
                          'decisions_sha256': '57cf6eb9489218b5c5587fc8072a772d36dab0e7154e6225297b323054adf05a',
                          'foldDepthHistogram': [3, 1],
                          'foldDepth': 2,
                          'globalUsage': {'tenant-0': {'cpu': 216.0},
                                          'tenant-1': {'cpu': 216.0},
                                          'tenant-2': {'cpu': 216.0},
                                          'tenant-3': {'cpu': 216.0},
                                          'tenant-4': {'cpu': 216.0},
                                          'tenant-5': {'cpu': 216.0},
                                          'tenant-6': {'cpu': 216.0},
                                          'tenant-7': {'cpu': 216.0}},
                          'clusters': [{'region': 'us',
                                        'state': 'Ready',
                                        'phaseOffset': 0.0,
                                        'crashes': 1,
                                        'reachable': True,
                                        'partitions': 0,
                                        'placements': 4359,
                                        'nodes': 5120,
                                        'resourceVersion': 4368,
                                        'pendingGangs': 0},
                                       {'region': 'eu',
                                        'state': 'Ready',
                                        'phaseOffset': 200.0,
                                        'crashes': 0,
                                        'reachable': True,
                                        'partitions': 0,
                                        'placements': 920,
                                        'nodes': 5120,
                                        'resourceVersion': 2130,
                                        'pendingGangs': 0},
                                       {'region': 'ap',
                                        'state': 'Ready',
                                        'phaseOffset': 400.0,
                                        'crashes': 0,
                                        'reachable': True,
                                        'partitions': 0,
                                        'placements': 1057,
                                        'nodes': 5120,
                                        'resourceVersion': 7273,
                                        'pendingGangs': 0}]},
         'stage2 converge': {'spillovers': 6,
                             'reroutes': 132,
                             'decisions': 6475,
                             'decisions_by_kind': {'place': 6336,
                                                   'rejoin': 1,
                                                   'reroute': 132,
                                                   'spill': 6},
                             'decisions_sha256': '8aab96b0b320f6680ffddf9b23cba354f1286b38f26474ff0695592ab389d426',
                             'foldDepthHistogram': [3, 1],
                             'foldDepth': 2,
                             'globalUsage': {'tenant-0': {'cpu': 6723.0},
                                             'tenant-1': {'cpu': 6768.0},
                                             'tenant-2': {'cpu': 6933.0},
                                             'tenant-3': {'cpu': 6858.0},
                                             'tenant-4': {'cpu': 6768.0},
                                             'tenant-5': {'cpu': 6798.0},
                                             'tenant-6': {'cpu': 6723.0},
                                             'tenant-7': {'cpu': 6768.0}},
                             'clusters': [{'region': 'us',
                                           'state': 'Ready',
                                           'phaseOffset': 0.0,
                                           'crashes': 1,
                                           'reachable': True,
                                           'partitions': 0,
                                           'placements': 4353,
                                           'nodes': 5120,
                                           'resourceVersion': 170958,
                                           'pendingGangs': 179},
                                          {'region': 'eu',
                                           'state': 'Ready',
                                           'phaseOffset': 200.0,
                                           'crashes': 0,
                                           'reachable': True,
                                           'partitions': 0,
                                           'placements': 920,
                                           'nodes': 5120,
                                           'resourceVersion': 36186,
                                           'pendingGangs': 0},
                                          {'region': 'ap',
                                           'state': 'Ready',
                                           'phaseOffset': 400.0,
                                           'crashes': 0,
                                           'reachable': True,
                                           'partitions': 0,
                                           'placements': 1063,
                                           'nodes': 5120,
                                           'resourceVersion': 41843,
                                           'pendingGangs': 0}]},
         'stage2 ticks': 10}}


class _RecordedDrfOrders:
    """While active, keeps the inputs of the first ``first`` DRF ordering
    passes made by an order view with a usage override (``every``: of any
    pass). In (psi) only the federation router's spill pass gives one: the
    global order over the level-3 fold."""

    def __init__(self, first, every=False):
        self.first, self.calls, self._usage, self.every = first, [], [False], every

    def __enter__(self):
        from grove_tpu_torch.quota import manager
        from grove_tpu_torch.solver import introspect

        self._saved = [(manager, "fair_order", manager.fair_order),
                       (introspect, "order_view", introspect.order_view)]
        order, view = (fn for _, _, fn in self._saved)

        def record(deserved, usage, demand, counts, device=None):
            if (self.every or self._usage[-1]) and len(self.calls) < self.first:
                self.calls.append(tuple(np.array(a) for a in (deserved, usage, demand, counts)))
            return order(deserved, usage, demand, counts, device=device)

        def order_view(scheduler, specs, queue_crs=None, usage=None):
            self._usage.append(usage is not None)
            try:
                return view(scheduler, specs, queue_crs=queue_crs, usage=usage)
            finally:
                self._usage.pop()

        manager.fair_order = record
        introspect.order_view = order_view
        return self

    def __exit__(self, *exc):
        for holder, name, fn in self._saved:
            setattr(holder, name, fn)
        return False


def check_recorded_orders(recorded, phase, device="cuda") -> int:
    """Each recorded DRF pass through the kernels and through the plain
    order twin on the CPU, equal bit for bit. The launches made here are
    not counted (the counters are restored)."""
    from grove_tpu_torch.quota.ordering import fair_order, merge_cuda, share_table_cuda

    if not recorded.calls:
        _fail(f"{phase}: no DRF pass was recorded")
    if device == "cpu":
        return 0
    counts = share_table_cuda.launches, merge_cuda.launches
    for i, inputs in enumerate(recorded.calls):
        got = fair_order(*inputs, device="cuda")
        want = fair_order(*inputs, device="cpu")
        if not np.array_equal(got, want):
            _fail(f"{phase}: DRF pass {i} on the card != the plain order twin")
        q, g, r = inputs[2].shape
        print(f"[{phase}] DRF pass {i}: Q={q} G={g} R={r}, {len(got)} rows:"
              f" kernels == plain twin bit for bit", flush=True)
    share_table_cuda.launches, merge_cuda.launches = counts
    return len(recorded.calls)


def phase_federation(card, device="cuda", reference=None, worlds=("mu", "chi", "psi"),
                     n_nodes=None, stage1_each=None, stage2_each=None) -> dict:
    """[federation] (mu), (chi) and (psi) through the port on the card (see
    the module docstring, item 22), each held to JAX_FEDERATION_REFERENCE
    (``reference`` replaces it; a CPU rehearsal passes a cut's). Launch
    counts are set to 0 just before each world and read just after it, and
    for (psi) at each step."""
    from grove_tpu_torch.models.scenarios import (
        FEDERATION_STAGE1_EACH,
        FEDERATION_STAGE2_EACH,
        chaos_missing,
        port_names,
        run_chaos_matrix,
        run_federation_world,
        run_serving_world,
    )
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda

    ref = JAX_FEDERATION_REFERENCE if reference is None else reference
    if ref is None:
        _fail("federation: JAX_FEDERATION_REFERENCE is missing")
    pkg = port_names(device)
    t_phase = time.perf_counter()
    out = {}

    def zero():
        fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0

    def launches():
        return {"fill": fill_batch.launches, "drf_shares": share_table_cuda.launches,
                "drf_merge": merge_cuda.launches}

    if "mu" in worlds:
        zero()
        got = run_serving_world(pkg, device=device)
        walls = got.pop("walls")
        n = launches()
        for key in ("serving", "remediation"):
            _check_same(f"federation (mu) {key}", got[key], ref["mu"][key])
        out["mu"] = {**walls, **{f"{k}_launches": v for k, v in n.items()}}
        # the p99 is a log bucket's midpoint, 1.5 * 2**k µs, of the bucket
        # [2**k, 2**(k+1)) µs (observability/timeseries.bucket_value)
        p99 = walls["admission_p99_s"]
        print(f"[federation] (mu) serving_artifact(2026, 2, 16, 900) and"
              f" remediation_artifact(2026, 3, 24, 1200) equal to the JAX package's less their"
              f" wall fields: serving {walls['serving_s']:.3f} s, admission p99 through the flash"
              f" crowd in [{p99 / 1.5 * 1e3:.3f}, {p99 / 0.75 * 1e3:.3f}) ms (bucket value"
              f" {p99:.6f} s; p99 < 1 s: {walls['p99_lt_1s']}),"
              f" remediation (OFF and ON days) {walls['remediation_s']:.3f} s; launches fill"
              f" {n['fill']}, DRF {n['drf_shares']} + {n['drf_merge']} | {card}", flush=True)
    if "chi" in worlds:
        def after_run(name, wall_s):
            print(f"[federation] (chi) {name}: {wall_s:.3f} s", flush=True)

        zero()
        got = run_chaos_matrix(pkg, device=device, after_run=after_run)
        walls = got.pop("walls")
        n = launches()
        missing = chaos_missing(got)
        if missing:
            _fail(f"federation (chi): verdicts not ok: {missing}")
        _check_same("federation (chi) runs", sorted(got), sorted(ref["chi"]))
        for name in got:
            _check_same(f"federation (chi) {name}", got[name], ref["chi"][name])
        out["chi"] = {"walls": walls, **{f"{k}_launches": v for k, v in n.items()}}
        print(f"[federation] (chi) {len(got)} chaos runs equal to the JAX package's less their"
              f" wall fields, every verdict ok, in {sum(walls.values()):.3f} s; launches fill"
              f" {n['fill']}, DRF {n['drf_shares']} + {n['drf_merge']} | {card}", flush=True)
    if "psi" in worlds:
        steps = {}
        last = {"fill": 0, "drf_shares": 0, "drf_merge": 0}

        def after_step(stage, name, wall_s):
            now = launches()
            steps[f"{stage} {name}"] = {k: now[k] - last[k] for k in now}
            last.update(now)

        zero()
        with _RecordedKernelFills(FEDERATION_FILL_CALLS) as fills, \
                _RecordedDrfOrders(FEDERATION_DRF_CALLS) as orders:
            got = run_federation_world(
                pkg, n_nodes=n_nodes or ref["psi"]["world"]["nodes_per_region"],
                stage1_each=stage1_each or FEDERATION_STAGE1_EACH,
                stage2_each=stage2_each or FEDERATION_STAGE2_EACH, device=device,
                after_step=after_step)
        walls = got.pop("walls")
        n = launches()
        _check_same("federation (psi) steps", sorted(got), sorted(ref["psi"]))
        for key in got:
            _check_same(f"federation (psi) {key}", got[key], ref["psi"][key])
        for key, summary in got.items():
            if key in ("world", "stage1 crash result", "stage2 ticks"):
                continue
            print(f"[federation] (psi) {key}: {walls[key]:.3f} s; spillovers"
                  f" {summary['spillovers']}, re-routes {summary['reroutes']}, ledger"
                  f" {summary['decisions']} {summary['decisions_by_kind']}, fold"
                  f" {summary['foldDepthHistogram']}; regions"
                  f" {[(c['region'], c['state'], c['placements'], c.get('pendingGangs')) for c in summary['clusters']]};"
                  f" launches {steps[key]}", flush=True)
        spilled = got["stage2 converge"]["spillovers"] - got["stage2 apply"]["spillovers"]
        if spilled < 1:
            _fail("federation (psi): stage 2 did not spill")
        if device != "cpu" and not all(n.values()):
            _fail(f"federation (psi): the fill and both DRF kernels must launch: {n}")
        fill_err = check_recorded_fills(fills, "federation", device)
        drf_checked = check_recorded_orders(orders, "federation", device)
        out["psi"] = {"world": got["world"], "walls": walls, "steps": steps,
                      "crash": got["stage1 crash result"], "stage2_spills": spilled,
                      "stage2_ticks": got["stage2 ticks"],
                      **{f"{k}_launches": v for k, v in n.items()},
                      "fill_calls_checked": len(fills.calls), "fill_max_abs_err": fill_err,
                      "drf_passes_checked": drf_checked}
        print(f"[federation] (psi) {got['world']['nodes_per_region']} nodes a region x 3, stage 1"
              f" {3 * got['world']['stage1_each']} sets (crash of us: {got['stage1 crash result']}),"
              f" stage 2 {3 * got['world']['stage2_each']} sets, {got['stage2 ticks']} ticks,"
              f" {spilled} spills: every step equal to the JAX package's; launches fill"
              f" {n['fill']}, DRF {n['drf_shares']} + {n['drf_merge']}; {len(fills.calls)} fill"
              f" calls and {drf_checked} global-usage DRF passes equal to their plain twins bit"
              f" for bit | {card}", flush=True)
    worlds_out = list(out.values())
    for key in ("fill", "drf_shares", "drf_merge"):
        out[f"{key}_launches"] = sum(w.get(f"{key}_launches", 0) for w in worlds_out)
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# [cli]: the port's entry points as users run them, each command a process of
# its own (models/scenarios.run_cli_sim, run_cli_live)
CLI_FILL_CALLS = 4  # the in-process apply's first fill calls held against the plain fill
CLI_DRF_CALLS = 2  # and the in-process queues' first DRF passes against the plain twin
CLI_PARALLEL = 6  # sim-mode commands at a time
CLI_LINT_SUPPRESSIONS = 9  # the JAX package's grovelint pragmas, restored at the port's sites

# scripts/scheduler_reference.py cli (PYTHONHASHSEED=0)
JAX_CLI_REFERENCE = {'live': {'apply': {'lines': 1,
                                        'rc': 0,
                                        'sha256': 'df611c1e62b3414241a373c76d941769cb7765a6f99517ee5d7cf6236a6f129e'},
                              'capacity': {'lines': 8,
                                           'rc': 0,
                                           'sha256': 'db90f5e25d6a93204cce88468160e797e5ffc550125bea523c4d7f2c19d2cc4a'},
                              'delete': {'lines': 1,
                                         'rc': 0,
                                         'sha256': '275e906a10823346a959a644cf6508d687eed9dbec66594760fc06f9ae664892'},
                              'describe': {'lines': 23,
                                           'rc': 0,
                                           'sha256': 'f5db73d11541124b4bbfa218f3543ffb962cf6244868dd3558348d030b434a2e'},
                              'drain': {'lines': 1,
                                        'rc': 0,
                                        'sha256': 'd54efb9d98243499d6dbc0bd986be81c9eec253e915c787dc5d19472ce734ee2'},
                              'explain': {'lines': 1,
                                          'rc': 0,
                                          'sha256': 'af580fb463810e63cceb9af16554f16deff06c2e1409e92359c524f5918a8623'},
                              'get': {'lines': 63,
                                      'rc': 0,
                                      'sha256': '05e5bcbee9f277f0030307bc349966236802df03a2230cf98cdf75d7b2326c4e'},
                              'initc': {'lines': 1,
                                        'rc': 0,
                                        'sha256': '4280c666460ce8d1d218eef8896f4e378214b66f35d24ba55a2da5954dee0a1f'},
                              'journey': {'rc': 0},
                              'nodes': {'rc': 0},
                              'profile': {'rc': 0},
                              'queues': {'lines': 2,
                                         'rc': 0,
                                         'sha256': 'c3ffce84ab581774e281e9cb7fa0925a86ca49c3f5f6c01314eaae76009efd96'},
                              'run': {'rc': 0},
                              'scale': {'lines': 1,
                                        'rc': 0,
                                        'sha256': 'c02567046bc66a14ca9ff34cb264c650addb6da81402da84121d9ad3611f7b70'},
                              'trace': {'rc': 0},
                              'tree': {'lines': 16,
                                       'rc': 0,
                                       'sha256': '7c988802358934518bbd16650ee2717317187d38aae7bdfde4ad1a130b1c149a'},
                              'tree scaled': {'lines': 31,
                                              'rc': 0,
                                              'sha256': '8e7732370b10f7dffb77483c759c8a9a667a53a515805f1f5600d7385a753316'},
                              'uncordon': {'lines': 1,
                                           'rc': 0,
                                           'sha256': '563d2ffdd1ee8d0caa9289c9dddf211df6c01f50b16ee89c61aa266d162ccac0'},
                              'whatif': {'lines': 3,
                                         'rc': 0,
                                         'sha256': '63eb9151a1944d1254e3be9f9821767e894e3481c7533946791ed81a016985c7'}},
                     'sim': {'api-docs': {'lines': 575,
                                          'rc': 0,
                                          'sha256': 'a17144515013fa96145ef4d632460dc5c6871efa3e02bdf8b5f3d3622160874b'},
                             'apply': {'lines': 19,
                                       'rc': 0,
                                       'sha256': 'f652388dc44ec7a2318db60d30acfa212b77c9cfe09677288716923455738645'},
                             'capacity': {'lines': 8,
                                          'rc': 0,
                                          'sha256': 'cec99af05ef5e621131b594606c5a173ad518bb543535e40caa3e700e4d4d73b'},
                             'config-check': {'lines': 1,
                                              'rc': 0,
                                              'sha256': '128d73ccb206d92ef72474f4615f4bf466d917f99ee627e39ae0f22203414fc0'},
                             'crds': {'lines': 861,
                                      'rc': 0,
                                      'sha256': '5b6c962b7dee1870a4a9b55413e51ddd573560e9af1a180eafb5a528e426c1aa'},
                             'describe': {'lines': 23,
                                          'rc': 0,
                                          'sha256': '3e78d233290c6232e8527e556b93a1d2b0f63c5db8b796c53fbfbdc7dc10dfbf'},
                             'detect-topology': {'lines': 17,
                                                 'rc': 0,
                                                 'sha256': '753a88091e1928c91c7c6a7157d35ffaeca9a8c1c102837b24b9a31e19937c89'},
                             'explain': {'lines': 1,
                                         'rc': 0,
                                         'sha256': 'af580fb463810e63cceb9af16554f16deff06c2e1409e92359c524f5918a8623'},
                             'get': {'lines': 63,
                                     'rc': 0,
                                     'sha256': 'ca05e00c047dc1b9ce181fc58cd62850a4f5c2817e54b2267a686e3667e6a59a'},
                             'journey': {'lines': 12,
                                         'rc': 0,
                                         'sha256': '0bd55037c1a96fe093f08b6d8e75df9b96a95537c96d34039d9dfe61902c8e98'},
                             'nodes': {'lines': 5121,
                                       'rc': 0,
                                       'sha256': 'dcbc6a7e8c7aa54f79c8736bb84366a6095a0b3de55760eb441435a753b94200'},
                             'profile': {'lines': 35,
                                         'rc': 0,
                                         'sha256': '44965c79b1c0bcce11528bbe0d067bdc91af6fbaa50b676bdd589f4b3013140e'},
                             'queues': {'lines': 3,
                                        'rc': 0,
                                        'sha256': 'c13f745013bc331dc95973445f264e27a89f13c807199f36621e48fc79029257'},
                             'trace': {'lines': 95,
                                       'rc': 0,
                                       'sha256': '27068e9f347cf74dd3fb9df9c6060adc5bff6ff9f2c4c5a2e0d340ec951cdf9c'},
                             'tree': {'lines': 30,
                                      'rc': 0,
                                      'sha256': '96fc2af6adf3dd817047dec4944cff366ba77327bac8fc95e672973e1d23f149'},
                             'validate': {'lines': 13,
                                          'rc': 0,
                                          'sha256': 'ef64f2a168e83d14fc4d7ecfc169f3136f27ad75464ca48fd0c2ab134fc3225a'},
                             'whatif': {'lines': 3,
                                        'rc': 0,
                                        'sha256': '63eb9151a1944d1254e3be9f9821767e894e3481c7533946791ed81a016985c7'}},
                     'world': {'nodes': 5120}}


def phase_cli(card, device="cuda", reference=None) -> dict:
    """[cli] the port's entry points (grove_tpu_torch/cli.py, __main__.py,
    initc/__main__.py) as users run them, held to JAX_CLI_REFERENCE. Sim
    mode: every sim-backed subcommand at full width (``python -m
    grove_tpu_torch <sub> ... --nodes 5120`` over samples/, CLI_PARALLEL at
    a time) and the host-only ones. Live mode: ``run --tls --authorizer``
    on 5,120 nodes as a child, the commands against its apiserver, the
    initc waiter for the gang simple1-0 (exit 0 once its parents are
    Ready) and SIGINT (exit 0). Each command's exit code equals the JAX
    CLI's, and so does its stdout (less the uid's token, the apiserver's
    address and, in trace, profile and journey, the durations) for every
    sim-mode command and the live ones of CLI_LIVE_STDOUT, whose output
    the converged state alone sets (the JAX runs must have repeated it).
    Then ``cli.main`` in this process for apply and queues
    (queues' two Queue CRs run the DRF order), their fill and DRF launches
    counted and their first calls held against the plain versions bit for
    bit; beside it all, ``scripts/torch_lint.py --json`` exits 0 with no
    violation and CLI_LINT_SUPPRESSIONS suppressions. On the card the CLI
    runs on its default device (no ``--device``)."""
    import io
    import pathlib
    import shutil
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    from grove_tpu_torch import cli as port_cli
    from grove_tpu_torch.models.scenarios import (
        CLI_LIVE_STDOUT,
        CLI_QUEUE_SAMPLE,
        CLI_SAMPLE,
        CLUSTER_CONFIG_YAML,
        cli_digest,
        cli_sim_commands,
        mask_cli_stdout,
        run_cli_live,
        run_cli_sim,
    )
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda

    ref = JAX_CLI_REFERENCE if reference is None else reference
    if ref is None:
        _fail("cli: JAX_CLI_REFERENCE is missing")
    n = ref["world"]["nodes"]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONHASHSEED="0")
    dev_args = [] if device == "cuda" else ["--device", str(device)]
    cli = [sys.executable, "-m", "grove_tpu_torch"] + dev_args
    initc = [sys.executable, "-m", "grove_tpu_torch.initc"]
    t_phase = time.perf_counter()
    walls, wrong = {}, []

    def check(mode, name, res, want, apiserver=None):
        got = cli_digest(name, res["rc"], res["stdout"], apiserver)
        held = "sha256" in want
        same = got == want if held else got["rc"] == want["rc"]
        walls[f"{mode} {name}"] = res["wall_s"]
        print(f"[cli] {mode} {name}: {res['wall_s']:.3f} s, exit {res['rc']},"
              f" {'stdout' if held else 'exit code'} {'==' if same else '!='} JAX's", flush=True)
        if not same:
            wrong.append(f"{mode} {name}")
            head = mask_cli_stdout(name, res["stdout"], apiserver).splitlines()[:20]
            print("\n".join(["[cli]   stdout (masked) begins:", *head,
                             "[cli]   stderr ends:", *res.get("stderr", "").splitlines()[-20:]]),
                  flush=True)

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        return fn(*args, **kw), time.perf_counter() - t0

    tmp = tempfile.mkdtemp(prefix="grove-cli-")
    config = os.path.join(tmp, "operator-config.yaml")
    with open(config, "w") as f:
        f.write(CLUSTER_CONFIG_YAML)
    # sim mode, live mode and the in-process commands at once: each command
    # pays a process start, `import torch`, the card's probe child and a
    # CUDA context, which overlap
    pool = ThreadPoolExecutor(max_workers=2)
    lint = subprocess.Popen([sys.executable, "scripts/torch_lint.py", "--json"], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        sim_f = pool.submit(timed, run_cli_sim, cli,
                            cli_sim_commands(n, config, pathlib.Path(root)), root, env,
                            parallel=CLI_PARALLEL)
        live_f = pool.submit(timed, run_cli_live, cli, initc, n, root, env)
        fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0
        in_process = {}
        with _RecordedKernelFills(CLI_FILL_CALLS) as fills, \
                _RecordedDrfOrders(CLI_DRF_CALLS, every=True) as orders:
            for name, argv in (("apply", ["apply", CLI_SAMPLE]),
                               ("queues", ["queues", CLI_QUEUE_SAMPLE])):
                buf, t0 = io.StringIO(), time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = port_cli.main(dev_args + argv + ["--nodes", str(n)])
                in_process[name] = {"rc": rc, "stdout": buf.getvalue(),
                                    "wall_s": time.perf_counter() - t0}
        launches = {"fill": fill_batch.launches, "drf_shares": share_table_cuda.launches,
                    "drf_merge": merge_cuda.launches}
        (sim, sim_s), (live, live_s) = sim_f.result(), live_f.result()
        stdout, stderr = lint.communicate(timeout=PHASE_PROCESS_TIMEOUT_S)
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
        if lint.poll() is None:
            lint.kill()
            lint.wait()
    _check_same("cli sim commands", sorted(sim), sorted(ref["sim"]))
    for name, res in sim.items():
        check("sim", name, res, ref["sim"][name])
    url = live.pop("apiserver")
    walls["live boot"] = live.pop("boot")["wall_s"]
    _check_same("cli live commands", sorted(live), sorted(ref["live"]))
    for name, res in live.items():
        check("live", name, res, ref["live"][name], url)
    for name in CLI_LIVE_STDOUT:
        if "sha256" not in ref["live"][name]:
            _fail(f"cli: the JAX live runs did not repeat {name}'s stdout")
    for name, res in in_process.items():
        check("in-process", name, res, ref["sim"][name])
    if device != "cpu" and not all(launches.values()):
        _fail(f"cli: the CLI's apply and queues must launch the fill and both DRF kernels:"
              f" {launches}")
    fill_err = check_recorded_fills(fills, "cli", device)
    drf_checked = check_recorded_orders(orders, "cli", device)
    if lint.returncode != 0:
        _fail(f"cli: scripts/torch_lint.py --json exited {lint.returncode}:\n{stdout[-3000:]}"
              f"{stderr[-3000:]}")
    doc = json.loads(stdout)
    lint_out = {"files": doc["files_scanned"], "violations": len(doc["violations"]),
                "suppressions": doc["suppression_count"], "drift": doc["drift"]}
    if lint_out["violations"] or lint_out["suppressions"] != CLI_LINT_SUPPRESSIONS or doc["drift"]:
        _fail(f"cli: grovelint over the port: {lint_out}")
    if wrong:
        _fail(f"cli: {len(wrong)} commands differ from the JAX CLI's: {wrong}")
    out = {"nodes": n, "sim_s": sim_s, "live_s": live_s, "walls": walls,
           **{f"{k}_launches": v for k, v in launches.items()},
           "fill_calls_checked": len(fills.calls), "fill_max_abs_err": fill_err,
           "drf_passes_checked": drf_checked, "lint": lint_out,
           "wall_s": time.perf_counter() - t_phase}
    print(f"[cli] {len(sim)} commands in sim mode at {n} nodes ({sim_s:.3f} s, {CLI_PARALLEL} at a"
          f" time) and {len(live)} in live mode against a `run` child ({live_s:.3f} s), every exit"
          f" code and every stdout held equal to the JAX CLI's; initc exit"
          f" {live['initc']['rc']}, the operator's exit on SIGINT {live['run']['rc']}; in-process"
          f" apply and queues: launches fill {launches['fill']}, DRF {launches['drf_shares']} +"
          f" {launches['drf_merge']}, {len(fills.calls)} fill calls and {drf_checked} DRF passes"
          f" equal to their plain twins bit for bit; grovelint {lint_out['files']} files,"
          f" {lint_out['violations']} violations, {lint_out['suppressions']} suppressions, drift"
          f" {len(lint_out['drift'])} | {card}", flush=True)
    return out


def phase_operator_chain(card) -> dict:
    """[sharded] with [operator] and [churn] beside its rank worlds, then
    [scale] and [sims], with (pi), [cluster] and [parallel] in processes of
    their own, as one chain in main()'s process for it. (pi) sets [scale]'s
    wall, so its process starts as soon as [sharded]'s rank worlds have
    ended, beside the rest of [operator] and [churn]; (tau) ([cluster]) is
    host Python over HTTP on one core and starts with it; [parallel] with
    [scale]'s codec A/B, whose process drains fork, starts with [scale] and
    yields the cores (PARALLEL_NICE). Those processes are fork and exec,
    so none inherits a thread of this one. Returns each phase's record."""
    parts, cluster_part = [], []

    def after_ranks():
        parts.append(_PhaseProcess(card, {"phase_scale_parallel": {}}))
        cluster_part.append(_PhaseProcess(card, {"phase_cluster": {}}))

    try:
        # [sharded]'s ranks run beside [operator] and [churn], which time no
        # kernel
        sharded = _timed(phase_sharded, lambda: _timed(
            phase_operator, card, "cuda", None, None, None, None,
            lambda harness: phase_churn(harness, card)), after_ranks)
        operator = sharded.pop("alongside")
        churn = operator.pop("then")
        if len(parts) != 1 or len(cluster_part) != 1:
            _fail("[scale] (pi), [cluster]: their processes did not start after [sharded]'s"
                  " rank worlds")
        parts.append(_PhaseProcess(card, {"phase_parallel": {}, "phase_scale_codec": {}},
                                   nice=PARALLEL_NICE))
        scale = _timed(phase_scale, card, "cuda", None, None, None, None, None, parts)
        sims = _timed(phase_sims, card)
        parallel = parts[1].result()["phase_parallel"]
        cluster = cluster_part[0].result()["phase_cluster"]
    finally:
        for part in parts + cluster_part:
            part.kill()
    return {"sharded": sharded, "operator": operator, "churn": churn, "scale": scale,
            "sims": sims, "parallel": parallel, "cluster": cluster}


def _is_float(text: str) -> bool:
    try:
        float(text)
    except ValueError:
        return False
    return True


def _timed(phase, *args):
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[smoke] {phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _pin_string_hash()
    t_start = time.perf_counter()
    card = _timed(phase_device)
    _timed(phase_build)
    timing = _timed(phase_kernel_vs_plain)
    cases = _timed(phase_path_shapes)
    # Every phase that needs nothing of an earlier one runs in a process of
    # its own (_PhaseProcess) beside this one's chain, started where it slows
    # that chain least: [federation] (host Python, niced) once the fill's
    # timings are taken; [disruption] and the chain [sharded] ... [sims]
    # (phase_operator_chain) once [main] and [stats] have timed their solves
    # beside it alone; [cli] (niced), whose commands start a CUDA context
    # each, once [frontier] is done, beside phases that time no solve
    side = {}
    try:
        side["federation"] = _PhaseProcess(card, {"phase_federation": {}},
                                           nice=PARALLEL_NICE)
        main_path = _timed(phase_main_path)
        stats = _timed(phase_stats_path)
        side["operator"] = _PhaseProcess(card, {"phase_operator_chain": {}})
        side["disruption"] = _PhaseProcess(card, {"phase_disruption": {}})
        _timed(phase_path_kernel_vs_plain)
        sched = _timed(phase_scheduler)
        drf = _timed(phase_drf, sched["q_order_inputs"])
        delta = _timed(phase_delta)
        front = _timed(phase_frontier, delta["rounds"][0])
        side["cli"] = _PhaseProcess(card, {"phase_cli": {}}, nice=PARALLEL_NICE)
        observe = _timed(phase_observe, sched["rounds"]["q1"]["wall_s"], card)
        sidecar = _timed(phase_sidecar, main_path, card)
        slo = _timed(phase_slo, delta, card)
        chain = side["operator"].result()["phase_operator_chain"]
        disruption = side["disruption"].result()["phase_disruption"]
        federation = side["federation"].result()["phase_federation"]
        cli = side["cli"].result()["phase_cli"]
    finally:
        for part in side.values():
            part.kill()
    sharded, operator, churn, scale, sims, parallel, cluster = (
        chain[k] for k in ("sharded", "operator", "churn", "scale", "sims", "parallel",
                           "cluster"))
    kernel = {
        "name": "fill_batch",
        "route": "cuda",
        "source": "grove_tpu_torch/csrc/fill.cu",
        "replaces": "grove_tpu/ops/pallas_fill.py:69",
        "launches": main_path["launches"] + stats["fill_launches"] + stats["exact_fill_launches"]
        + sched["fill_launches"] + delta["fill_launches"] + front["fill_launches"]
        + sharded["single_fill_launches"] + sharded["fill_launches"]
        + observe["fill_launches"] + observe["explain_fill_launches"]
        + sidecar.get("a", {}).get("fill_launches", 0) + sidecar.get("q", {}).get("fill_launches", 0)
        + slo["fill_launches"] + disruption["fill_launches"]
        + operator["fill_launches"] + operator["samples_fill_launches"]
        + churn["fill_launches"] + scale["fill_launches"] + sims["fill_launches"]
        + parallel["fill_launches"] + cluster["fill_launches"] + cluster["ext_fill_launches"]
        + federation["fill_launches"] + cli["fill_launches"],
        "sidecar_launches": sidecar.get("a", {}).get("fill_launches", 0)
        + sidecar.get("q", {}).get("fill_launches", 0),
        "slo_launches": slo["fill_launches"],
        "disruption_launches": disruption["fill_launches"],
        "operator_launches": operator["fill_launches"] + operator["samples_fill_launches"],
        "churn_launches": churn["fill_launches"],
        "scale_launches": scale["fill_launches"],
        "sims_launches": sims["fill_launches"],
        "parallel_launches": parallel["fill_launches"],
        "cluster_launches": cluster["fill_launches"] + cluster["ext_fill_launches"],
        "federation_launches": federation["fill_launches"],
        "cli_launches": cli["fill_launches"],
        "frontier_stacked_launches": front["stacked_fill_launches"],
        "explain_launches": observe["explain_fill_launches"],
        "sharded_rank_launches": sharded["fill_launches"],
        "max_abs_err": max([timing["max_abs_err"], front["stacked_fill"]["max_abs_err"],
                            operator["fill_max_abs_err"], churn["fill_max_abs_err"],
                            scale["fill_max_abs_err"], parallel["fill_max_abs_err"],
                            cluster["fill_max_abs_err"], federation["psi"]["fill_max_abs_err"],
                            cli["fill_max_abs_err"]]
                           + [cs["max_abs_err"] for cs in cases]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "cases": [{k: v for k, v in cs.items() if k != "max_abs_err"}
                  for cs in cases + [front["stacked_fill"]]],
    }
    drf_kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": "grove_tpu_torch/csrc/drf.cu",
            "replaces": "grove_tpu/quota/ordering.py:41",
            "launches": sched[f"drf_{phase}_launches"] + delta[f"drf_{phase}_launches"]
            + front[f"drf_{phase}_launches"] + observe[f"drf_{phase}_launches"]
            + observe[f"explain_drf_{phase}_launches"]
            + sidecar.get("q", {}).get(f"drf_{phase}_launches", 0) + slo[f"drf_{phase}_launches"]
            + disruption[f"drf_{phase}_launches"] + operator[f"drf_{phase}_launches"]
            + operator[f"samples_drf_{phase}_launches"] + churn[f"drf_{phase}_launches"]
            + sims[f"drf_{phase}_launches"] + cluster[f"drf_{phase}_launches"]
            + cluster[f"ext_drf_{phase}_launches"] + federation[f"drf_{phase}_launches"]
            + cli[f"drf_{phase}_launches"],
            "sidecar_launches": sidecar.get("q", {}).get(f"drf_{phase}_launches", 0),
            "slo_launches": slo[f"drf_{phase}_launches"],
            "disruption_launches": disruption[f"drf_{phase}_launches"],
            "operator_launches": operator[f"drf_{phase}_launches"]
            + operator[f"samples_drf_{phase}_launches"],
            "explain_launches": observe[f"explain_drf_{phase}_launches"],
            "churn_launches": churn[f"drf_{phase}_launches"],
            "scale_launches": 0,  # (lambda) and (pi) have no Queue CR
            "sims_launches": sims[f"drf_{phase}_launches"],
            "parallel_launches": 0,  # nor the parallel-drain scenarios
            # (tau) and the BASELINE samples have no Queue CR either
            "cluster_launches": cluster[f"drf_{phase}_launches"]
            + cluster[f"ext_drf_{phase}_launches"],
            # (mu)'s quota churn, (chi) and (psi)'s global order over the fold
            "federation_launches": federation[f"drf_{phase}_launches"],
            # the CLI's in-process queues over samples/multitenant-queues.yaml
            "cli_launches": cli[f"drf_{phase}_launches"],
            "max_abs_err": 0.0,  # _fail unless equal bit for bit
            "ms": drf[f"{phase}_ms"],
            "plain_ms": drf[f"plain_{phase}_ms"],
            "bound_ms": drf["bounds"][phase][0],
            "bound_by": drf["bounds"][phase][1],
            "library_ms": None,
        }
        for name, phase in (("drf_shares_kernel", "shares"), ("drf_merge_kernel", "merge"))
    ]
    drf_pass = {k: drf[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "steps",
                                    "merge_past_g_loop_ms", "merge_per_step",
                                    "merge_global_counts")}
    paths = {k: v for k, v in main_path.items() if k not in ("launches", "a_response")}
    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [kernel, *drf_kernels], "main_path": paths, "stats_path": stats,
                      "scheduler": sched["rounds"], "drf_pass": drf_pass,
                      "delta": {k: v for k, v in delta.items() if k != "rounds"},
                      "delta_rounds": delta["rounds"],
                      "frontier": {k: v for k, v in front.items() if k != "rounds"},
                      "frontier_rounds": front["rounds"], "sharded": sharded,
                      "observe": observe, "sidecar": sidecar, "slo": slo,
                      "disruption": disruption, "operator": operator, "churn": churn,
                      "scale": scale, "sims": sims, "parallel": parallel,
                      "cluster": cluster, "federation": federation, "cli": cli}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
