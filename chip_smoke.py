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
     on reduced problems (1,024 nodes; stress and non-uniform at 2,048
     gangs, grouped, pinned and spread at 1,024): the binding path, the
     stats path and the exact solve (of the first 256 gangs), every result
     field bit-equal.
  7. [sched] the scheduler round end to end (solver/scheduler.GangScheduler
     over the port's store and simulated cluster, built from wire documents
     by models/scenarios.scheduler_world) on the card: (s) 10,240 stress
     gangs in one namespace on 5,120 nodes, an admission round and an
     upkeep round; (q) the same gangs over eight tenant queues, one round
     with the DRF order; (r) 512 nodes, 1,024 gangs of one tenant, then 528
     more of three others (16 of priority 100): reclaim and preemption with
     their trial solves. Every round is held against the JAX package's
     (JAX_SCHEDULER_REFERENCE, from scripts/scheduler_reference.py): the
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
     models/scenarios.scheduler_world("delta"): (q)'s round, then 24
     seeded churn ticks (arrivals, departures, pod failures with recovery
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
     round and 16 of its ticks (80 slices of 64 nodes, so 80 subproblems in
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
     multi-GPU speed is implied.
 12. prints the kernels line, the card line, and last the ok line.

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
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
        summary[tag[0]] = {"solve_seconds": s, "admitted": admitted, "gangs": len(specs),
                           "fill_launches": launches}
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
# fill (the binding and stats paths take them all)
EXACT_PATH_GANGS = 256


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
    for tag, specs in (("stress", stress_gang_specs(2048, seed=3)),
                       ("non-uniform", nonuniform_specs(2048, seed=4)),
                       ("grouped", disagg_specs(1024, seed=7)),
                       ("pinned", spread_recovery_specs(1024, 8, 1024, kinds=("recovery",))),
                       ("spread", spread_recovery_specs(1024, 9, 1024, kinds=("spread", "soft")))):
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
    "r": [
        {"admitted": 1024, "bound": 3473, "score_sum": 1011.9702439308167, "bindings": 3473,
         "bindings_sha256": "b67e6d78aeacaef3e858e08eb1d9a387e4c5b87c972375e0c2cba2f38a507fa0",
         "evicted": 0, "evicted_sha256": _NONE, "admitted_per_queue": {"tenant-0": 1024},
         "events_by_reason": {"GangAdmitted": 1024, "PodBound": 3473}},
        {"admitted": 67, "bound": 207, "score_sum": 54.27487090229988, "bindings": 3680,
         "bindings_sha256": "86a0d604696fcf92ad75d738b655e1315ce13f4537e5cf88222f41c065a45035",
         "evicted": 335,
         "evicted_sha256": "55cdbeb1c1ad1c3ce1623bc4699e974a1a5508799654f8bbefc4b9ae10b86ef6",
         "admitted_per_queue": {"tenant-1": 22, "tenant-2": 25, "tenant-3": 20},
         "events_by_reason": {"GangAdmitted": 67, "GangDeferred": 461, "PodBound": 207,
                              "Preempted": 2, "QuotaReclaim": 333}},
    ],
}
SCHED_WORLDS = (("s", "flat"), ("q", "fair-share"), ("r", "preemption + reclaim"))


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


def _span_split(spans) -> dict:
    """A round's time by the tracer's spans: pending scan (with phase and
    health upkeep) + encode, quota order, solve, preemption/reclaim (trial
    solves included) and commit + status writes."""
    def total(names, parent=None):
        return sum(sp.dur_us for sp in spans
                   if sp.name in names and (parent is None or sp.parent == parent)) / 1e6

    trials = sum(1 for sp in spans if sp.name == "scheduler.solve"
                 and sp.parent in ("scheduler.preempt", "quota.reclaim"))
    return {
        "scan_encode_s": total({"scheduler.pending-scan"})
        + total({"scheduler.encode"}, "scheduler.schedule"),
        "quota_order_s": total({"quota.order"}),
        "solve_s": total({"scheduler.solve"}, "scheduler.schedule"),
        "preempt_reclaim_s": total({"scheduler.preempt", "quota.reclaim"}),
        "commit_status_s": total({"scheduler.commit", "scheduler.status-write"}),
        "trial_solves": trials,
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
        world = scheduler_world(name)
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
    """Nearest-rank percentile, as grove_tpu/sim/deltachurn.py reports it."""
    s = sorted(samples)
    k = min(len(s) - 1, max(0, int(round(q * (len(s) - 1) + 0.5)) - 1))
    return s[max(k, int(q * (len(s) - 1)))]


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

    world = scheduler_world("delta")
    if len(JAX_DELTA_REFERENCE) != len(world["ticks"]) + 1:
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
        want = dict(JAX_DELTA_REFERENCE[index])
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
        split = _span_split(spans)
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

    world = scheduler_world("frontier")
    if len(JAX_FRONTIER_REFERENCE) != len(world["ticks"]) + 1:
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
            want = dict(JAX_FRONTIER_REFERENCE[index])
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
            split = _span_split(spans)
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


def phase_sharded() -> dict:
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
    fill kernel and load the parent's build."""
    from grove_tpu_torch.models.scenarios import build_stress_problem
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.parallel.multihost import run_ranks
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
    for world in SHARDED_WORLDS:
        jobs = [("stress", dict(cfg, warmup=True)), ("cluster", {})]
        if world > 1:
            jobs.append(("ring", {"n_nodes": ref["nodes"], "n_gangs": ref["gangs"], "gang": 0}))
        if world == 2:
            jobs.append(("fill", {}))
        t0 = time.perf_counter()
        ranks = run_ranks(jobs, world, device="cuda:0", timeout=SHARDED_TIMEOUT_S,
                          pg_timeout=120)
        wall = time.perf_counter() - t0
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


def _timed(phase, *args):
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[smoke] {phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.perf_counter()
    card = _timed(phase_device)
    _timed(phase_build)
    timing = _timed(phase_kernel_vs_plain)
    cases = _timed(phase_path_shapes)
    main_path = _timed(phase_main_path)
    stats = _timed(phase_stats_path)
    _timed(phase_path_kernel_vs_plain)
    sched = _timed(phase_scheduler)
    drf = _timed(phase_drf, sched["q_order_inputs"])
    delta = _timed(phase_delta)
    front = _timed(phase_frontier, delta["rounds"][0])
    sharded = _timed(phase_sharded)
    kernel = {
        "name": "fill_batch",
        "route": "cuda",
        "source": "grove_tpu_torch/csrc/fill.cu",
        "replaces": "grove_tpu/ops/pallas_fill.py:69",
        "launches": main_path["launches"] + stats["fill_launches"] + stats["exact_fill_launches"]
        + sched["fill_launches"] + delta["fill_launches"] + front["fill_launches"]
        + sharded["single_fill_launches"] + sharded["fill_launches"],
        "frontier_stacked_launches": front["stacked_fill_launches"],
        "sharded_rank_launches": sharded["fill_launches"],
        "max_abs_err": max([timing["max_abs_err"], front["stacked_fill"]["max_abs_err"]]
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
            + front[f"drf_{phase}_launches"],
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
    paths = {k: v for k, v in main_path.items() if k != "launches"}
    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [kernel, *drf_kernels], "main_path": paths, "stats_path": stats,
                      "scheduler": sched["rounds"], "drf_pass": drf_pass,
                      "delta": {k: v for k, v in delta.items() if k != "rounds"},
                      "delta_rounds": delta["rounds"],
                      "frontier": {k: v for k, v in front.items() if k != "rounds"},
                      "frontier_rounds": front["rounds"], "sharded": sharded}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
