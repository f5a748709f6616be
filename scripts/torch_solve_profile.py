"""Where the port's solves spend their time on the GPU.

Runs one of chip_smoke.py's full-width requests on CUDA: (a) the BASELINE
stress request (10,240 gangs x 5,120 nodes), (d) the disaggregated batch
with a per-group ici-block pack (4,096 gangs) or (e) the spread + recovery
batch (2,048 gangs), each on a fresh cluster (smaller with
--gangs/--nodes), through one of the port's solvers (--path): the binding
path (``solver.kernel.solve_waves``), the stats path
(``solve_waves_stats``: the wave loop of ``ops.packing.solve_waves_device``
and the exact tail), the exact solve (``solve``, no allocations) or the
partitioned frontier's stacked path (``stacked``: ``solve_waves_stacked``
over every bucket the frontier stacks for the request's gangs on the free
cluster, as in (phi)'s first round; ``chip_smoke.frontier_stacks``).
Solves once unprofiled (solve_seconds), then once under ``torch.profiler``
(CPU + CUDA activities). Prints one JSON object: wall times, the summed
device time of all kernels, the device busy share (device time / profiled
wall), the number of device events (kernels and copies) in all and per
chunk-wave (per wave on the stats path, per gang on the exact path), fill
launches and their device time, the exact kernel's launches
(``csrc/exact.cu``) and device time, the device time of the spread fill and of
its quota (kernels launched inside them, by profiler range), and the top
kernels by device time. On the stats path it also gives the waves, the
tail's size, and the host time of the wave loop and of the tail.

With --chunk-waves K the profiled binding solve stops after its first K
chunk-waves (the profiler's own cost grows with the events it holds: a
whole solve of (e) does not finish in 15 minutes); with --window-gangs K
(exact path) the profiled solve is that of the first K gangs; every
profiled figure is then that window's. The exact path solves (e) at 3,072
gangs, [path]'s full-width flagged exact solve
(``chip_smoke.flagged_exact_specs``), and every exact solve is one launch
of the exact kernel, so its profile takes the whole solve by default.
With --out, the full profiler table is written to that file.

    python3 scripts/torch_solve_profile.py [--path binding|stats|exact|stacked] [--request a|d|e]
        [--gangs N] [--nodes 5120] [--chunk-waves K] [--window-gangs K] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import disagg_specs, frontier_stacks, spread_recovery_specs  # noqa: E402
from grove_tpu_torch.api.topology import ClusterTopology  # noqa: E402
from grove_tpu_torch.models.scenarios import (  # noqa: E402
    STRESS_CAPACITY,
    build_stress_problem,
    stress_gang_specs,
)
from grove_tpu_torch.ops import packing  # noqa: E402
from grove_tpu_torch.ops.exact import exact_scan  # noqa: E402
from grove_tpu_torch.ops.fill import fill_batch  # noqa: E402
from grove_tpu_torch.sim.cluster import make_nodes  # noqa: E402
from grove_tpu_torch.solver import kernel  # noqa: E402
from grove_tpu_torch.solver.encode import build_problem  # noqa: E402
from grove_tpu_torch.solver.kernel import (  # noqa: E402
    solve,
    solve_waves,
    solve_waves_stacked,
    solve_waves_stats,
)
from grove_tpu_torch.utils.platform import card_info  # noqa: E402

DEFAULT_GANGS = {"a": 10240, "d": 4096, "e": 2048}
# profiler ranges: the spread fill and, inside it, its quota
RANGES = {"spread_fill": "_fill_spread_floors_first", "spread_quota": "_spread_quota"}


def build(request, n_gangs, n_nodes):
    """The request's problem: (a) stress, (d) disaggregated, (e) spread +
    recovery, n_gangs gangs on n_nodes nodes."""
    if request == "a":
        return build_stress_problem(n_nodes, n_gangs)
    nodes = make_nodes(n_nodes, dict(STRESS_CAPACITY), 8, 8)
    specs = (disagg_specs(n_gangs, seed=5) if request == "d"
             else spread_recovery_specs(n_gangs, seed=6, n_nodes=n_nodes))
    return build_problem(nodes, specs, ClusterTopology())


class Stacked:
    """The frontier's stacks of the request's gangs on a free cluster, read
    as the profile reads a problem: its solve runs every stack through
    ``solve_waves_stacked``; ``num_gangs`` counts the real lanes' gang rows."""

    def __init__(self, request, n_gangs, n_nodes):
        nodes = make_nodes(n_nodes, dict(STRESS_CAPACITY), 8, 8)
        specs = {"a": lambda: stress_gang_specs(n_gangs, seed=0),
                 "d": lambda: disagg_specs(n_gangs, seed=5),
                 "e": lambda: spread_recovery_specs(n_gangs, seed=6, n_nodes=n_nodes)}[request]()
        self.stacks = frontier_stacks(nodes, specs, ClusterTopology())
        self.num_gangs = sum(p.num_gangs for lanes, _ in self.stacks for p in lanes)

    def solve(self):
        outs = [(len(lanes), solve_waves_stacked(stack, device="cuda"))
                for lanes, stack in self.stacks]
        return SimpleNamespace(
            solve_seconds=sum(out["solve_seconds"] for _, out in outs),
            admitted=np.concatenate([out["admitted"][:n].ravel() for n, out in outs]),
            dispatches=sum(out["dispatches"] for _, out in outs),
            lanes=[(n, out["admitted"].shape[0]) for n, out in outs],
        )


class _WindowEnd(Exception):
    """Ends the profiled solve after its window of chunk-waves."""


def instrument():
    """Count chunk-waves (chunk decisions: calls of the binding path's
    solve_wave_chunk and of the stats path's wave_chunk_core), end a solve
    once the count reaches ``calls[1]`` (when set), and put a profiler range
    around the spread fill and its quota; returns [count, limit]."""
    from torch.profiler import record_function

    calls = [0, None]

    def counted(fn):
        def wrapper(*args, **kw):
            if calls[1] is not None and calls[0] >= calls[1]:
                raise _WindowEnd
            calls[0] += 1
            return fn(*args, **kw)
        return wrapper

    kernel.solve_wave_chunk = counted(kernel.solve_wave_chunk)
    packing.wave_chunk_core = counted(packing.wave_chunk_core)
    for label, name in RANGES.items():
        fn = getattr(packing, name)

        def ranged(*args, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*args, **kw)

        setattr(packing, name, ranged)
    return calls


class StatsParts:
    """Host time of the stats path's wave loop and of its exact tail, its
    waves and the tail's size (wraps kernel.solve_waves_device and
    kernel.solve; the wave loop's time ends in a device sync)."""

    def __init__(self):
        self.wave_s = self.tail_s = 0.0
        self.waves = self.tail = 0
        wave_solve, tail_solve = kernel.solve_waves_device, kernel.solve

        def timed_waves(*args, **kw):
            t0 = time.perf_counter()
            out = wave_solve(*args, **kw)
            torch.cuda.synchronize()
            self.wave_s = time.perf_counter() - t0
            self.waves = out["waves"]
            return out

        def timed_tail(problem, **kw):
            res = tail_solve(problem, **kw)
            self.tail_s, self.tail = res.solve_seconds, int(problem.num_gangs)
            return res

        kernel.solve_waves_device, kernel.solve = timed_waves, timed_tail


def range_device_s(events, label):
    """Device time of the kernels launched inside a profiler range (None
    when the profiler attributes none to it)."""
    for e in events:
        if e.key == label:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0.0)
            return us / 1e6
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("binding", "stats", "exact", "stacked"),
                    default="binding")
    ap.add_argument("--request", choices=sorted(DEFAULT_GANGS), default="a")
    ap.add_argument("--gangs", type=int, default=None)
    ap.add_argument("--nodes", type=int, default=5120)
    ap.add_argument("--chunk-waves", type=int, default=None)
    ap.add_argument("--window-gangs", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = ", ".join(card_info())
    gangs = args.gangs or (3072 if (args.path, args.request) == ("exact", "e")
                           else DEFAULT_GANGS[args.request])
    make = Stacked if args.path == "stacked" else build
    problem = make(args.request, gangs, args.nodes)
    run = {
        "binding": lambda p: solve_waves(p, device="cuda"),
        "stats": lambda p: solve_waves_stats(p, device="cuda"),
        "exact": lambda p: solve(p, with_alloc=False, device="cuda"),
        "stacked": lambda p: p.solve(),
    }[args.path]
    run(make(args.request, 256, 256))  # build + warm up

    chunk_waves = instrument()
    parts = StatsParts() if args.path == "stats" else None
    fill_batch.launches = exact_scan.launches = 0
    plain = run(problem)
    fills, exacts = fill_batch.launches, exact_scan.launches
    waves = chunk_waves[0]
    stats_parts = None if parts is None else {
        "waves": parts.waves, "tail_gangs": parts.tail, "wave_loop_s": parts.wave_s,
        "tail_s": parts.tail_s, "host_s_per_wave": parts.wave_s / max(parts.waves, 1),
    }

    from torch.profiler import ProfilerActivity, profile

    window_problem = problem
    if args.path == "exact" and args.window_gangs and args.window_gangs < gangs:
        window_problem = build(args.request, args.window_gangs, args.nodes)
    if args.path in ("binding", "stacked"):
        chunk_waves[:] = [0, args.chunk_waves]
    else:
        chunk_waves[:] = [0, None]
    fill_batch.launches = 0
    profiled = None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        try:
            profiled = run(window_problem)
        except _WindowEnd:
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    window = chunk_waves[0]
    window_fills = fill_batch.launches
    events = prof.key_averages()
    # device-side events only (kernels and copies, one per launch): the
    # aten ops that launched them carry the same device time again, and the
    # ranges' own spans on the device track (idle gaps included) are not
    # kernels
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and e.name not in RANGES]
    per_name = {}
    for e in kernels:
        us, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    device = sorted(((k, us, n) for k, (us, n) in per_name.items()), key=lambda x: -x[1])
    device_us = sum(us for _, us, _ in device)
    out = {
        "card": card,
        "path": args.path,
        "request": args.request,
        "gangs": gangs,
        "nodes": args.nodes,
        "solve_seconds": plain.solve_seconds,
        "admitted": int(plain.admitted.sum()),
        "profiled_gangs": window_problem.num_gangs,
        "profiled_chunk_waves": window,
        "profiled_wall_s": wall,
        "profiled_admitted_equal": (
            None if profiled is None or window_problem is not problem
            else bool((profiled.admitted == plain.admitted).all())
        ),
        "device_kernel_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "device_events": len(kernels),
        "chunk_waves": waves,
        "device_events_per_chunk_wave": len(kernels) / max(window, 1),
        "fill_launches": fills,
        "profiled_fill_launches": window_fills,
        "fill_device_s": sum(us for k, us, _ in device if "fill_kernel" in k) / 1e6,
        "exact_launches": exacts,
        "exact_device_s": sum(us for k, us, _ in device if "exact_kernel" in k) / 1e6,
        **{f"{label}_device_s": range_device_s(events, label) for label in RANGES},
        "top_kernels": [
            {"name": k[:80], "device_s": us / 1e6, "count": n} for k, us, n in device[:12]
        ],
    }
    if stats_parts is not None:
        out["stats"] = stats_parts
        out["device_events_per_wave"] = len(kernels) / max(parts.waves, 1)
    if args.path == "stacked":  # a chunk-wave is one dispatch over every lane
        out["stacks"] = [{"lanes": n, "stacked_lanes": b} for n, b in plain.lanes]
        out["host_s_per_dispatch"] = plain.solve_seconds / max(plain.dispatches, 1)
    if args.path == "exact":  # per gang row solved (the encoder's padded rows included)
        out["gang_rows"] = problem.num_gangs
        out["device_events_per_gang"] = len(kernels) / window_problem.num_gangs
        out["host_s_per_gang"] = plain.solve_seconds / problem.num_gangs
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(card + "\n")
            key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
                   else "self_cuda_time_total")
            fh.write(events.table(sort_by=key, row_limit=60))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
