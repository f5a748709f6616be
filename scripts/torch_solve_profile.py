"""Where the port's sidecar solve spends its time on the GPU.

Runs the BASELINE stress request (10,240 gangs x 5,120 nodes; smaller with
--gangs/--nodes) through ``grove_tpu_torch.solver.kernel.solve_waves`` on
CUDA: once unprofiled (solve_seconds), then once under ``torch.profiler``
(CPU + CUDA activities). Prints one JSON object: wall times, the summed
device time of all kernels, the device busy share (device time / profiled
wall), the number of device events (kernels and copies), fill launches,
and the top kernels by device time.
With --out, the full profiler table is written to that file.

    python3 scripts/torch_solve_profile.py [--gangs 10240] [--nodes 5120] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from grove_tpu_torch.models.scenarios import build_stress_problem  # noqa: E402
from grove_tpu_torch.ops.fill import fill_batch  # noqa: E402
from grove_tpu_torch.solver.kernel import solve_waves  # noqa: E402
from grove_tpu_torch.utils.platform import card_info  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gangs", type=int, default=10240)
    ap.add_argument("--nodes", type=int, default=5120)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = ", ".join(card_info())
    problem = build_stress_problem(args.nodes, args.gangs)
    solve_waves(build_stress_problem(256, 256), device="cuda")  # build + warm up

    fill_batch.launches = 0
    plain = solve_waves(problem, device="cuda")
    fills = fill_batch.launches

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiled = solve_waves(problem, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side events only (kernels and copies, one per launch): the
    # aten ops that launched them carry the same device time again
    kernels = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    per_name = {}
    for e in kernels:
        us, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    device = sorted(((k, us, n) for k, (us, n) in per_name.items()), key=lambda x: -x[1])
    device_us = sum(us for _, us, _ in device)
    out = {
        "card": card,
        "gangs": args.gangs,
        "nodes": args.nodes,
        "solve_seconds": plain.solve_seconds,
        "admitted": int(plain.admitted.sum()),
        "profiled_wall_s": wall,
        "profiled_admitted_equal": bool((profiled.admitted == plain.admitted).all()),
        "device_kernel_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "device_events": len(kernels),
        "fill_launches": fills,
        "fill_device_s": sum(us for k, us, _ in device if "fill_kernel" in k) / 1e6,
        "top_kernels": [
            {"name": k[:80], "device_s": us / 1e6, "count": n} for k, us, n in device[:12]
        ],
    }
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
