"""Times the port's binding and stats solves of the stress request (a) on
the card, to compare two checkouts of the repository inside one call.

Builds (a) (10,240 stress gangs on 5,120 nodes), solves it once to warm up,
then ``--runs`` times each through ``solver.kernel.solve_waves`` (the
binding path) and ``solve_waves_stats`` (the stats path), and prints one
JSON line: the checkout, the card (``nvidia-smi`` name and power limit),
each run's ``solve_seconds`` and the fill launches of one solve of each.
``--root`` names the checkout whose ``grove_tpu_torch`` is imported
(default: this one), so a parent commit unpacked beside the tree is timed
by the same script:

    python3 scripts/solve_ab.py [--root DIR] [--runs 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from grove_tpu_torch.models.scenarios import build_stress_problem
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.solver.kernel import solve_waves, solve_waves_stats
    from grove_tpu_torch.utils.platform import card_info

    problem = build_stress_problem(5120, 10240)
    out = {"root": root, "card": ", ".join(card_info())}
    for name, solve in (("binding", solve_waves), ("stats", solve_waves_stats)):
        solve(problem, device="cuda")  # warm up
        fill_batch.launches = 0
        times = [solve(problem, device="cuda").solve_seconds for _ in range(args.runs)]
        out[f"{name}_s"] = times
        out[f"{name}_fill_launches"] = fill_batch.launches // args.runs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
