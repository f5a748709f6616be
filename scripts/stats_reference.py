"""The JAX package's results for the port's stats-path check on the card.

Solves the BASELINE stress request (a), 10,240 gangs x 5,120 nodes
(``grove_tpu.models.build_stress_problem(5120, 10240)``), with
``grove_tpu.solver.kernel.solve_waves_stats`` and with the exact
``solve``, and the same for the first 2,048 of those gangs on the same
nodes. Prints one JSON object: admitted, pods placed, waves, tail size and
score sum of the stats solve, admitted and score sum of the exact solve.
``chip_smoke.py`` holds the port's results on the card against these
numbers (its ``JAX_STATS_REFERENCE``). Run on the CPU:

    JAX_PLATFORMS=cpu python scripts/stats_reference.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from grove_tpu.models import build_stress_problem  # noqa: E402
from grove_tpu.observability.metrics import METRICS  # noqa: E402
from grove_tpu.solver.kernel import solve, solve_waves_stats  # noqa: E402


def _gauge(name):
    """The last value the JAX solver set on a gauge (0 when it set none)."""
    return int(METRICS.gauges.get(name, 0))


def main() -> int:
    out = {"jax": jax.__version__, "backend": jax.default_backend()}
    for n_gangs in (10240, 2048):
        problem = build_stress_problem(5120, n_gangs)
        METRICS.set("gang_solve_tail", 0)
        stats = solve_waves_stats(problem)
        exact = solve(problem, with_alloc=False)
        out[str(n_gangs)] = {
            "admitted": int(stats.admitted.sum()),
            "pods_placed": int(stats.placed.sum()),
            "waves": _gauge("gang_solve_waves"),
            "tail": _gauge("gang_solve_tail"),
            "score_sum": float(np.float64(stats.score.astype(np.float64).sum())),
            "exact_admitted": int(exact.admitted.sum()),
            "exact_score_sum": float(exact.score.astype(np.float64).sum()),
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
