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

With ``sharded`` it prints instead the numbers of the multi-GPU phase
(``chip_smoke.JAX_SHARDED_REFERENCE``): the JAX package's
``solve_waves_device`` of (a) at ``solve_stress_sharded``'s budget (chunk
128, 32 waves), on one device as ``tests/test_solver.py::TestMultiChip``
calls it — admitted and pending counts, waves, pods placed, the score sum
and the crc32 of the admitted, placed, chosen_level and free_after arrays'
bytes (and of the score's, which the port does not match bit for bit:
XLA's CPU backend fuses the score's multiply-add):

    JAX_PLATFORMS=cpu python scripts/stats_reference.py sharded

With ``flagged`` it prints the numbers of the full-width flagged exact
solves (``chip_smoke.JAX_FLAGGED_EXACT_REFERENCE``): the JAX package's
exact ``solve`` of the disaggregated request (d) (4,096 gangs, a pack per
group) and of the spread + recovery request (e) (3,072 gangs: spreads,
survivor seeds, gang and group pins) on (a)'s 5,120 nodes, the specs
from ``chip_smoke.flagged_exact_specs`` (one definition for both sides)
— admitted gangs, the score sum and the pods placed (a few minutes on
the CPU):

    JAX_PLATFORMS=cpu python scripts/stats_reference.py flagged
"""

from __future__ import annotations

import json
import os
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from grove_tpu.models import build_stress_problem  # noqa: E402
from grove_tpu.observability.metrics import METRICS  # noqa: E402
from grove_tpu.solver.kernel import solve, solve_waves_stats  # noqa: E402


def _gauge(name):
    """The last value the JAX solver set on a gauge (0 when it set none)."""
    return int(METRICS.gauges.get(name, 0))


def sharded_reference(n_nodes: int = 5120, n_gangs: int = 10240, chunk_size: int = 128,
                      max_waves: int = 32) -> dict:
    """The multi-GPU phase's reference: one-device ``solve_waves_device``
    of ``build_stress_problem(n_nodes, n_gangs)`` as ``solve_stress_sharded``
    runs it."""
    import jax.numpy as jnp

    from grove_tpu.ops.packing import solve_waves_device
    from grove_tpu.solver.kernel import dedup_extra_args, level_widths_of, pad_problem_for_waves

    problem = build_stress_problem(n_nodes, n_gangs)
    g = problem.num_gangs
    raw, n_chunks, grouped, pinned, spread, uniform = pad_problem_for_waves(problem, chunk_size)
    out = solve_waves_device(
        *[jnp.asarray(a) for a in raw], **dedup_extra_args(raw[4], raw[5], n_chunks, pinned),
        n_chunks=n_chunks, max_waves=max_waves, grouped=grouped, pinned=pinned, spread=spread,
        uniform=uniform, lazy_rescue=uniform, level_widths=level_widths_of(problem),
    )
    arrays = {k: np.asarray(out[k])[:g] for k in ("admitted", "placed", "score", "chosen_level",
                                                  "pending")}
    arrays["free_after"] = np.asarray(out["free_after"])
    crc = lambda a: zlib.crc32(np.ascontiguousarray(a).tobytes())  # noqa: E731
    return {
        "nodes": n_nodes, "gangs": n_gangs, "chunk_size": chunk_size, "max_waves": max_waves,
        "admitted": int(arrays["admitted"].sum()), "pending": int(arrays["pending"].sum()),
        "waves": int(np.asarray(out["waves"])), "pods_placed": int(arrays["placed"].sum()),
        "score_sum": float(arrays["score"].astype(np.float64).sum()),
        **{f"{k}_crc32": crc(v) for k, v in arrays.items() if k != "pending"},
    }


def flagged_reference() -> dict:
    """The JAX package's exact solve of chip_smoke's full-width (d) and (e)."""
    from chip_smoke import FLAGGED_EXACT_NODES, flagged_exact_specs
    from grove_tpu.api.topology import ClusterTopology
    from grove_tpu.sim.cluster import make_nodes
    from grove_tpu.solver.encode import build_problem

    # (a)'s nodes: grove_tpu.models.build_stress_problem's capacity, ici-blocks
    # of 8 hosts, slices of 8 blocks
    nodes = make_nodes(FLAGGED_EXACT_NODES, {"cpu": 128.0, "tpu": 8.0}, 8, 8)
    out = {}
    for tag in ("d", "e"):
        specs = flagged_exact_specs(tag)
        exact = solve(build_problem(nodes, specs, ClusterTopology()), with_alloc=False)
        out[tag] = {
            "gangs": len(specs),
            "admitted": int(exact.admitted.sum()),
            "score_sum": float(exact.score.astype(np.float64).sum()),
            "pods_placed": int(exact.placed.sum()),
        }
    return out


def main() -> int:
    if sys.argv[1:] == ["flagged"]:
        print(json.dumps({"jax": jax.__version__, "backend": jax.default_backend(),
                          **flagged_reference()}))
        return 0
    if sys.argv[1:] == ["sharded"]:
        print(json.dumps({"jax": jax.__version__, "backend": jax.default_backend(),
                          **sharded_reference()}))
        return 0
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
