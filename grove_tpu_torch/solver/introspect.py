"""Why a gang was not admitted: the deferral classifier the scheduler stamps
into every GangDeferred event.

Counterpart of ``grove_tpu/solver/introspect.py``'s ``classify_rejections``
and ``spec_floor_demand``; the admission explain engine is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from grove_tpu_torch.observability.events import (
    DETAIL_INSUFFICIENT_CAPACITY,
    DETAIL_NODE_FRAGMENTATION,
    DETAIL_NO_NODES,
    DETAIL_TOPOLOGY_FRAGMENTATION,
    DETAIL_UNSATISFIABLE,
)


def spec_floor_demand(spec: dict) -> Dict[str, float]:
    """Floor demand (per-pod demand x ``min_count``, summed over groups)
    in original units."""
    out: Dict[str, float] = {}
    for grp in spec["groups"]:
        for r, q in grp["demand"].items():
            out[r] = out.get(r, 0.0) + q * grp["min_count"]
    return out


def classify_rejections(problem, result, specs: List[dict]) -> Dict[int, Tuple[str, str]]:
    """(detail slug, one-line text) for every rejected gang of one solve,
    from the problem's arrays (quantized units; texts in original units)."""
    out: Dict[int, Tuple[str, str]] = {}
    if result is None or problem is None:
        return out
    n = problem.num_nodes
    cap = problem.capacity  # [N, R] quantized
    total_free_q = cap.astype(np.float64).sum(axis=0)
    for gi, spec in enumerate(specs):
        if bool(result.admitted[gi]):
            continue
        if n == 0:
            out[gi] = (DETAIL_NO_NODES, "no schedulable nodes")
            continue
        floor_q = (
            problem.demand[gi].astype(np.float64) * problem.min_count[gi][:, None]
        ).sum(axis=0)
        floor_orig = spec_floor_demand(spec)
        short = [
            problem.resource_names[r]
            for r in range(len(total_free_q))
            if floor_q[r] > total_free_q[r]
        ]
        if short:
            rname = short[0]
            out[gi] = (
                DETAIL_INSUFFICIENT_CAPACITY,
                f"cluster free {rname} cannot cover the gang floor"
                f" ({floor_orig.get(rname, 0.0):g} {rname} needed)",
            )
            continue
        rl = int(problem.req_level[gi])
        if rl >= 0:
            key = problem.level_keys[rl]
            width = int(problem.topo[:, rl].max()) + 1
            covered = False
            best_cover = 0.0
            for d in range(width):
                s = int(problem.seg_starts[rl, d])
                e = int(problem.seg_ends[rl, d])
                dom = cap[s:e].astype(np.float64).sum(axis=0)
                need = floor_q > 0
                if not need.any():
                    covered = True
                    break
                cover = float((dom[need] / floor_q[need]).min())
                best_cover = max(best_cover, cover)
                if cover >= 1.0:
                    covered = True
                    break
            if not covered:
                out[gi] = (
                    DETAIL_TOPOLOGY_FRAGMENTATION,
                    f"no single {key} domain covers the gang floor"
                    f" (best domain covers {best_cover:.0%}); free"
                    " capacity is fragmented across domains",
                )
                continue
        sl = int(problem.spread_level[gi])
        if sl >= 0 and bool(problem.spread_required[gi]):
            width = int(problem.topo[:, sl].max()) + 1
            if width < int(problem.spread_min[gi]):
                out[gi] = (
                    DETAIL_UNSATISFIABLE,
                    f"hard spread needs {int(problem.spread_min[gi])}"
                    f" {problem.level_keys[sl]} domains; the cluster has"
                    f" {width}",
                )
                continue
        out[gi] = (
            DETAIL_NODE_FRAGMENTATION,
            "aggregate capacity covers the floor, but no feasible"
            " packing exists on current per-node free capacity",
        )
    return out
