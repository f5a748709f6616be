"""The gang-solver sidecar's solve, below its wire layer.

Counterpart of ``grove_tpu/cluster/grpcsolver.py::solve_request``: from a
decoded request (nodes, gang specs, topology) through sticky group padding,
``build_problem`` and ``solve_waves`` to per-gang placements. The protobuf
messages and the gRPC server are a later slice; ``solve_decoded`` returns
plain dicts with the fields of ``SolveResponse``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.solver.encode import StickyGroupPad, build_problem
from grove_tpu_torch.solver.kernel import solve_waves


def solve_decoded(
    nodes: Sequence,
    gang_specs: List[dict],
    topology: ClusterTopology,
    with_alloc: bool = True,
    chunk_size: Optional[int] = None,
    max_waves: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    free_capacity: Optional[Dict[str, Dict[str, float]]] = None,
    pad_groups: Optional[StickyGroupPad] = None,
) -> dict:
    """Solve one decoded request. `pad_groups`: the endpoint's sticky group
    padding (a fresh one pads this batch exactly). `free_capacity`
    overrides node capacity per node name.

    Returns ``{"solve_seconds": float, "placements": [{"gang",
    "admitted", "placement_score", "chosen_level_key", "assignments":
    [(group, node, count), ...]}, ...]}`` in request order.
    """
    pad = pad_groups if pad_groups is not None else StickyGroupPad()
    problem = build_problem(
        nodes, gang_specs, topology,
        free_capacity=free_capacity,
        pad_groups=pad.grow(gang_specs),
    )
    solve_kwargs = {"with_alloc": with_alloc, "device": device}
    if chunk_size:
        solve_kwargs["chunk_size"] = chunk_size
    if max_waves:
        solve_kwargs["max_waves"] = max_waves
    result = solve_waves(problem, **solve_kwargs)

    level_keys = [lvl.key for lvl in topology.spec.levels]
    placements = []
    for gi, spec in enumerate(gang_specs):
        admitted = bool(result.admitted[gi])
        chosen = int(result.chosen_level[gi])
        assignments = []
        if result.alloc is not None and admitted:
            alloc = result.alloc[gi]  # [P, N] pod counts
            for pi, grp in enumerate(spec["groups"]):
                for ni in np.nonzero(alloc[pi])[0]:
                    assignments.append(
                        (grp["name"], problem.node_names[int(ni)], int(alloc[pi][ni]))
                    )
        placements.append(
            {
                "gang": spec["name"],
                "admitted": admitted,
                "placement_score": float(result.score[gi]),
                "chosen_level_key": (
                    level_keys[chosen] if 0 <= chosen < len(level_keys) else ""
                ),
                "assignments": assignments,
            }
        )
    return {"solve_seconds": result.solve_seconds, "placements": placements}
