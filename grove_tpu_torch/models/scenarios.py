"""The BASELINE stress scenario: a synthetic 10k-gang × 5k-node solver input.

Counterpart of ``grove_tpu/models/scenarios.py``'s ``stress_gang_specs`` and
``build_stress_problem``; the same seed gives the same gang specs as the
JAX package's generator.
"""

from __future__ import annotations

from typing import List

import numpy as np

from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.sim.cluster import make_nodes
from grove_tpu_torch.solver.encode import build_problem
from grove_tpu_torch.solver.types import PackingProblem

# Per-node capacity of the stress cluster (8 accelerator chips per host).
STRESS_CAPACITY = {"cpu": 128.0, "tpu": 8.0}


def stress_gang_specs(n_gangs: int, seed: int = 0) -> List[dict]:
    """Headline stress mix: mostly small single-group gangs (the cluster can
    hold them all), a tail of multi-group disaggregated-style gangs carrying
    slice-level pack hints."""
    rng = np.random.default_rng(seed)
    gangs = []
    for i in range(n_gangs):
        if i % 8 == 0:
            n_groups = int(rng.integers(2, 4))
            groups = [
                {
                    "name": f"g{i}-{p}",
                    "demand": {
                        "tpu": float(rng.integers(1, 3)),
                        "cpu": float(rng.integers(1, 9)),
                    },
                    "count": int(rng.integers(1, 5)),
                    "min_count": None,
                }
                for p in range(n_groups)
            ]
            required = "cloud.google.com/gke-tpu-slice"
        else:
            groups = [
                {
                    "name": f"g{i}-0",
                    "demand": {"tpu": 1.0, "cpu": 2.0},
                    "count": int(rng.integers(2, 5)),
                    "min_count": None,
                }
            ]
            required = None
        for g in groups:
            g["min_count"] = g["count"]
        gangs.append(
            {
                "name": f"g{i}",
                "groups": groups,
                "required_key": required,
                "preferred_key": None,
                "priority": 0,
            }
        )
    return gangs


def build_stress_problem(
    n_nodes: int,
    n_gangs: int,
    seed: int = 0,
    hosts_per_ici_block: int = 8,
    blocks_per_slice: int = 8,
) -> PackingProblem:
    """The BASELINE.json stress input: n_gangs onto an n_nodes cluster
    (5120 nodes × 8 chips at full scale)."""
    nodes = make_nodes(
        n_nodes,
        capacity=dict(STRESS_CAPACITY),
        hosts_per_ici_block=hosts_per_ici_block,
        blocks_per_slice=blocks_per_slice,
    )
    return build_problem(
        nodes, stress_gang_specs(n_gangs, seed), ClusterTopology()
    )
