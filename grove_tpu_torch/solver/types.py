"""Solver problem encoding: dense arrays for the packing kernels.

Counterpart of ``grove_tpu/solver/types.py`` (same fields, same dtypes).
The problem stays in numpy on the host; ``grove_tpu_torch.convert`` moves
the node-side arrays to the device.

- nodes sorted topologically (domains contiguous at every level)
- capacity[N, R]          float32  free resources per node
- topo[N, L]              int32    domain id of node n at level l (globally
                                   unique per level; level 0 broadest)
- demand[G, P, R]         float32  per-POD resource vector of group p
- count[G, P]             int32    desired pods per group
- min_count[G, P]         int32    gang floor per group (PodGroup.MinReplicas)
- req_level[G]            int32    level the gang MUST pack within (-1 none)
- pref_level[G]           int32    level the gang prefers to pack within
                                   (-1 → narrowest)
- priority[G]             int32    commit order (higher first)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class PackingProblem:
    capacity: np.ndarray  # [N, R] float32
    topo: np.ndarray  # [N, L] int32
    demand: np.ndarray  # [G, P, R] float32
    count: np.ndarray  # [G, P] int32
    min_count: np.ndarray  # [G, P] int32
    req_level: np.ndarray  # [G] int32
    pref_level: np.ndarray  # [G] int32
    priority: np.ndarray  # [G] int32

    # Contiguous-domain boundaries (nodes are topology-sorted): domain d of
    # level l spans node indices [seg_starts[l,d], seg_ends[l,d]). Padded
    # entries are empty ranges.
    seg_starts: np.ndarray = None  # [L, D] int32
    seg_ends: np.ndarray = None  # [L, D] int32
    # per-group required pack level (-1 none): PodGroup/PCSG constraint tier
    group_req: np.ndarray = None  # [G, P] int32
    # pinned domain id per group at its required level (-1 none)
    group_pin: np.ndarray = None  # [G, P] int32
    # pinned domain id for the whole gang at req_level (-1 none)
    gang_pin: np.ndarray = None  # [G] int32
    # topology SPREAD constraint: level whose domains the gang's pods are
    # balanced across (-1 none); minimum distinct domains; hard vs soft
    spread_level: np.ndarray = None  # [G] int32
    spread_min: np.ndarray = None  # [G] int32
    spread_required: np.ndarray = None  # [G] bool
    # recovery seed: survivor pod counts per spread-level domain
    spread_seed: np.ndarray = None  # [G, D] int32

    # bookkeeping (host side, not shipped to device)
    node_names: List[str] = field(default_factory=list)
    gang_names: List[str] = field(default_factory=list)
    # gang -> group -> pclq fqn
    group_names: List[List[str]] = field(default_factory=list)
    resource_names: List[str] = field(default_factory=list)
    level_keys: List[str] = field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return self.capacity.shape[0]

    @property
    def num_gangs(self) -> int:
        return self.demand.shape[0]

    @property
    def max_groups(self) -> int:
        return self.demand.shape[1]

    @property
    def num_levels(self) -> int:
        return self.topo.shape[1]


@dataclass
class PackingResult:
    admitted: np.ndarray  # [G] bool
    placed: np.ndarray  # [G, P] int32 pods actually placed
    score: np.ndarray  # [G] float32 in (0,1]; 0 for unadmitted
    chosen_level: np.ndarray  # [G] int32 (-1: cluster-wide fallback)
    # [G, P, N] int32 per-node pod counts (None in stats-only mode)
    alloc: np.ndarray | None = None
    free_after: np.ndarray | None = None  # [N, R]
    solve_seconds: float = 0.0

    def assignments(
        self, problem: PackingProblem
    ) -> Dict[str, Dict[str, List[str]]]:
        """gang -> pclq fqn -> node names (one entry per pod), from alloc."""
        if self.alloc is None:
            raise ValueError("solver ran in stats-only mode (no alloc)")
        out: Dict[str, Dict[str, List[str]]] = {}
        for g, gang_name in enumerate(problem.gang_names):
            if not self.admitted[g]:
                continue
            groups: Dict[str, List[str]] = {}
            for p, pclq_name in enumerate(problem.group_names[g]):
                nodes: List[str] = []
                for n in np.nonzero(self.alloc[g, p])[0]:
                    nodes.extend([problem.node_names[n]] * int(self.alloc[g, p, n]))
                if nodes:
                    groups[pclq_name] = nodes
            out[gang_name] = groups
        return out
