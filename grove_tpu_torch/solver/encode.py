"""Host-side encoder: nodes + gang specs → dense PackingProblem arrays.

Counterpart of ``grove_tpu/solver/encode.py`` (numpy only; the port keeps
its own copy). Nodes are topology-sorted so every domain is a contiguous
slab; per-level domain labels become dense int ids; gang/group structures
are padded into size buckets. ``NodeEncoding``, ``slice_encoding`` and
``build_problem_cached`` are the cached node side of the delta-solve state
(``solver/deltastate.py``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.solver.types import PackingProblem


class ConstraintError(ValueError):
    """A gang carries an unsatisfiable/contradictory constraint DECLARATION
    (unknown hard topology key, spread combined with per-group packs) — the
    caller's input is at fault, distinct from solver-side failures."""


def _next_pow2(x: int) -> int:
    n = 1
    while n < x:
        n *= 2
    return n


# Minimum padded gang axis: small problems share a handful of pow2 buckets.
MIN_GANG_BUCKET = 32


def encode_nodes(
    nodes: Sequence,
    topology: ClusterTopology,
    free_capacity: Optional[Dict[str, Dict[str, float]]] = None,
    resource_names: Optional[List[str]] = None,
) -> Tuple[np.ndarray, np.ndarray, List[str], List[str], List[str]]:
    """Sort nodes topologically and build (capacity[N,R], topo[N,L]).

    `free_capacity` overrides per-node capacity (already-bound pods deducted).
    Returns (capacity, topo, node_names, resource_names, level_keys).
    """
    level_keys = [lvl.key for lvl in topology.spec.levels]
    if resource_names is None:
        rset = set()
        for node in nodes:
            rset.update(node.capacity)
        resource_names = sorted(rset)

    def topo_path(node):
        return tuple(node.labels.get(k, "") for k in level_keys)

    ordered = sorted(nodes, key=lambda n: (topo_path(n), n.name))
    n = len(ordered)
    capacity = np.zeros((n, len(resource_names)), dtype=np.float32)
    topo = np.zeros((n, len(level_keys)), dtype=np.int32)
    # Domain identity is the PATH PREFIX (labels of levels 0..l): path-keyed
    # ids over path-sorted nodes are monotone, so every domain is one
    # contiguous slab whose slab index equals its dense id.
    id_maps: List[Dict[tuple, int]] = [{} for _ in level_keys]
    for i, node in enumerate(ordered):
        caps = (
            free_capacity.get(node.name, node.capacity)
            if free_capacity
            else node.capacity
        )
        for r, rname in enumerate(resource_names):
            capacity[i, r] = caps.get(rname, 0.0)
        path = topo_path(node)
        for l in range(len(level_keys)):
            prefix = path[: l + 1]
            topo[i, l] = id_maps[l].setdefault(prefix, len(id_maps[l]))
    node_names = [node.name for node in ordered]
    return capacity, topo, node_names, resource_names, level_keys


def domain_boundaries(topo: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-level contiguous-domain [start, end) node ranges (topology-sorted
    nodes ⇒ each domain is a slab). Padded with empty ranges to the max
    domain count across levels."""
    n, levels = topo.shape
    d_max = 1
    per_level = []
    for l in range(levels):
        col = topo[:, l]
        changes = np.flatnonzero(np.diff(col)) + 1
        starts = np.concatenate([[0], changes]).astype(np.int32)
        ends = np.concatenate([changes, [n]]).astype(np.int32)
        # slab index must equal dense domain id (the kernel masks nodes with
        # topo == slab index)
        if not np.array_equal(col[starts], np.arange(len(starts))):
            raise ValueError(
                f"level {l}: domain ids are not contiguous slab indices — "
                "nodes must be encoded with path-keyed topology ids"
            )
        per_level.append((starts, ends))
        d_max = max(d_max, len(starts))
    seg_starts = np.zeros((levels, d_max), dtype=np.int32)
    seg_ends = np.zeros((levels, d_max), dtype=np.int32)
    for l, (starts, ends) in enumerate(per_level):
        seg_starts[l, : len(starts)] = starts
        seg_ends[l, : len(ends)] = ends
    return seg_starts, seg_ends


def level_index_for_key(
    level_keys: List[str], key: Optional[str], required: bool = False
) -> int:
    if key is None:
        return -1
    try:
        return level_keys.index(key)
    except ValueError:
        if required:
            # A HARD pack constraint must never silently degrade to
            # cluster-wide scatter (TopologyPackConstraint.Required).
            raise ConstraintError(
                f"required topology key {key!r} is not a level of the cluster"
                f" topology {level_keys}"
            )
        return -1


def encode_gangs(
    gang_specs: List[dict],
    resource_names: List[str],
    level_keys: List[str],
    pad_gangs: Optional[int] = None,
    pad_groups: Optional[int] = None,
) -> Tuple[np.ndarray, ...]:
    """gang_specs: [{name, groups: [{name, demand: {res: qty}, count,
    min_count}], required_key, preferred_key, priority}] → padded tensors."""
    g = len(gang_specs)
    p = max((len(s["groups"]) for s in gang_specs), default=1)
    gp = pad_gangs or _next_pow2(max(g, MIN_GANG_BUCKET))
    pp = pad_groups or max(p, 1)
    r = len(resource_names)

    demand = np.zeros((gp, pp, r), dtype=np.float32)
    count = np.zeros((gp, pp), dtype=np.int32)
    min_count = np.zeros((gp, pp), dtype=np.int32)
    group_req = np.full((gp, pp), -1, dtype=np.int32)
    req_level = np.full((gp,), -1, dtype=np.int32)
    pref_level = np.full((gp,), -1, dtype=np.int32)
    spread_level = np.full((gp,), -1, dtype=np.int32)
    spread_min = np.zeros((gp,), dtype=np.int32)
    spread_required = np.zeros((gp,), dtype=bool)
    priority = np.zeros((gp,), dtype=np.int32)
    gang_names: List[str] = []
    group_names: List[List[str]] = []

    for gi, spec in enumerate(gang_specs):
        gang_names.append(spec["name"])
        names = []
        for pi, grp in enumerate(spec["groups"]):
            names.append(grp["name"])
            for ri, rname in enumerate(resource_names):
                demand[gi, pi, ri] = grp["demand"].get(rname, 0.0)
            count[gi, pi] = grp["count"]
            min_count[gi, pi] = grp["min_count"]
            group_req[gi, pi] = level_index_for_key(
                level_keys, grp.get("required_key"), required=True
            )
        group_names.append(names)
        req_level[gi] = level_index_for_key(
            level_keys, spec.get("required_key"), required=True
        )
        pref_level[gi] = level_index_for_key(level_keys, spec.get("preferred_key"))
        # spread: a hard (required) spread key must resolve, like a hard pack
        spread_required[gi] = bool(spec.get("spread_required", False))
        spread_level[gi] = level_index_for_key(
            level_keys, spec.get("spread_key"), required=spread_required[gi]
        )
        if spread_level[gi] < 0:
            spread_required[gi] = False
        elif (group_req[gi] >= 0).any():
            # the balanced spread fill cannot honor per-group hard packs at
            # the same time — reject at the solver boundary
            raise ConstraintError(
                f"gang {spec['name']!r}: spread_key cannot be combined with"
                " per-group required pack constraints"
            )
        elif 0 <= spread_level[gi] <= req_level[gi]:
            # a spread domain at or broader than the pack domain can never
            # span >1 spread domain inside one pack domain
            raise ConstraintError(
                f"gang {spec['name']!r}: spread_key must be strictly"
                " narrower than required_key"
            )
        spread_min[gi] = int(spec.get("spread_min_domains", 2) or 2)
        priority[gi] = spec.get("priority", 0)

    return (
        demand,
        count,
        min_count,
        req_level,
        pref_level,
        priority,
        group_req,
        spread_level,
        spread_min,
        spread_required,
        gang_names,
        group_names,
    )


def _quantize_resources(
    capacity: np.ndarray, demand: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Rescale each resource axis into float32-exact integer units.

    Byte-denominated resources (memory ~2^35) exceed float32's integer range,
    so tiny requests would vanish in `free -= take*demand`. Per resource:
    unit = max(smallest positive demand, max capacity / 2^22); capacity
    rounds DOWN and demand rounds UP in those units — conservative (never
    overcommits), and all kernel arithmetic becomes exact.
    """
    capacity = capacity.copy()
    demand = demand.copy()
    for r in range(capacity.shape[1]):
        cap_max = float(capacity[:, r].max(initial=0.0))
        pos = demand[:, :, r][demand[:, :, r] > 0]
        unit = max(
            float(pos.min()) if pos.size else 1.0,
            cap_max / float(1 << 22),
            1e-12,
        )
        # epsilon guards against float ratio error (0.02/0.01 → 2.0000000004)
        capacity[:, r] = np.floor(capacity[:, r] / unit + 1e-9)
        demand[:, :, r] = np.ceil(demand[:, :, r] / unit - 1e-9)
    return capacity.astype(np.float32), demand.astype(np.float32)


class StickyGroupPad:
    """Thread-safe sticky group-axis padding for repeat ``build_problem``
    callers: remembers the widest template seen and keeps padding there, so
    a solve endpoint's problem shape does not follow every batch's widest
    gang. ``grow()`` is a locked read-modify-write so concurrent solvers
    can't momentarily shrink the sticky width.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._width = 1

    def grow(self, gang_specs: List[dict]) -> int:
        """Fold one batch's max group count into the sticky width and
        return the width to pass as ``build_problem(pad_groups=...)``."""
        batch_max = max((len(s["groups"]) for s in gang_specs), default=1)
        with self._lock:
            self._width = max(self._width, batch_max, 1)
            return self._width


class NodeEncoding:
    """Cached node-side arrays for repeat solves over an unchanged topology:
    the delta-solve tier (``solver/deltastate.py``).

    Holds everything :func:`encode_nodes` derives that does not change per
    tick: the topology sort order, dense path-keyed domain ids, contiguous
    domain boundaries, the node-name index, and the base capacity matrix
    (``node.capacity`` with no usage deducted). Per-tick free capacity is a
    separate ``[N, R]`` matrix whose dirty rows the delta state patches;
    :func:`build_problem_cached` assembles from the pair a problem equal bit
    for bit to a from-scratch :func:`build_problem` over the same inputs.

    The static arrays stay host ndarrays: the preemption trials and the
    oracle index them on the host, and the solver uploads what it needs per
    solve; the cache saves the re-sort and re-derive only.
    """

    def __init__(
        self,
        nodes: Sequence,
        topology: ClusterTopology,
        resource_names: List[str],
    ) -> None:
        capacity, topo, node_names, resource_names, level_keys = encode_nodes(
            nodes, topology, None, list(resource_names)
        )
        self.base_capacity = capacity  # [N, R] float32, node.capacity only
        self.topo = topo
        self.node_names = node_names
        self.resource_names = resource_names
        self.level_keys = level_keys
        self.seg_starts, self.seg_ends = domain_boundaries(topo)
        self.node_index = {name: i for i, name in enumerate(node_names)}


def slice_encoding(
    enc: NodeEncoding, start: int, end: int, pad_to: Optional[int] = None
):
    """Localized node-side arrays for one contiguous topology slab
    ``[start, end)`` of a :class:`NodeEncoding` (the partitioned frontier's
    subproblem encode).

    Nodes are topology-sorted, so a slab's per-level dense ids form
    contiguous ranges; subtracting the first row re-bases them at 0 without
    changing domain identity. ``pad_to`` appends ghost rows that extend the
    last domain of every level (ids replicated from the final real row);
    with zero capacity the kernel never fills them, so padded and unpadded
    solves are equal bit for bit.

    Returns ``(topo_local, seg_starts, seg_ends, node_names, node_index)``
    where ``node_names`` includes ghost names for the padding rows and
    ``node_index`` maps real slab nodes only."""
    n_real = end - start
    topo_local = enc.topo[start:end] - enc.topo[start : start + 1]
    if pad_to is not None and pad_to > n_real:
        topo_local = np.concatenate(
            [
                topo_local,
                np.repeat(topo_local[-1:], pad_to - n_real, axis=0),
            ]
        )
    seg_starts, seg_ends = domain_boundaries(topo_local)
    node_names = list(enc.node_names[start:end])
    node_index = {name: i for i, name in enumerate(node_names)}
    if pad_to is not None and pad_to > n_real:
        node_names.extend(
            f"__frontier-pad-{i}" for i in range(pad_to - n_real)
        )
    return topo_local, seg_starts, seg_ends, node_names, node_index


def build_problem(
    nodes: Sequence,
    gang_specs: List[dict],
    topology: ClusterTopology,
    free_capacity: Optional[Dict[str, Dict[str, float]]] = None,
    pad_gangs: Optional[int] = None,
    pad_groups: Optional[int] = None,
) -> PackingProblem:
    """Encode nodes + gang specs into padded solver arrays.

    ``pad_groups``: the group axis is padded EXACTLY when omitted, so the
    problem shape follows this batch's widest template; repeat callers hold
    a ``StickyGroupPad`` and pass ``sticky.grow(gang_specs)``.
    """
    # resource name space = union over nodes and demands
    rset = set()
    for node in nodes:
        rset.update(node.capacity)
    for spec in gang_specs:
        for grp in spec["groups"]:
            rset.update(grp["demand"])
    resource_names = sorted(rset)

    capacity, topo, node_names, resource_names, level_keys = encode_nodes(
        nodes, topology, free_capacity, resource_names
    )
    seg_starts, seg_ends = domain_boundaries(topo)
    return _assemble_problem(
        capacity,
        topo,
        seg_starts,
        seg_ends,
        node_names,
        resource_names,
        level_keys,
        {name: i for i, name in enumerate(node_names)},
        gang_specs,
        pad_gangs,
        pad_groups,
    )


def build_problem_cached(
    enc: NodeEncoding,
    capacity: np.ndarray,
    gang_specs: List[dict],
    pad_gangs: Optional[int] = None,
    pad_groups: Optional[int] = None,
    pre_encoded: Optional[tuple] = None,
) -> PackingProblem:
    """Assemble a problem from a cached :class:`NodeEncoding` and a free
    capacity matrix kept by the caller (the delta-solve path: the
    re-sort, re-id and boundary scan of :func:`encode_nodes` are skipped;
    only the gang-side arrays are built per tick).

    ``capacity`` must hold the float32 values a from-scratch encode would
    produce for the current free capacity; the result is then equal bit for
    bit to :func:`build_problem`. ``pre_encoded``: an :func:`encode_gangs`
    result computed earlier for the same (gang_specs, pad_gangs,
    pad_groups); encode_gangs is pure, so reusing it changes no bit."""
    return _assemble_problem(
        capacity,
        enc.topo,
        enc.seg_starts,
        enc.seg_ends,
        enc.node_names,
        enc.resource_names,
        enc.level_keys,
        enc.node_index,
        gang_specs,
        pad_gangs,
        pad_groups,
        pre_encoded=pre_encoded,
    )


def _assemble_problem(
    capacity: np.ndarray,
    topo: np.ndarray,
    seg_starts: np.ndarray,
    seg_ends: np.ndarray,
    node_names: List[str],
    resource_names: List[str],
    level_keys: List[str],
    node_index: Dict[str, int],
    gang_specs: List[dict],
    pad_gangs: Optional[int],
    pad_groups: Optional[int],
    pre_encoded: Optional[tuple] = None,
) -> PackingProblem:
    """Gang-side half of the encode, shared by the from-scratch and the
    cached paths: gang arrays, quantization, recovery pins and spread
    seeds. ``pre_encoded`` stands in for the :func:`encode_gangs` call with
    its result computed earlier for the same arguments."""
    (
        demand,
        count,
        min_count,
        req_level,
        pref_level,
        priority,
        group_req,
        spread_level,
        spread_min,
        spread_required,
        gang_names,
        group_names,
    ) = (
        pre_encoded
        if pre_encoded is not None
        else encode_gangs(gang_specs, resource_names, level_keys, pad_gangs, pad_groups)
    )

    capacity, demand = _quantize_resources(capacity, demand)

    # recovery pins: a constrained group with surviving pods must rejoin
    # their domain — map the pinned node to its domain id at the group level
    group_pin = np.full_like(group_req, -1)
    gang_pin = np.full_like(req_level, -1)
    for gi, spec in enumerate(gang_specs):
        for pi, grp in enumerate(spec["groups"]):
            pin_node = grp.get("pinned_node")
            lvl = group_req[gi, pi]
            if pin_node is not None and lvl >= 0 and pin_node in node_index:
                group_pin[gi, pi] = topo[node_index[pin_node], lvl]
        # gang-level recovery pin: survivors of a gang with a gang-level
        # required pack anchor the whole delta-solve to their domain
        gpin_node = spec.get("gang_pinned_node")
        glvl = req_level[gi]
        if gpin_node is not None and glvl >= 0 and gpin_node in node_index:
            gang_pin[gi] = topo[node_index[gpin_node], glvl]

    # spread recovery seed: survivor pods per spread-level domain
    spread_seed = np.zeros(
        (spread_level.shape[0], seg_starts.shape[1]), dtype=np.int32
    )
    for gi, spec in enumerate(gang_specs):
        slvl = spread_level[gi]
        if slvl < 0:
            continue
        for node in spec.get("spread_survivor_nodes") or []:
            if node in node_index:
                spread_seed[gi, topo[node_index[node], slvl]] += 1
    if not spread_seed.any():
        # zero-width placeholder: no seeds anywhere
        spread_seed = np.zeros((spread_level.shape[0], 0), dtype=np.int32)

    return PackingProblem(
        capacity=capacity,
        topo=topo,
        seg_starts=seg_starts,
        seg_ends=seg_ends,
        group_req=group_req,
        group_pin=group_pin,
        gang_pin=gang_pin,
        demand=demand,
        count=count,
        min_count=min_count,
        req_level=req_level,
        pref_level=pref_level,
        spread_level=spread_level,
        spread_min=spread_min,
        spread_required=spread_required,
        spread_seed=spread_seed,
        priority=priority,
        node_names=node_names,
        gang_names=gang_names,
        group_names=group_names,
        resource_names=resource_names,
        level_keys=level_keys,
    )
