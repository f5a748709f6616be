"""Read-only solver introspection: the data layer of the admission explain
engine (``observability/explain.py``).

Counterpart of ``grove_tpu/solver/introspect.py``. Everything here answers
"what would the next scheduling round see?" without running it: the
pending frontier is re-collected through the scheduler's own spec builder
(``GangScheduler._build_gang_spec``), sticky reservation reuse is judged by
the same rule (``_reuse_bind_target``) against a private free snapshot, the
order goes through the one ``QuotaManager.order_specs`` (the DRF kernels on
the card when Queue CRs exist) with ``record_rows`` off, and trial solves
run ``build_problem`` / ``solve_waves`` directly (the fill kernel on the
card), on the scheduler's own device, never through the stateful
``_solve_batch``. So an explain leaves the store, the scheduler and the
delta state untouched: ``Store.resource_version_vector()`` and
``DeltaSolveState.state_fingerprint()`` are the same before and after.

``classify_rejections`` is the one deferral classifier: the scheduler
stamps its slug into every GangDeferred event, and the explain funnel
cites the same slug, so the two never disagree.

The fragmentation statistic (``fragmentation_stats``) at topology level l,
resource r: ``frag(l, r) = 1 - (largest one-domain free at l) / (total
free)``, the share of free capacity no single domain slab holds.
``federation_score_inputs`` reads one capacity report for the federation
router's ranking of target regions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.types import SPREAD_SCHEDULE_ANYWAY
from grove_tpu_torch.observability.events import (
    DETAIL_INSUFFICIENT_CAPACITY,
    DETAIL_NODE_FRAGMENTATION,
    DETAIL_NO_NODES,
    DETAIL_TOPOLOGY_FRAGMENTATION,
    DETAIL_UNSATISFIABLE,
)
from grove_tpu_torch.solver.encode import (
    ConstraintError,
    build_problem,
    domain_boundaries,
    encode_nodes,
)
from grove_tpu_torch.solver.kernel import solve_waves

# -- the pending frontier, replayed -------------------------------------------


@dataclass
class PendingView:
    """One consistent read-only snapshot of the next round's solver input:
    the schedulable nodes, a private free-capacity snapshot (the round's
    sticky rebinds already debited), every encodable pending gang spec, and
    the gangs the round leaves out (monitor holds)."""

    nodes: List  # schedulable Node objects
    free: Dict[str, Dict[str, float]]  # node -> resource -> free (private)
    specs: List[dict]  # encodable pending specs, before ordering
    held_monitor: List[Tuple[str, str]] = field(default_factory=list)
    # the held gangs' specs: not solved this round, but judged by the funnel
    held_specs: Dict[Tuple[str, str], dict] = field(default_factory=dict)
    sticky_rebinds: int = 0  # pods the round would sticky-bind before solving
    total_nodes: int = 0  # schedulable or not


def _fits_free(free_row: Dict[str, float], pod) -> bool:
    return all(free_row.get(r, 0.0) >= q for r, q in pod.spec.total_requests().items())


def collect_pending(
    scheduler,
    nodes: Optional[List] = None,
    free: Optional[Dict[str, Dict[str, float]]] = None,
    all_nodes: Optional[List] = None,
) -> PendingView:
    """The pending frontier as ``_schedule_pending`` would collect it,
    mutating nothing: sticky reuse debited against the snapshot (never
    bound), monitor-held gangs set aside, every other gang encoded through
    ``_build_gang_spec``. ``nodes`` / ``free`` / ``all_nodes`` replace the
    live cluster for a what-if view."""
    cluster = scheduler.cluster
    if all_nodes is None:
        all_nodes = list(cluster.nodes)
    if nodes is None:
        nodes = [n for n in all_nodes if n.schedulable]
    if free is None:
        free = cluster.node_free_all(nodes)
    # private copy: the sticky debits below must not reach a caller's dicts
    free = {name: dict(caps) for name, caps in free.items()}
    view = PendingView(nodes=nodes, free=free, specs=[], total_nodes=len(all_nodes))
    nodes_by_name = {n.name: n for n in all_nodes}
    namespaces = sorted({p.metadata.namespace for p in scheduler._pending_pods(None)})
    for ns in namespaces:
        pending = scheduler._pending_pods(ns)
        gang_cache: Dict[str, object] = {}
        remaining = []
        for pod in pending:
            prev = scheduler._reuse_bind_target(
                ns,
                pod,
                nodes_by_name,
                gang_cache,
                lambda node, p: _fits_free(free.get(node.name, {}), p),
            )
            if prev is not None and prev in free:
                # the round would bind this pod before solving: the encoded
                # gangs compete for what is left
                row = free[prev]
                for r, q in pod.spec.total_requests().items():
                    row[r] = row.get(r, 0.0) - q
                view.sticky_rebinds += 1
            else:
                remaining.append(pod)
        by_gang: Dict[str, List] = {}
        for pod in remaining:
            gang_name = pod.metadata.labels.get(namegen.LABEL_PODGANG)
            if gang_name:
                by_gang.setdefault(gang_name, []).append(pod)
        for gang_name, pods in sorted(by_gang.items()):
            built = scheduler._build_gang_spec(ns, gang_name, pods)
            if built is None:
                continue
            if scheduler.monitor is not None and scheduler.monitor.gang_held(ns, gang_name):
                view.held_monitor.append((ns, gang_name))
                view.held_specs[(ns, gang_name)] = built[0]
                continue
            view.specs.append(built[0])
    return view


def order_view(
    scheduler,
    specs: List[dict],
    queue_crs: Optional[Dict[str, object]] = None,
    usage: Optional[Dict[str, Dict[str, float]]] = None,
):
    """The round's solve order for ``specs`` through the one
    ``QuotaManager.order_specs``: the DRF pass when Queue CRs exist
    (``queue_crs`` / ``usage`` replace the live tree and ledger for what-if
    trials), the flat ``(-priority, name)`` sort otherwise; ``record_rows``
    off, so the round's status writer never reads replayed rows. Returns
    (ordered, held)."""
    quota = scheduler.quota
    crs = queue_crs if queue_crs is not None else quota.queue_crs()
    return quota.order_specs(specs, crs=crs, usage=usage, record_rows=False)


def queue_usage(scheduler) -> Dict[str, Dict[str, float]]:
    """Per-queue usage, private copies: the ledger the order would read."""
    return {q: dict(v) for q, v in scheduler.quota._usage_snapshot().items()}


def solve_view(scheduler, nodes: List, free: Dict, specs: List[dict]):
    """One read-only trial solve of ``specs`` against the snapshot:
    ``build_problem`` + ``solve_waves`` on the scheduler's device, padded as
    the next real solve pads (``StickyGroupPad.peek``). Returns (result,
    problem), or (None, None) for an empty frontier."""
    if not specs or not nodes:
        return None, None
    problem = build_problem(
        nodes,
        specs,
        scheduler.topology,
        free_capacity=free,
        pad_groups=scheduler._pad_groups.peek(specs),
    )
    result = solve_waves(
        problem,
        chunk_size=scheduler.chunk_size,
        max_waves=scheduler.max_waves,
        with_alloc=False,
        device=scheduler.device,
    )
    return result, problem


def gang_spec_from_cr(store, scheduler, gang) -> dict:
    """The whole gang's solver spec from its PodGang CR (no recovery pins:
    the entire gang relocates). The what-if drain re-pends a drained node's
    gangs with it."""
    groups = []
    for group in gang.spec.pod_groups:
        demand: Dict[str, float] = {}
        for ref in group.pod_references:
            pod = store.get("Pod", ref.namespace, ref.name, readonly=True)
            if pod is not None:
                demand = pod.spec.total_requests()
                break
        tc = group.topology_constraint
        groups.append(
            {
                "name": group.name,
                "demand": demand,
                "count": len(group.pod_references),
                "min_count": group.min_replicas,
                "partial": False,
                "required_key": (
                    tc.pack_constraint.required
                    if tc is not None and tc.pack_constraint is not None
                    else None
                ),
                "pinned_node": None,
            }
        )
    tc = gang.spec.topology_constraint
    required = preferred = spread_key = None
    spread_min, spread_required = 2, False
    if tc is not None and tc.pack_constraint is not None:
        required = tc.pack_constraint.required
        preferred = tc.pack_constraint.preferred
    if tc is not None and tc.spread_constraint is not None:
        sc = tc.spread_constraint
        spread_key = sc.topology_key
        spread_min = sc.min_domains
        spread_required = sc.when_unsatisfiable != SPREAD_SCHEDULE_ANYWAY
    ns = gang.metadata.namespace
    return {
        "name": f"{ns}/{gang.metadata.name}",
        "gang_name": gang.metadata.name,
        "namespace": ns,
        "groups": groups,
        "required_key": required,
        "preferred_key": preferred,
        "spread_key": spread_key,
        "spread_min_domains": spread_min,
        "spread_required": spread_required,
        "spread_survivor_nodes": [],
        "gang_pinned_node": None,
        "priority": scheduler.priority_map.get(gang.spec.priority_class_name, 0),
        "queue": gang.metadata.labels.get(namegen.LABEL_QUEUE) or scheduler.quota.default_queue,
    }


# -- capacity and fragmentation ---------------------------------------------


def spec_floor_demand(spec: dict) -> Dict[str, float]:
    """Floor demand (per-pod demand x ``min_count``, summed over groups)
    in original units."""
    out: Dict[str, float] = {}
    for grp in spec["groups"]:
        for r, q in grp["demand"].items():
            out[r] = out.get(r, 0.0) + q * grp["min_count"]
    return out


def capacity_report(
    scheduler,
    nodes: Optional[List] = None,
    free: Optional[Dict[str, Dict[str, float]]] = None,
    max_domain_rows: int = 64,
) -> dict:
    """Per-topology-level capacity: domain counts, per-domain free vectors
    (the super-domain level always itemized, other levels up to
    ``max_domain_rows`` domains), the fragmentation statistic and the
    largest one-domain free vector. The domains are the solver's own slabs
    (``encode_nodes`` / ``domain_boundaries``)."""
    cluster = scheduler.cluster
    total_nodes = len(cluster.nodes)
    if nodes is None:
        nodes = [n for n in cluster.nodes if n.schedulable]
    if free is None:
        free = cluster.node_free_all(nodes)
    level_specs = scheduler.topology.spec.levels
    if not nodes:
        return {
            "nodes": 0,
            "totalNodes": total_nodes,
            "resources": [],
            "totalFree": {},
            "superDomainLevel": None,
            "levels": [],
        }
    capacity, topo, node_names, resource_names, level_keys = encode_nodes(
        nodes, scheduler.topology, free
    )
    seg_starts, seg_ends = domain_boundaries(topo)
    node_by_name = {n.name: n for n in nodes}
    total_free = capacity.astype(np.float64).sum(axis=0)
    levels = []
    super_level = None
    for lvl, key in enumerate(level_keys):
        width = int(topo[:, lvl].max()) + 1
        if super_level is None and width >= 2:
            # the frontier's rule: the broadest level with two or more domains
            super_level = key
        dom_free = np.zeros((width, len(resource_names)), dtype=np.float64)
        dom_nodes = []
        names = []
        for d in range(width):
            s, e = int(seg_starts[lvl, d]), int(seg_ends[lvl, d])
            dom_free[d] = capacity[s:e].astype(np.float64).sum(axis=0)
            dom_nodes.append(e - s)
            names.append(node_by_name[node_names[s]].labels.get(key, ""))
        frag = {}
        largest = {}
        for r, rname in enumerate(resource_names):
            tot = float(total_free[r])
            mx = float(dom_free[:, r].max())
            largest[rname] = round(mx, 6)
            frag[rname] = round(1.0 - mx / tot, 4) if tot > 0 else 0.0
        row = {
            "key": key,
            "domain": level_specs[lvl].domain if lvl < len(level_specs) else key,
            "domainCount": width,
            "fragmentation": frag,
            "largestDomainFree": largest,
        }
        if width <= max_domain_rows or key == super_level:
            row["domains"] = [
                {
                    "name": names[d],
                    "nodes": dom_nodes[d],
                    "free": {
                        rname: round(float(dom_free[d, r]), 6)
                        for r, rname in enumerate(resource_names)
                    },
                }
                for d in range(width)
            ]
        levels.append(row)
    return {
        "nodes": len(nodes),
        "totalNodes": total_nodes,
        "resources": resource_names,
        "totalFree": {
            rname: round(float(total_free[r]), 6) for r, rname in enumerate(resource_names)
        },
        "superDomainLevel": super_level,
        "levels": levels,
    }


def fragmentation_stats(report: dict) -> Dict[str, Dict[str, float]]:
    """level key -> resource -> fragmentation, from a :func:`capacity_report`."""
    return {lvl["key"]: dict(lvl["fragmentation"]) for lvl in report["levels"]}


def federation_score_inputs(
    scheduler, floor: Dict[str, float]
) -> Dict[str, float]:
    """Per-cluster routing-score inputs for the federation tier
    (federation/router.py): for the gang floor's BINDING
    resource (largest floor share of this cluster's total free),
    headroom = total free − floor, and the pack-into-largest
    fragmentation delta at the super-domain level — frag(l, r)
    recomputed after hypothetically landing the floor in the largest
    free domain (the solver's contiguous-pack heuristic). Read-only:
    one :func:`capacity_report`, no solve, no store touch — the router
    ranks candidate clusters on (frag_delta, −headroom, region) so
    spillover prefers the cluster it fragments least."""
    report = capacity_report(scheduler)
    total_free = report["totalFree"]
    binding, ratio = None, -1.0
    for r in sorted(floor):
        q = floor[r]
        if q <= 0:
            continue
        tot = total_free.get(r, 0.0)
        share = q / tot if tot > 0 else float("inf")
        if share > ratio:
            binding, ratio = r, share
    if binding is None:
        # zero-demand floor: every cluster scores identically
        return {
            "resource": None,
            "headroom": round(sum(total_free.values()), 6),
            "frag_before": 0.0,
            "frag_after": 0.0,
            "frag_delta": 0.0,
        }
    need = floor[binding]
    tot = total_free.get(binding, 0.0)
    frag_before = frag_after = 0.0
    super_key = report["superDomainLevel"]
    for lvl in report["levels"]:
        if lvl["key"] != super_key:
            continue
        rows = sorted(
            (d["free"].get(binding, 0.0) for d in lvl.get("domains", [])),
            reverse=True,
        )
        largest = rows[0] if rows else 0.0
        second = rows[1] if len(rows) > 1 else 0.0
        frag_before = 1.0 - largest / tot if tot > 0 else 0.0
        after_total = tot - need
        after_largest = max(largest - need, second)
        frag_after = (
            1.0 - after_largest / after_total if after_total > 0 else 0.0
        )
        break
    return {
        "resource": binding,
        "headroom": round(tot - need, 6),
        "frag_before": round(frag_before, 4),
        "frag_after": round(frag_after, 4),
        "frag_delta": round(frag_after - frag_before, 4),
    }


# -- rejection classification -------------------------------------------------


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


def solve_view_safe(scheduler, nodes, free, specs):
    """:func:`solve_view` that turns an unsatisfiable constraint
    declaration (``ConstraintError``) into (None, None, error), so a gang
    with a broken constraint explains as blocked. Returns (result, problem,
    error)."""
    try:
        result, problem = solve_view(scheduler, nodes, free, specs)
        return result, problem, None
    except ConstraintError as e:
        return None, None, str(e)
