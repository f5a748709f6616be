"""The BASELINE stress scenario, and scheduler worlds built from gang specs.

Counterpart of ``grove_tpu/models/scenarios.py``'s ``stress_gang_specs`` and
``build_stress_problem``; the same seed gives the same gang specs as the
JAX package's generator.

``gang_world_docs`` turns gang specs into the Pod, PodClique and PodGang
documents a PodCliqueSet controller would have written (wire documents, as
``grove_tpu/api/serialize.py`` exports them), so one world loads into the
port's store and into the JAX package's alike. ``scheduler_world`` holds the
scheduler worlds (s), (q) and (r), the churn world ``delta`` whose ticks
``apply_tick`` applies to either package's store, and the frontier's world
(phi); ``EventCapture``, ``round_summary``, ``delta_counters`` and
``frontier_counters`` read a round the same way on either side. This part
is plain Python.
"""

from __future__ import annotations

import hashlib
import random
from collections import Counter
from typing import Callable, Dict, List, Optional

import numpy as np

from grove_tpu_torch.api import names as namegen

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


# -- scheduler worlds ----------------------------------------------------------


def _pack(required: Optional[str], preferred: Optional[str] = None) -> Optional[dict]:
    pack = {k: v for k, v in (("required", required), ("preferred", preferred)) if v}
    return {"packConstraint": pack} if pack else None


def gang_world_docs(
    specs: List[dict],
    namespace_of: Callable[[int, dict], str] = lambda i, spec: "default",
    queue_of: Callable[[int, dict], Optional[str]] = lambda i, spec: None,
    priority_class_of: Callable[[int, dict], str] = lambda i, spec: "",
) -> List[dict]:
    """Wire documents of the world a PodCliqueSet controller leaves for gang
    specs: per spec (a PodCliqueSet of one replica named after the spec),
    its base PodGang, one PodClique per group and the group's pods, ungated
    and unbound. Groups keep their names as clique template names; a
    group's floor is its PodGroup's ``minReplicas``; the gang's
    ``required_key``/``preferred_key`` and spread, and each group's
    ``required_key``, become the PodGang's topology constraints. Queue
    labels go on every object when ``queue_of`` names a queue."""
    docs: List[dict] = []
    for i, spec in enumerate(specs):
        ns = namespace_of(i, spec)
        queue = queue_of(i, spec)
        pcs = spec["name"]
        gang = namegen.base_podgang_name(pcs, 0)
        labels = {namegen.LABEL_PART_OF: pcs}
        if queue:
            labels[namegen.LABEL_QUEUE] = queue
        pod_groups, cliques, pods = [], [], []
        for grp in spec["groups"]:
            pclq = namegen.podclique_name(pcs, 0, grp["name"])
            pod_names = [namegen.pod_name(pclq, k) for k in range(grp["count"])]
            pod_group = {
                "name": pclq,
                "podReferences": [{"namespace": ns, "name": n} for n in pod_names],
                "minReplicas": grp["min_count"],
            }
            tc = _pack(grp.get("required_key"))
            if tc:
                pod_group["topologyConstraint"] = tc
            pod_groups.append(pod_group)
            pod_spec = {"containers": [{"name": "main", "requests": dict(grp["demand"])}]}
            clique_labels = dict(labels, **{namegen.LABEL_PODGANG: gang})
            cliques.append({
                "apiVersion": "grove.io/v1alpha1",
                "kind": "PodClique",
                "metadata": {"name": pclq, "namespace": ns, "labels": clique_labels},
                "spec": {"roleName": grp["name"], "replicas": grp["count"],
                         "minAvailable": grp["min_count"], "podSpec": pod_spec},
            })
            for name in pod_names:
                pods.append({
                    "apiVersion": "v1",
                    "kind": "Pod",
                    "metadata": {"name": name, "namespace": ns,
                                 "labels": dict(clique_labels, **{namegen.LABEL_PODCLIQUE: pclq})},
                    "spec": pod_spec,
                    "status": {"phase": "Pending"},
                })
        gang_tc = _pack(spec.get("required_key"), spec.get("preferred_key")) or {}
        if spec.get("spread_key"):
            gang_tc["spreadConstraint"] = {
                "topologyKey": spec["spread_key"],
                "minDomains": spec.get("spread_min_domains", 2),
                "whenUnsatisfiable": "DoNotSchedule" if spec.get("spread_required")
                else "ScheduleAnyway",
            }
        gang_spec = {"podGroups": pod_groups}
        if gang_tc:
            gang_spec["topologyConstraint"] = gang_tc
        priority_class = priority_class_of(i, spec)
        if priority_class:
            gang_spec["priorityClassName"] = priority_class
        docs.append({
            "apiVersion": "scheduler.grove.io/v1alpha1",
            "kind": "PodGang",
            "metadata": {"name": gang, "namespace": ns, "labels": dict(labels)},
            "spec": gang_spec,
            "status": {"phase": "Pending"},
        })
        docs.extend(cliques)
        docs.extend(pods)
    return docs


def queue_docs(deserved: Dict[str, Dict[str, float]],
               ceiling: Optional[Dict[str, Dict[str, float]]] = None) -> List[dict]:
    """Queue documents (cluster-scoped), one per name of ``deserved``."""
    return [
        {
            "apiVersion": "scheduler.grove.io/v1alpha1",
            "kind": "Queue",
            "metadata": {"name": name},
            "spec": {"deserved": dict(d), **({"ceiling": dict(ceiling[name])}
                                             if ceiling and name in ceiling else {})},
        }
        for name, d in deserved.items()
    ]


def _renamed(specs: List[dict], prefix: str) -> List[dict]:
    out = []
    for i, spec in enumerate(specs):
        spec = dict(spec, name=f"{prefix}{i}")
        spec["groups"] = [dict(g, name=f"{prefix}{i}-{p}") for p, g in enumerate(spec["groups"])]
        out.append(spec)
    return out


def _tenant(i: int, spec: dict, offset: int = 0, n: int = 8) -> str:
    return f"tenant-{offset + i % n}"


def scheduler_world(name: str, n_nodes: Optional[int] = None, n_gangs: Optional[int] = None,
                    ticks: Optional[int] = None, seed: int = 0) -> dict:
    """A scheduler world: ``nodes`` (make_nodes arguments), ``priority_map``,
    ``queues`` (documents created first) and ``rounds`` (documents created
    before each ``schedule_pending()`` round).

    - ``s``: stress_gang_specs(10240, seed=0) in namespace ``default``, no
      queues, priority 0, on 5,120 nodes; an admission round, then an
      upkeep round with nothing new.
    - ``q``: the same gangs, gang i in namespace and queue tenant-(i % 8);
      eight queues each deserving 1/8 of the cluster; one round.
    - ``r``: 512 nodes and four queues each deserving 1/4; round 1
      stress_gang_specs(1024, seed=2) in tenant-0, round 2
      stress_gang_specs(512, seed=3) over tenant-1..3 plus 16 gangs of
      priority class ``critical`` (100) in tenant-1: it reclaims from
      tenant-0 and preempts.

    ``n_nodes`` / ``n_gangs`` cut a world (for (r), ``n_gangs`` is round
    1's count; round 2 takes half as many and one high-priority gang per 64
    of round 1's, at least one).
    - ``delta``: (q)'s world and round, then ``ticks`` (default 24) churn
      ticks under the key ``ticks``, drawn by :func:`churn_ticks` from
      ``seed``.
    - ``frontier``: (phi), the world of the partitioned frontier: ``delta``
      with 16 churn ticks by default (tick 8 cordons a node, tick 16
      uncordons it). Its 5,120 nodes are 80 slices of 64, so the frontier
      cuts 80 subproblems."""
    capacity = dict(STRESS_CAPACITY)
    if name == "frontier":
        return scheduler_world("delta", n_nodes, n_gangs, 16 if ticks is None else ticks, seed)
    if name == "delta":
        world = scheduler_world("q", n_nodes, n_gangs)
        world["ticks"] = churn_ticks(
            world["rounds"][0], world["nodes"][0], 24 if ticks is None else ticks, seed
        )
        return world
    if name in ("s", "q"):
        n_nodes = n_nodes or 5120
        specs = stress_gang_specs(n_gangs or 10240, seed=0)
        if name == "s":
            return {"nodes": (n_nodes, capacity, 8, 8), "priority_map": {}, "queues": [],
                    "rounds": [gang_world_docs(specs), []]}
        share = {r: v * n_nodes / 8 for r, v in capacity.items()}
        return {
            "nodes": (n_nodes, capacity, 8, 8),
            "priority_map": {},
            "queues": queue_docs({f"tenant-{k}": share for k in range(8)}),
            "rounds": [gang_world_docs(specs, namespace_of=_tenant, queue_of=_tenant)],
        }
    if name == "r":
        n_nodes = n_nodes or 512
        n1 = n_gangs or 1024
        share = {r: v * n_nodes / 4 for r, v in capacity.items()}

        def later(i, spec):
            return _tenant(i, spec, offset=1, n=3)

        def tenant1(i, spec):
            return "tenant-1"

        round2 = gang_world_docs(stress_gang_specs(n1 // 2, seed=3), namespace_of=later,
                                 queue_of=later)
        round2 += gang_world_docs(_renamed(stress_gang_specs(max(1, n1 // 64), seed=4), "hp"),
                                  namespace_of=tenant1, queue_of=tenant1,
                                  priority_class_of=lambda i, spec: "critical")
        return {
            "nodes": (n_nodes, capacity, 8, 8),
            "priority_map": {"critical": 100},
            "queues": queue_docs({f"tenant-{k}": share for k in range(4)}),
            "rounds": [
                gang_world_docs(stress_gang_specs(n1, seed=2),
                                namespace_of=lambda i, spec: "tenant-0",
                                queue_of=lambda i, spec: "tenant-0"),
                round2,
            ],
        }
    raise ValueError(f"unknown scheduler world {name!r}")


# -- the churn world ----------------------------------------------------------

CHURN_FLAP_EVERY = 8  # a cordon toggle every 8th tick
CHURN_BACKLOG = 2  # unplaceable gangs that stay pending from the first tick


def _backlog_specs(n: int) -> List[dict]:
    """Gangs no node can take: two pods of 16 chips each."""
    return [{"name": f"backlog{k}", "required_key": None, "preferred_key": None, "priority": 0,
             "groups": [{"name": f"backlog{k}-0", "demand": {"tpu": 16.0, "cpu": 2.0},
                         "count": 2, "min_count": 2}]} for k in range(n)]


def _deletes(docs: List[dict]) -> List[tuple]:
    """Delete operations of one gang's objects: pods, cliques, PodGang."""
    order = {"Pod": 0, "PodClique": 1, "PodGang": 2}
    ranked = sorted(docs, key=lambda d: order[d["kind"]])
    return [("delete", d["kind"], d["metadata"]["namespace"], d["metadata"]["name"])
            for d in ranked]


def churn_ticks(round1: List[dict], n_nodes: int, ticks: int, seed: int) -> List[List[tuple]]:
    """Seeded churn after (q)'s round, as operations on documents and
    nodes: the mix of ``grove_tpu/sim/deltachurn.py`` ``churn_loop``
    without controllers. Per tick, from ``random.Random(seed)``:

    - 45 %: one or two fresh stress gangs (``stress_gang_specs(.., seed +
      1)`` renamed ``churn<k>``) arrive, arrival k in tenant-(k % 8);
    - 20 %: the oldest churn-arrived gang still present leaves (its pods,
      cliques and PodGang deleted);
    - 15 %: a pod of a round-1 gang with a required pack fails: it is
      deleted and a pending replacement of the same name and labels is
      created, so its gang's recovery solve is pinned by the survivors.
      The pod is drawn from a clique of two or more pods: a clique's
      survivors are what pins the gang (the sole pod of a clique comes
      back unpinned in both packages, ROADMAP C.3);
    - the rest: nothing.

    The first tick also brings a standing backlog, as the JAX package's
    delta smoke has one (``deltachurn.smoke_ab_run``): ``CHURN_BACKLOG``
    gangs of pods that ask for 16 chips on nodes of 8, backlog k in
    tenant-k. They never place, so every later round encodes, orders and
    solves, and a round whose input did not change reuses the last solve.

    Every ``CHURN_FLAP_EVERY``-th tick also toggles a node's cordon: a
    seeded node leaves the schedulable set, and comes back at the next
    such tick. Operations: ``("create", doc)``, ``("delete", kind,
    namespace, name)``, ``("cordon", node, bool)``. They name their objects
    and are fixed by the seed, not by a store's state, so one list drives
    either package."""
    rng = random.Random(seed)
    by_gang: Dict[str, List[dict]] = {}
    for doc in round1:
        labels = doc["metadata"]["labels"]
        gang = doc["metadata"]["name"] if doc["kind"] == "PodGang" else labels[namegen.LABEL_PODGANG]
        by_gang.setdefault(gang, []).append(doc)
    # pods of cliques of two or more, per gang with a required pack
    failing: Dict[str, List[dict]] = {}
    for name, docs in by_gang.items():
        if not any(d["kind"] == "PodGang" and "topologyConstraint" in d["spec"] for d in docs):
            continue
        sizes = Counter(d["metadata"]["labels"][namegen.LABEL_PODCLIQUE] for d in docs
                        if d["kind"] == "Pod")
        pods = [d for d in docs if d["kind"] == "Pod"
                and sizes[d["metadata"]["labels"][namegen.LABEL_PODCLIQUE]] > 1]
        if pods:
            failing[name] = pods
    packed = list(failing)
    pool = _renamed(stress_gang_specs(2 * ticks, seed=seed + 1), "churn")
    arrivals = 0
    live: List[List[dict]] = []  # churn-arrived gangs' documents, oldest first
    flapped: Optional[str] = None
    out = []
    for i in range(ticks):
        ops: List[tuple] = []
        if i == 0:
            backlog = gang_world_docs(_backlog_specs(CHURN_BACKLOG),
                                      namespace_of=lambda k, s: f"tenant-{k}",
                                      queue_of=lambda k, s: f"tenant-{k}")
            ops += [("create", d) for d in backlog]
        roll = rng.random()
        if roll < 0.45:
            for _ in range(rng.randrange(1, 3)):
                tenant = f"tenant-{arrivals % 8}"
                docs = gang_world_docs([pool[arrivals]], namespace_of=lambda j, s: tenant,
                                       queue_of=lambda j, s: tenant)
                ops += [("create", d) for d in docs]
                live.append(docs)
                arrivals += 1
        elif roll < 0.65 and live:
            ops += _deletes(live.pop(0))
        elif roll < 0.8 and packed:
            pods = failing[packed[rng.randrange(len(packed))]]
            pod = pods[rng.randrange(len(pods))]
            ops.append(("delete", "Pod", pod["metadata"]["namespace"], pod["metadata"]["name"]))
            ops.append(("create", pod))
        if i and i % CHURN_FLAP_EVERY == 0:
            if flapped is None:
                flapped = f"node-{rng.randrange(n_nodes)}"
                ops.append(("cordon", flapped, True))
            else:
                ops.append(("cordon", flapped, False))
                flapped = None
        out.append(ops)
    return out


def apply_tick(store, cluster, tick: List[tuple], decode: Callable[[dict], object]) -> None:
    """Apply one tick of :func:`churn_ticks` to a store and its cluster;
    ``decode`` is the store's own package's wire decoder. A delete of an
    object already gone (a pod of a gang the scheduler evicted) is
    skipped."""
    nodes = {n.name: n for n in cluster.nodes}
    for op in tick:
        if op[0] == "create":
            store.create(decode(op[1]))
        elif op[0] == "delete":
            if store.get(*op[1:], readonly=True) is not None:
                store.delete(*op[1:])
        elif op[0] == "cordon":
            nodes[op[1]].cordoned = op[2]
        else:
            raise ValueError(f"unknown churn operation {op[0]!r}")


def delta_counters(delta) -> dict:
    """The delta state's counters, read the same way from either package."""
    return {k: getattr(delta, k) for k in (
        "warm_start_hits", "solve_reuses", "full_fallbacks", "drift_detected",
        "last_reencoded", "last_reused")}


# FrontierState.stats() fields that do not depend on time (occupancy and the
# self-check's milliseconds do)
FRONTIER_STAT_FIELDS = (
    "solves", "degenerate_ticks", "subproblems_total", "assigned_gangs_total",
    "residual_gangs_total", "batched_dispatches_total", "residual_overlap_hits",
    "residual_overlap_misses",
)


def frontier_counters(frontier) -> dict:
    """The deterministic part of a frontier state's ``stats()``, read the
    same way from either package."""
    stats = frontier.stats()
    return {k: stats[k] for k in FRONTIER_STAT_FIELDS}


class EventCapture:
    """Records every ``record`` call of an event recorder (either
    package's) as (kind, namespace, name, type, reason, message) while
    active; the recorder itself dedups, so it cannot be counted from."""

    def __init__(self, recorder) -> None:
        self.recorder = recorder
        self.events: List[tuple] = []

    def __enter__(self) -> "EventCapture":
        wrapped = self.recorder.record

        def record(obj_ref, type, reason, message):
            kind, ns, name = obj_ref
            self.events.append((kind, ns, name, type, reason, message))
            return wrapped(obj_ref, type, reason, message)

        self.recorder.record = record
        return self

    def __exit__(self, *exc) -> None:
        del self.recorder.record  # back to the class's method


def _digest(lines) -> str:
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def round_summary(store, cluster, events: List[tuple]) -> dict:
    """What one scheduler round did, read the same way from either
    package's store and cluster: gangs admitted (GangAdmitted events),
    pods bound (PodBound events), the sum of the admitted gangs' placement
    scores as written to their status, the sha256 of the sorted
    ``ns/pod=node`` bindings, the evicted gangs (Preempted and QuotaReclaim
    events), admitted gangs per queue and event counts by reason."""
    admitted = sorted({(e[1], e[2]) for e in events if e[4] == "GangAdmitted"})
    score_sum = 0.0
    per_queue: Dict[str, int] = {}
    for ns, name in admitted:
        gang = store.get("PodGang", ns, name, readonly=True)
        if gang.status.placement_score is not None:
            score_sum += float(gang.status.placement_score)
        queue = gang.metadata.labels.get(namegen.LABEL_QUEUE) or "default"
        per_queue[queue] = per_queue.get(queue, 0) + 1
    evicted = sorted(f"{e[1]}/{e[2]}" for e in events if e[4] in ("Preempted", "QuotaReclaim"))
    bindings = sorted(f"{ns}/{pod}={node}" for (ns, pod), node in cluster.bindings.items())
    return {
        "admitted": len(admitted),
        "bound": sum(1 for e in events if e[4] == "PodBound"),
        "score_sum": score_sum,
        "bindings": len(bindings),
        "bindings_sha256": _digest(bindings),
        "evicted": len(evicted),
        "evicted_sha256": _digest(evicted),
        "admitted_per_queue": dict(sorted(per_queue.items())),
        "events_by_reason": dict(sorted(Counter(e[4] for e in events).items())),
    }
