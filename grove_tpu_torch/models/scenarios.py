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
``frontier_counters`` read a round the same way on either side;
``observe_summary`` reads a traced round's spans, metrics and journeys and
``explain_burst`` drives an explain engine over a world, again the same way
on either side. This part is plain Python.

``load_sample`` reads the port's own copy of the sample manifests
(``SAMPLES_DIR``). ``run_operator_world`` drives the operator world (ι),
BASELINE's integrated population, through either package's ``SimHarness``
from the same YAML text, and ``run_samples_world`` converges each sample;
``store_digest`` reads a store the same way on either side.

The sim scenarios' worlds run either package's ``sim`` modules the same way:
``run_churn_world`` (κ), the delta churn on (ι)'s converged harness, every
tick's schedule recorded; ``run_scale_world`` (λ), the sharded frontier and
inert A/Bs, each retired harness read (``dump_digest``, census, scalar
resourceVersion, reconciles) before it is released; ``run_sims_world`` (ν),
the contended-quota, single-queue, explain, drain, run-level churn A/B and
demo scenarios at the JAX package's own shapes; ``run_parallel_world`` (π),
the sharded converge at (λ)'s frontier shape through the process drain with
a per-shard WAL, then its crash, recovery and cold restart;
``run_parallel_suite``, the parallel drain's serial-twin A/Bs, worker
crash, boundary faults, worker sweeps and durability report.

``run_cluster_world`` (τ) boots either package's real-cluster operator
(``cluster/manager.start_operator``: the HTTP apiserver, TLS webhooks, the
``HttpStore``, controllers and scheduler), POSTs (ι)'s first K sets to it
as JSON and converges it; ``cluster_summary`` reads the result the same way
on either side.
"""

from __future__ import annotations

import functools
import gc
import hashlib
import importlib
import json
import os
import pathlib
import random
import re
import time
import types
from collections import Counter
from typing import Callable, Dict, List, Optional

import numpy as np

from grove_tpu_torch.api import names as namegen

from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.sim.cluster import make_nodes
from grove_tpu_torch.solver.encode import build_problem
from grove_tpu_torch.solver.types import PackingProblem

# the port's own copy of the sample manifests (byte for byte the JAX
# package's and the repository's samples/)
SAMPLES_DIR = pathlib.Path(__file__).resolve().parent / "samples"

# BASELINE.json acceptance configs (minus the stress sim, which is synthetic)
BASELINE_SAMPLES = {
    "simple": "simple1.yaml",
    "disaggregated": "single-node-disaggregated.yaml",
    "multinode_disaggregated": "multinode-disaggregated.yaml",
    "agentic": "agentic-pipeline.yaml",
}


def load_sample(name: str):
    """Scenario name (or bare filename) → PodCliqueSet object."""
    from grove_tpu_torch.api.load import load_podcliqueset_file

    filename = BASELINE_SAMPLES.get(name, name)
    return load_podcliqueset_file(str(SAMPLES_DIR / filename))


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
    budget_of: Optional[Callable[[int, dict], Optional[dict]]] = None,
) -> List[dict]:
    """Wire documents of the world a PodCliqueSet controller leaves for gang
    specs: per spec (a PodCliqueSet of one replica named after the spec),
    its base PodGang, one PodClique per group and the group's pods, ungated
    and unbound. Groups keep their names as clique template names; a
    group's floor is its PodGroup's ``minReplicas``; the gang's
    ``required_key``/``preferred_key`` and spread, and each group's
    ``required_key``, become the PodGang's topology constraints. Queue
    labels go on every object when ``queue_of`` names a queue.

    With ``budget_of`` each spec also gets its PodCliqueSet document (one
    clique template per group), first among its documents, carrying
    ``spec.template.disruptionBudget`` when ``budget_of(i, spec)`` returns
    one (a wire dict: ``maxUnavailableGangs``, ``quietWindow``). Without
    it the documents are the same as before the parameter existed."""
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
        if budget_of is not None:
            docs.append(_pcs_doc(spec, ns, labels, budget_of(i, spec)))
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


def _pcs_doc(spec: dict, ns: str, labels: Dict[str, str], budget: Optional[dict]) -> dict:
    """The PodCliqueSet document of one gang spec (one replica, a clique
    template per group), with ``budget`` as its disruptionBudget."""
    cliques = [
        {"name": grp["name"],
         "spec": {"roleName": grp["name"], "replicas": grp["count"],
                  "minAvailable": grp["min_count"],
                  "podSpec": {"containers": [{"name": "main", "requests": dict(grp["demand"])}]}}}
        for grp in spec["groups"]
    ]
    template: Dict[str, object] = {"cliques": cliques}
    if budget is not None:
        template["disruptionBudget"] = dict(budget)
    meta_labels = {k: v for k, v in labels.items() if k != namegen.LABEL_PART_OF}
    meta: Dict[str, object] = {"name": spec["name"], "namespace": ns}
    if meta_labels:
        meta["labels"] = meta_labels
    return {"apiVersion": "grove.io/v1alpha1", "kind": "PodCliqueSet", "metadata": meta,
            "spec": {"replicas": 1, "template": template}}


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
      cuts 80 subproblems.
    - ``disruption``: (omega), the disruption world: (q)'s nodes, queues
      and gangs, each gang with its PodCliqueSet and disruption budget, and
      the serving gang ``serve``; :func:`disruption_world` holds its
      settings and :func:`run_disruption_world` its script."""
    capacity = dict(STRESS_CAPACITY)
    if name == "frontier":
        return scheduler_world("delta", n_nodes, n_gangs, 16 if ticks is None else ticks, seed)
    if name == "disruption":
        return disruption_world(n_nodes, n_gangs)
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


# spans and metrics whose values depend on the process (the JAX package's
# XLA compile cache, the port's first load of a CUDA library), not the round
_PROCESS_SPANS = ("solver.compile",)
_PROCESS_METRICS = ("gang_solve_compile_seconds",)


def span_multiset(spans) -> Dict[str, int]:
    """``"name<parent"`` -> count over finished spans, the process-dependent
    spans and their children left out."""
    counts = Counter(
        f"{sp.name}<{sp.parent}"
        for sp in spans
        if sp.name not in _PROCESS_SPANS and sp.parent not in _PROCESS_SPANS
    )
    return dict(sorted(counts.items()))


def observe_summary(tracer, metrics, journeys) -> dict:
    """What a traced round recorded that does not depend on time, read the
    same way from either package's tracer, metrics registry and journey
    tracker: the span multiset, every counter and gauge, each histogram's
    observation count (never its values), the Prometheus series names, and
    the journeys completed."""
    series = sorted(
        {
            line.rpartition(" ")[0]
            for line in metrics.prometheus_text().splitlines()
            if line and not any(m in line for m in _PROCESS_METRICS)
        }
    )
    return {
        "spans": span_multiset(tracer.spans()),
        "counters": dict(sorted(metrics.counters.items())),
        "gauges": dict(sorted(metrics.gauges.items())),
        "histogram_counts": {
            k: v for k, v in sorted(metrics.hist_count.items()) if k not in _PROCESS_METRICS
        },
        "prometheus_series": series,
        "journeys_completed_total": journeys.completed_total,
    }


def strip_timing(doc):
    """An explain, capacity or what-if document less its timing fields
    (``evaluated_in_ms``), at every depth."""
    if isinstance(doc, dict):
        return {k: strip_timing(v) for k, v in doc.items() if k != "evaluated_in_ms"}
    if isinstance(doc, list):
        return [strip_timing(v) for v in doc]
    return doc


def _scheduled(gang) -> bool:
    return any(c.type == "Scheduled" and c.status == "True" for c in gang.status.conditions)


def explain_burst(engine, store, cluster) -> dict:
    """Drive an explain engine (either package's) over a world after a
    round: ``explain`` of every PodGang still pending, of the first
    scheduled one and of an unknown name; ``capacity()``; a ``whatif``
    draining the node of the scheduled gang's first bound pod, for the
    first pending gang; and a ``whatif`` doubling the first pending gang's
    queue's deserved share (or, with no Queue CRs, setting one on
    ``default``). Returns the documents less their timing fields, keyed by
    what was asked."""
    gangs = sorted(store.scan("PodGang"), key=lambda g: (g.metadata.namespace, g.metadata.name))
    pending = [g for g in gangs if not _scheduled(g)]
    admitted = next(g for g in gangs if _scheduled(g))
    out = {}
    for g in pending + [admitted]:
        ns, name = g.metadata.namespace, g.metadata.name
        out[f"explain {ns}/{name}"] = strip_timing(engine.explain(ns, name))
    out["explain default/no-such-gang"] = engine.explain("default", "no-such-gang")
    out["capacity"] = strip_timing(engine.capacity())
    if not pending:
        return out
    target = {"namespace": pending[0].metadata.namespace, "name": pending[0].metadata.name}
    ref = admitted.spec.pod_groups[0].pod_references[0]
    node = cluster.bindings[(ref.namespace, ref.name)]
    out[f"whatif drain-node {node}"] = strip_timing(
        engine.whatif({"gang": target, "actions": [{"action": "drain-node", "node": node}]})
    )
    queue = pending[0].metadata.labels.get(namegen.LABEL_QUEUE) or "default"
    cr = engine.scheduler.quota.queue_crs().get(queue)
    deserved = {r: 2.0 * v for r, v in cr.spec.deserved.items()} if cr is not None else {"cpu": 1.0}
    out[f"whatif set-queue {queue}"] = strip_timing(
        engine.whatif(
            {"gang": target, "actions": [{"action": "set-queue", "queue": queue, "deserved": deserved}]}
        )
    )
    return out


def doc_digests(burst: dict) -> dict:
    """An explain burst as, per document, the sha256 of its canonical JSON
    and the verdict fields a reader checks first (for a what-if, those of
    its ``after``)."""
    out = {}
    for key, doc in burst.items():
        row = {"sha256": _digest([json.dumps(doc, sort_keys=True)])}
        verdict = (doc or {}).get("after", doc) or {}
        for field in ("state", "fits_now", "binding_constraint", "detail", "partition"):
            if field in verdict:
                row[field] = verdict[field]
        if "flipped" in (doc or {}):
            row["flipped"] = doc["flipped"]
        out[key] = row
    return out


# -- the SLO world ------------------------------------------------------------

SLO_TICKS = 12  # the churn world's first ticks
SLO_STEP_S = 10.0  # virtual seconds the clock moves before each round
SLO_WINDOW_S = 300.0  # the series windows read after each round: every round
SLO_TRACKED_COUNTER = "journeys_completed_total"  # mirrored as rate:<name>
SLO_FORECAST_SERIES = "queue_usage/tenant-0"
# (name, objective): the standing backlog's wait breaches the first (it
# ages one step a round); the second is met (the JAX run at full width
# admits every gang within three steps of its arrival: 30 s at most)
SLO_OBJECTIVES = (
    ("backlog-wait", "queue_wait_vt/tenant-0:last < 45s over 10s target 90% budget 60s"
                     " burn 2x 10s/60s"),
    ("admission", "admission_latency_vt:max < 60s over 30s target 90%"),
)
SLO_WALL_SERIES = ("admission_latency",)  # wall-clock seconds: counts only


def slo_windows(timeseries, seconds: float = SLO_WINDOW_S) -> dict:
    """Every series of a time-series store (either package's) reduced over
    one window; a wall-clock series as its sample count only."""
    out = {}
    for name in timeseries.series_names():
        doc = timeseries.window(name, seconds)
        out[name] = {"count": doc.get("count", 0)} if name in SLO_WALL_SERIES else doc
    return out


def slo_status(slo, seconds: float = SLO_WINDOW_S) -> dict:
    """An SLO engine's ``status()`` less its wall-clock series."""
    doc = slo.status(seconds)
    doc["series"] = {k: v for k, v in doc["series"].items() if k not in SLO_WALL_SERIES}
    return doc


def flight_summary(manifest: dict) -> dict:
    """The deterministic part of a flight-recorder bundle (either
    package's): its trigger, the commit-digest ring less wall stamps (count
    and sha256), its events less wall stamps (count and sha256) and the
    multiset of its spans' names."""
    records = [r for shard in manifest["shards"] for r in shard["records"]]
    commits = [{k: r[k] for k in ("vt", "op", "kind", "ns", "name", "rv")}
               for r in records if r["rec"] == "commit"]
    events = [{k: v for k, v in e.items() if k != "t"} for e in manifest["events"]]
    return {
        "reason": manifest["reason"],
        "detail": manifest["detail"],
        "vt": manifest["vt"],
        "records": len(records),
        "commits": len(commits),
        "commits_sha256": _digest([json.dumps(commits, sort_keys=True)]),
        "events": len(events),
        "events_sha256": _digest([json.dumps(events, sort_keys=True)]),
        "spans": dict(sorted(Counter(r["name"] for r in records if r["rec"] == "span").items())),
        "errors": len(manifest["errors"]),
    }


def run_slo_world(pkg, n_nodes: Optional[int] = None, n_gangs: Optional[int] = None,
                  ticks: Optional[int] = None, seed: int = 0, out_dir: Optional[str] = None,
                  scheduler_kwargs: Optional[dict] = None, before_round=None,
                  after_round=None) -> dict:
    """The SLO world through either package: ``pkg`` names its ``Store``,
    ``VirtualClock``, ``SimCluster``, ``make_nodes``, ``GangScheduler``,
    ``ClusterTopology``, ``decode_object``, ``EVENTS``, ``METRICS``,
    ``TRACER``, ``JOURNEYS``, ``TIMESERIES``, ``SLO``, ``SloSpec``,
    ``FORECASTER``, ``FLIGHTREC``, ``install_serving_collector`` and
    ``load_bundle``.

    The churn world (``scheduler_world("delta")``, ``SLO_TICKS`` ticks)
    through a delta scheduler with the tracer, journeys, time series, SLO
    engine, forecaster and flight recorder on (every layer on the world's
    virtual clock, the serving collector installed, ``SLO_OBJECTIVES``
    added, ``SLO_TRACKED_COUNTER`` tracked). Before each round the tick's
    documents are applied and the clock moves ``SLO_STEP_S``; after it come
    ``TIMESERIES.sample(now)`` and ``SLO.evaluate(now)``, as the JAX
    harness does at a tick boundary. Per round: ``round_summary`` (events
    of the round and of its evaluation) and the sha256 of
    :func:`slo_windows`. Then: the windows, the wall series' counts, the SLO
    status (:func:`slo_status`), the forecast of ``SLO_FORECAST_SERIES``,
    and the first flight bundle's :func:`flight_summary`.

    ``before_round(index)`` runs just before a round's ``schedule_pending``
    and ``after_round(index, wall_s, observe_s, summary)`` just after its
    evaluation (the card's launch counts and timings)."""
    import time

    world = scheduler_world("delta", n_nodes, n_gangs, SLO_TICKS if ticks is None else ticks,
                            seed)
    store = pkg.Store(pkg.VirtualClock(0.0))
    clock = store.clock
    cluster = pkg.SimCluster(store, pkg.make_nodes(*world["nodes"]))
    sched = pkg.GangScheduler(store, cluster, pkg.ClusterTopology(), world["priority_map"],
                              **(scheduler_kwargs or {}))
    assert sched.enable_delta()
    layers = (pkg.TRACER, pkg.JOURNEYS, pkg.TIMESERIES, pkg.SLO, pkg.FORECASTER, pkg.FLIGHTREC)
    for layer in layers:
        layer.reset()
    pkg.METRICS.reset()
    pkg.EVENTS.reset()
    pkg.TRACER.clock = pkg.EVENTS.clock = pkg.JOURNEYS.clock = clock
    pkg.TRACER.enable()
    pkg.JOURNEYS.enable()
    pkg.TIMESERIES.enable(clock=clock)
    pkg.SLO.enable()
    pkg.FORECASTER.enable(clock=clock)
    pkg.FLIGHTREC.enable(out_dir=out_dir, clock=clock)
    collector = None
    try:
        for name, text in SLO_OBJECTIVES:
            pkg.SLO.add(pkg.SloSpec.parse(text, name=name))
        pkg.TIMESERIES.track_counter(SLO_TRACKED_COUNTER)
        collector = pkg.install_serving_collector(store, sched, clock)
        for doc in world["queues"] + world["rounds"][0]:
            store.create(pkg.decode_object(doc), consume=True)
        rounds = []
        for index, tick in enumerate([None] + world["ticks"]):
            if tick:
                apply_tick(store, cluster, tick, pkg.decode_object)
            clock.advance(SLO_STEP_S)
            if before_round is not None:
                before_round(index)
            with EventCapture(pkg.EVENTS) as cap:
                t0 = time.perf_counter()
                sched.schedule_pending()
                t1 = time.perf_counter()
                now = clock.now()
                pkg.TIMESERIES.sample(now)
                pkg.SLO.evaluate(now)
                t2 = time.perf_counter()
            summary = round_summary(store, cluster, cap.events)
            summary["windows_sha256"] = _digest(
                [json.dumps(slo_windows(pkg.TIMESERIES), sort_keys=True)])
            if after_round is not None:
                after_round(index, t1 - t0, t2 - t1, summary)
            rounds.append(summary)
        now = clock.now()
        dumps = list(pkg.FLIGHTREC.dumps)
        return {
            "rounds": rounds,
            "windows": slo_windows(pkg.TIMESERIES),
            "status": slo_status(pkg.SLO),
            "forecast": pkg.FORECASTER.forecast(SLO_FORECAST_SERIES, now=now),
            "dumps": len(dumps),
            "flight": flight_summary(pkg.load_bundle(dumps[0])) if dumps else None,
        }
    finally:
        if collector is not None:
            pkg.TIMESERIES.remove_collector(collector)
        for layer in layers:
            layer.disable()
        pkg.TRACER.clock = pkg.JOURNEYS.clock = None


# -- the disruption world -----------------------------------------------------

DISRUPTION_STEP_S = 10.0  # virtual seconds the clock moves before each round
# the broker and monitor settings (those of the JAX package's disruption and
# gray-failure tests) and the fail-slow fault's lag window
DISRUPTION_BROKER = {"bucket_capacity": 2, "refill_per_second": 0.0, "close_after": 30.0}
DISRUPTION_MONITOR = {"failslow_threshold": 1.5}
DISRUPTION_LAG = (2.0, 4.5)
DISRUPTION_STORM = 4  # critical preemptors in tenant-1
DISRUPTION_MAX_ROUNDS = 30
_NOTABLE_SKIP = ("GangAdmitted", "PodBound")


def _parity_budget(i: int, spec: dict) -> dict:
    """Gang i's disruption budget: none may go for even i, one at a time
    and 30 s apart for odd i."""
    if i % 2 == 0:
        return {"maxUnavailableGangs": 0}
    return {"maxUnavailableGangs": 1, "quietWindow": "30s"}


def _unit_specs(prefix: str, n: int, demand: Dict[str, float], count: int = 1,
                min_count: int = 1) -> List[dict]:
    return [{"name": f"{prefix}{k}", "required_key": None, "preferred_key": None, "priority": 0,
             "groups": [{"name": f"{prefix}{k}-0", "demand": dict(demand), "count": count,
                         "min_count": min_count}]} for k in range(n)]


def disruption_world(n_nodes: Optional[int] = None, n_gangs: Optional[int] = None) -> dict:
    """(omega)'s settings: (q)'s nodes, queues and gangs (gang i in tenant-(i
    % 8)), each gang with its PodCliqueSet and a disruption budget by the
    parity of i (:func:`_parity_budget`), and ``serve`` in ``default`` (no
    queue, budget 0): one clique of two 8-chip pods of which one may be
    lost, so each of its pods holds a node alone. ``reserved`` is the node
    cordoned before round 1 and returned for the crash's replacement."""
    n_nodes = n_nodes or 5120
    specs = stress_gang_specs(n_gangs or 10240, seed=0)
    share = {r: v * n_nodes / 8 for r, v in STRESS_CAPACITY.items()}
    docs = gang_world_docs(_unit_specs("serve", 1, {"tpu": 8.0, "cpu": 16.0}, count=2),
                           budget_of=lambda i, spec: {"maxUnavailableGangs": 0})
    docs += gang_world_docs(specs, namespace_of=_tenant, queue_of=_tenant,
                            budget_of=_parity_budget)
    return {
        "nodes": (n_nodes, dict(STRESS_CAPACITY), 8, 8),
        "priority_map": {"critical": 100},
        "queues": queue_docs({f"tenant-{k}": share for k in range(8)}),
        "rounds": [docs],
        "reserved": f"node-{n_nodes - 1}",
    }


def _gang_of(doc: dict) -> tuple:
    meta = doc["metadata"]
    if doc["kind"] in ("PodGang", "PodCliqueSet"):
        name = meta["name"] if doc["kind"] == "PodGang" else namegen.base_podgang_name(meta["name"], 0)
    else:
        name = meta["labels"][namegen.LABEL_PODGANG]
    return meta.get("namespace", "default"), name


def _delete_gang(store, docs: List[dict]) -> None:
    """Delete one gang's objects that still exist: pods, cliques, PodGang,
    PodCliqueSet."""
    order = {"Pod": 0, "PodClique": 1, "PodGang": 2, "PodCliqueSet": 3}
    for doc in sorted(docs, key=lambda d: order[d["kind"]]):
        key = (doc["kind"], doc["metadata"]["namespace"], doc["metadata"]["name"])
        if store.get(*key, readonly=True) is not None:
            store.delete(*key)


def _event_key(event: tuple) -> list:
    """An event as compared across packages: a GangAdmitted message (its
    placement score to four places) is left out, the score being held at
    rtol 1e-6 through ``score_sum``."""
    return list(event[:5]) if event[4] == "GangAdmitted" else list(event)


def run_disruption_world(pkg, n_nodes: Optional[int] = None, n_gangs: Optional[int] = None,
                         seed: int = 0, before_round=None, after_round=None,
                         scheduler_kwargs: Optional[dict] = None, inspect=None) -> dict:
    """The disruption world (omega) through either package: ``pkg`` names
    its ``Store``, ``VirtualClock``, ``SimCluster``, ``make_nodes``,
    ``GangScheduler``, ``ClusterTopology``, ``decode_object``, ``EVENTS``,
    ``METRICS``, ``LEDGER``, ``DisruptionBroker``, ``NodeDrainController``,
    ``NodeHealthMonitor``, ``RemediationController``,
    ``HorizontalAutoscaler``, ``StaticMetricsProvider`` and
    ``ExplainEngine``.

    One delta scheduler with a broker (``DISRUPTION_BROKER``) and a
    node-health monitor (``DISRUPTION_MONITOR``), a drain controller, an
    autoscaler, an explain engine and a remediator over one store. Each
    round the clock moves ``DISRUPTION_STEP_S``, then: the script's step,
    ``monitor.tick()``, ``drainer.tick()``, the world recreates every pod
    of a live gang that is gone (under its name, as the PodClique
    controller would), ``schedule_pending()``, ``cluster.heartbeat_tick()``
    and ``remediator.tick()`` (the JAX harness's order). The script, each
    step decided from the state the same way on either side:

    1. ``reserved`` is cordoned, the queues and the world are created:
       the admission round (the broker is armed by the budgets).
    2. ``serve`` must be placed; every gang still pending is deleted, and
       one-pod filler gangs (``filler/fill<k>``, one chip and one cpu, no
       budget, no queue) as many as the schedulable nodes' free chips
       fill the cluster.
    3. The storm: ``DISRUPTION_STORM`` one-chip gangs of priority class
       ``critical`` in tenant-1 (``storm<k>``) fit nowhere. Every gang of
       budget 0 is refused by ``would_allow``; fillers (no budget) go
       first in the victim order: the first two preemptors are granted a
       filler each, the third empties the token bucket and opens the
       breaker (``BreakerOpen``, ``DisruptionThrottled``), the fourth
       finds no victim the open breaker allows.
    4. Every filler is deleted (the preemptors place on the capacity it
       returns); quiet rounds until the breaker closes (``BreakerClosed``,
       30 s after it opened, which refills the bucket).
    5. The round after: ``crash_node`` on ``rescue`` (the node of
       ``serve``'s first pod, which holds nothing else) and ``requeue``
       (the node of the first bound pod of tenant-3's first scheduled
       gang by name). 30 s later both are Lost: ``serve`` keeps its floor
       and is rescued once its recreated pod lands on ``reserved``,
       uncordoned in that round; every gang on ``requeue`` breaks its
       floor and is requeued (``GangRequeued``), held for that round with
       its pods pending, and released (``GangBackoffReleased``) into the
       next.
    6. Once no gang is held, on probation or mid-rescue: drains of
       ``drain`` (the first schedulable node holding exactly one gang, of
       budget 1: pre-placed by its trial, evicted whole, readmitted) and
       ``held`` (the first holding only tenants' gangs of budget 0: denied
       by the budget every round, it stays Draining).
    7. Once ``drain`` reports Drained: ``held`` is uncordoned, the
       remediator enabled, and ``inject_failslow(failslow, seed, 2.0,
       4.5)`` arms the fail-slow fault on ``failslow`` (chosen as ``drain``
       was, among the nodes left). The monitor turns it Degraded; the remediator's what-if
       proves its gang re-places, requests the drain and records a ledger
       entry; the drain evicts and the gang is readmitted. The world ends
       one round after ``failslow`` reports Drained.

    Per round: ``round_summary`` and the script's step, trial solves
    (``_solve_batch`` calls outside the round's own solve), ``would_allow``
    calls and refusals, the broker's tokens, breaker and last grants, the
    monitor's held, probation, rescue sets, rescues and the sha256 of
    ``node_snapshot()``, ``drainer.states()`` and its evictions, the
    ledger's entries less timing, and the round's events (all but
    GangAdmitted and PodBound in full, every event as a sha256, a
    GangAdmitted one less its message).
    ``before_round(index)`` runs first in a round, ``after_round(index,
    walls, record)`` last (``walls``: seconds of the round and of its
    monitor, drain, schedule and remediator parts), and ``inspect(store,
    cluster)`` once after the last round. Returns ``{"rounds", "names"}``
    (``names``: what the script chose)."""
    import time

    world = scheduler_world("disruption", n_nodes, n_gangs)
    store = pkg.Store(pkg.VirtualClock(0.0))
    clock = store.clock
    cluster = pkg.SimCluster(store, pkg.make_nodes(*world["nodes"]))
    sched = pkg.GangScheduler(store, cluster, pkg.ClusterTopology(), world["priority_map"],
                              **(scheduler_kwargs or {}))
    assert sched.enable_delta()
    broker = pkg.DisruptionBroker(store, **DISRUPTION_BROKER)
    monitor = pkg.NodeHealthMonitor(store, cluster, **DISRUPTION_MONITOR)
    sched.broker, sched.monitor = broker, monitor
    drainer = pkg.NodeDrainController(store, cluster, sched, monitor, broker)
    monitor.drain_states = drainer.states
    autoscaler = pkg.HorizontalAutoscaler(store, pkg.StaticMetricsProvider(),
                                          scale_down_stabilization=60.0)
    remediator = pkg.RemediationController(store, cluster, sched, drainer, broker, autoscaler,
                                           pkg.ExplainEngine(sched))
    remediator.disable()
    pkg.EVENTS.reset()
    pkg.METRICS.reset()
    pkg.LEDGER.reset()
    pkg.LEDGER.enable(clock=clock)
    pkg.EVENTS.clock = clock

    counts = {"trials": 0, "would_allow": 0, "refused": 0}
    allow, solve = broker.would_allow, sched._solve_batch

    def counted_allow(gang, now=None):
        ok = allow(gang, now)
        counts["would_allow"] += 1
        counts["refused"] += not ok
        return ok

    def counted_solve(*args, **kwargs):
        if "problem" not in kwargs:  # the round's own solve passes its problem
            counts["trials"] += 1
        return solve(*args, **kwargs)

    broker.would_allow, sched._solve_batch = counted_allow, counted_solve
    nodes = {n.name: n for n in cluster.nodes}
    gangs: Dict[tuple, List[dict]] = {}  # live gangs' documents
    names: Dict[str, object] = {"reserved": world["reserved"]}

    def create(docs):
        for doc in docs:
            store.create(pkg.decode_object(doc))
            if doc["kind"] != "Queue":
                gangs.setdefault(_gang_of(doc), []).append(doc)

    def delete(keys):
        for key in sorted(keys):
            _delete_gang(store, gangs.pop(key))

    def scheduled(key) -> bool:
        gang = store.get("PodGang", key[0], key[1], readonly=True)
        return gang is not None and _scheduled(gang)

    def gangs_by_node() -> Dict[str, set]:
        out: Dict[str, set] = {}
        for (ns, pod), node in cluster.bindings.items():
            view = store.get("Pod", ns, pod, readonly=True)
            if view is not None:
                out.setdefault(node, set()).add((ns, view.metadata.labels[namegen.LABEL_PODGANG]))
        return out

    def budget(key):
        pcs = store.get("PodCliqueSet", key[0], key[1].rsplit("-", 1)[0], readonly=True)
        db = pcs.spec.template.disruption_budget if pcs is not None else None
        return None if db is None else db.max_unavailable_gangs

    def pick(taken, want) -> str:
        by_node = gangs_by_node()
        for node in cluster.nodes:
            held = sorted(by_node.get(node.name, ()))
            if node.schedulable and node.name not in taken and held and want(held):
                return node.name
        raise AssertionError("disruption world: no node fits the script")

    def recreate():
        for key, docs in gangs.items():
            for doc in docs:
                if doc["kind"] == "Pod" and store.get(
                        "Pod", key[0], doc["metadata"]["name"], readonly=True) is None:
                    store.create(pkg.decode_object(doc))

    def record(index, script, events) -> dict:
        rec = round_summary(store, cluster, events)
        snapshot = monitor.node_snapshot()
        rec.update({
            "round": index + 1,
            "script": script,
            "trials": counts["trials"],
            "would_allow": counts["would_allow"],
            "refused": counts["refused"],
            "broker": {"tokens": broker._tokens, "breaker_open": broker.breaker_open,
                       "last_grant": sorted([f"{k[0]}/{k[1]}", v]
                                            for k, v in broker._last_grant.items())},
            "monitor": {
                "held": sorted(f"{k[0]}/{k[1]}" for k in monitor._held),
                "probation": sorted(f"{k[0]}/{k[1]}" for k in monitor._probation),
                "rescue_pending": sorted(f"{k[0]}/{k[1]}" for k in monitor._rescue_pending),
                "rescues": json.loads(json.dumps(monitor.rescues)),
                "states": dict(sorted(Counter(row["state"] for row in snapshot).items())),
                "nodes_sha256": _digest([json.dumps(snapshot, sort_keys=True)]),
            },
            "drain": dict(sorted(drainer.states().items())),
            "drained_gangs": json.loads(json.dumps(drainer.drained_gangs)),
            "ledger": strip_timing(json.loads(json.dumps(pkg.LEDGER.entries()))),
            "events": [list(e) for e in events if e[4] not in _NOTABLE_SKIP],
            "events_sha256": _digest([json.dumps(_event_key(e)) for e in events]),
        })
        return rec

    phase = "admission"
    denied_rounds = 0
    rounds = []
    try:
        for index in range(DISRUPTION_MAX_ROUNDS):
            if before_round is not None:
                before_round(index)
            counts.update(trials=0, would_allow=0, refused=0)
            t0 = time.perf_counter()
            clock.advance(DISRUPTION_STEP_S)
            script: List[str] = []
            with EventCapture(pkg.EVENTS) as cap:
                if phase == "admission":
                    nodes[world["reserved"]].cordoned = True
                    create(world["queues"] + world["rounds"][0])
                    script.append(f"cordon {world['reserved']}; create the world")
                    phase = "fill"
                elif phase == "fill":
                    assert scheduled(("default", "serve0-0")), "serve was not placed"
                    stuck = [k for k in gangs if not scheduled(k)]
                    delete(stuck)
                    live = [n for n in cluster.nodes if n.schedulable]
                    free = cluster.node_free_all(live)
                    n_fill = sum(int(min(free[n.name].get("tpu", 0.0), free[n.name].get("cpu", 0.0)))
                                 for n in live)
                    create(gang_world_docs(_unit_specs("fill", n_fill, {"tpu": 1.0, "cpu": 1.0}),
                                           namespace_of=lambda i, spec: "filler",
                                           budget_of=lambda i, spec: None))
                    names.update(deleted_pending=[f"{k[0]}/{k[1]}" for k in sorted(stuck)],
                                 fillers=n_fill)
                    script.append(f"delete {len(stuck)} pending gangs; create {n_fill} fillers")
                    phase = "storm"
                elif phase == "storm":
                    create(gang_world_docs(
                        _unit_specs("storm", DISRUPTION_STORM, {"tpu": 1.0, "cpu": 1.0}),
                        namespace_of=lambda i, spec: "tenant-1", queue_of=lambda i, spec: "tenant-1",
                        priority_class_of=lambda i, spec: "critical", budget_of=lambda i, spec: None))
                    script.append(f"create {DISRUPTION_STORM} critical gangs in tenant-1")
                    phase = "calm"
                elif phase == "calm":
                    gone = [k for k in gangs if k[0] == "filler"]
                    delete(gone)
                    script.append(f"delete {len(gone)} fillers")
                    phase = "quiet"
                elif phase == "quiet" and not broker.breaker_open:
                    serve_pods = sorted((ns, pod) for (ns, pod) in cluster.bindings
                                        if ns == "default" and pod.startswith("serve0-"))
                    rescue = cluster.bindings[serve_pods[0]]
                    tenant3 = sorted(k for k in gangs if k[0] == "tenant-3" and scheduled(k))
                    by_node = gangs_by_node()
                    requeue = next(node.name for node in cluster.nodes
                                   if tenant3[0] in by_node.get(node.name, ())
                                   and node.name != rescue)
                    cluster.crash_node(rescue)
                    cluster.crash_node(requeue)
                    names.update(rescue=rescue, requeue=requeue,
                                 requeued=[f"{k[0]}/{k[1]}" for k in sorted(by_node[requeue])])
                    script.append(f"crash {rescue} and {requeue}")
                    phase = "crashed"
                elif phase == "crashed" and (
                        clock.now() - nodes[names["rescue"]].last_heartbeat >= monitor.lost_after):
                    nodes[world["reserved"]].cordoned = False
                    script.append(f"uncordon {world['reserved']}")
                    phase = "recovering"
                elif phase == "recovering" and monitor.rescues and not (
                        monitor._held or monitor._probation or monitor._rescue_pending):
                    taken = {names["rescue"], names["requeue"], world["reserved"]}
                    drain = pick(taken, lambda held: len(held) == 1 and budget(held[0]) == 1)
                    held_node = pick(taken | {drain}, lambda held: all(
                        k[0] != "default" and budget(k) == 0 for k in held))
                    drainer.request_drain(drain)
                    drainer.request_drain(held_node)
                    names.update(drain=drain, held=held_node)
                    script.append(f"drain {drain} and {held_node}")
                    phase = "draining"
                elif phase == "draining":
                    denied_rounds += 1
                    if drainer.states().get(names["drain"]) == "Drained" and denied_rounds >= 2:
                        taken = {names[k] for k in ("rescue", "requeue", "reserved", "drain",
                                                    "held")}
                        failslow = pick(taken, lambda held: len(held) == 1 and budget(held[0]) == 1)
                        drainer.uncordon(names["held"])
                        remediator.enable()
                        cluster.inject_failslow(failslow, seed, *DISRUPTION_LAG)
                        names["failslow"] = failslow
                        script.append(f"uncordon {names['held']}; enable the remediator;"
                                      f" fail-slow {failslow}")
                        phase = "failslow"
                elif phase == "failslow" and drainer.states().get(names["failslow"]) == "Drained":
                    phase = "done"
                    script.append("done")
                t_monitor = time.perf_counter()
                monitor.tick()
                t_drain = time.perf_counter()
                drainer.tick()
                t_recreate = time.perf_counter()
                recreate()
                t_sched = time.perf_counter()
                sched.schedule_pending()
                t_heartbeat = time.perf_counter()
                cluster.heartbeat_tick()
                t_remediate = time.perf_counter()
                remediator.tick()
                t_end = time.perf_counter()
            rec = record(index, script, cap.events)
            walls = {"round_s": t_end - t0, "monitor_s": t_drain - t_monitor,
                     "drain_s": t_recreate - t_drain, "schedule_s": t_heartbeat - t_sched,
                     "remediate_s": t_end - t_remediate}
            if after_round is not None:
                after_round(index, walls, rec)
            rounds.append(rec)
            if phase == "done":
                break
        if inspect is not None:
            inspect(store, cluster)
        return {"rounds": rounds, "names": names}
    finally:
        del broker.would_allow, sched._solve_batch
        pkg.LEDGER.disable()
        pkg.EVENTS.clock = None


def disruption_missing(result: dict) -> List[str]:
    """The scripted events of :func:`run_disruption_world` that its run did
    not show (empty when every one showed)."""
    rounds, names = result["rounds"], result["names"]
    reasons = Counter(e[4] for rec in rounds for e in rec["events"])
    reasons.update({k: v for rec in rounds for k, v in rec["events_by_reason"].items()
                    if k in _NOTABLE_SKIP})
    last = rounds[-1] if rounds else {}
    drained = {(d["node"], d["pre_placed"]) for d in last.get("drained_gangs", [])}
    checks = {
        "a budget-0 victim refused by would_allow": any(r["refused"] for r in rounds),
        "a budget denial": any(e[4] == "DisruptionThrottled" and "disruptionBudget" in e[5]
                               for rec in rounds for e in rec["events"]),
        "a granted preemption": reasons["Preempted"] > 0,
        "the breaker opening": reasons["BreakerOpen"] > 0,
        "the breaker closing": reasons["BreakerClosed"] > 0,
        "a rescue": reasons["GangRescued"] > 0,
        "a requeue": reasons["GangRequeued"] > 0,
        "a held round": any(r["monitor"]["held"] for r in rounds),
        "a release": reasons["GangBackoffReleased"] > 0,
        "a drain that relocates": (names.get("drain"), True) in drained,
        "a drain held by a budget": any(r["drain"].get(names.get("held")) == "Draining"
                                        for r in rounds),
        "a fail-slow node": reasons["NodeDegraded"] > 0,
        "a fail-slow drain": (names.get("failslow"), True) in drained and any(
            e["outcome"] == "executed" and e["trigger"]["kind"] == "fail-slow"
            for e in last.get("ledger", [])),
    }
    return [what for what, shown in checks.items() if not shown]


# ---------------------------------------------------------------------------
# The operator world (iota): BASELINE's integrated population through the
# whole operator (bench.py integrated_stress_bench / _run_population_bench)
# ---------------------------------------------------------------------------

OPERATOR_SETS = 10_240
OPERATOR_NODES = 5_120
# the rolling update changes the image of every set i with i % 16 == 0 (the
# simple1 sets); 64 would update one set in four of those
OPERATOR_UPDATE_EVERY = 16
OPERATOR_IMAGE = "busybox:1.36"

# bench.py's _STANDALONE_YAML: two cliques of two 10m-cpu pods (57 sets in 64)
OPERATOR_STANDALONE_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: standalone
spec:
  replicas: 1
  template:
    cliques:
      - name: server
        spec:
          roleName: role-server
          replicas: 2
          podSpec:
            containers:
              - name: server
                image: busybox:stable
                resources:
                  requests:
                    cpu: 10m
      - name: worker
        spec:
          roleName: role-worker
          replicas: 2
          podSpec:
            containers:
              - name: worker
                image: busybox:stable
                resources:
                  requests:
                    cpu: 10m
"""

SAMPLE_FILES = (
    "agentic-pipeline.yaml",
    "cluster-topology-tpu.yaml",
    "drain-budget.yaml",
    "multinode-disaggregated.yaml",
    "multitenant-queues.yaml",
    "simple1.yaml",
    "simple2-explicit-startup-order.yaml",
    "simple3-explicit-startup-order.yaml",
    "single-node-disaggregated.yaml",
    "spread-serving.yaml",
)

_UID_RE = re.compile(r"uid-[0-9a-f]{8}-([0-9]+)")
# a gang's placement score (its status and the Scheduled condition's message,
# mirrored into the PodCliqueSet's status): the card and the CPU agree on it
# to rtol 1e-6, not bit for bit, so the digest leaves it out and
# ``operator_summary`` sums it apart
_SCORE_RE = re.compile(r'("placementScore": |placement score )(-?[0-9][0-9.]*(?:e[-+]?[0-9]+)?)')


def operator_template(i: int) -> str:
    """The template of set ``i``, by ``r = i % 64`` (bench.py's mix):
    simple1 where ``r % 16 == 0``, multinode-disaggregated at 8, the agentic
    pipeline at 24 and 56, else the standalone two-clique set."""
    r = i % 64
    if r % 16 == 0:
        return "simple"
    if r == 8:
        return "multinode_disaggregated"
    if r in (24, 56):
        return "agentic"
    return "standalone"


def operator_world(n_sets: Optional[int] = None, n_nodes: Optional[int] = None,
                   update_every: Optional[int] = None) -> dict:
    """(iota) as YAML text and sizes: ``n_sets`` PodCliqueSets ``svc-%05d``
    on ``n_nodes`` nodes of the harness's ``make_nodes``; the rolling update
    changes the container image of every set ``i`` with
    ``i % update_every == 0`` (all simple1 sets)."""
    update_every = OPERATOR_UPDATE_EVERY if update_every is None else update_every
    if update_every % 16:
        raise ValueError("update_every must be a multiple of 16 (simple1 sets only)")
    texts = {name: (SAMPLES_DIR / BASELINE_SAMPLES[name]).read_text()
             for name in ("simple", "multinode_disaggregated", "agentic")}
    texts["standalone"] = OPERATOR_STANDALONE_YAML
    return {
        "n_sets": OPERATOR_SETS if n_sets is None else n_sets,
        "n_nodes": OPERATOR_NODES if n_nodes is None else n_nodes,
        "update_every": update_every,
        "texts": texts,
    }


def store_census(store) -> dict:
    """Objects and the highest resourceVersion of each kind."""
    out = {}
    for kind in store.kinds():
        objs = list(store.scan(kind))
        out[kind] = [len(objs), max(o.metadata.resource_version for o in objs)]
    return out


def store_digest(store, export: Callable) -> dict:
    """sha256 per kind of the store's wire documents (``export``: either
    package's ``api/serialize.export_object``), Events left out, objects in
    (namespace, name) order. Each uid becomes ``uid#<rank>``, its rank in
    creation order among the uids the documents hold, so the incarnation
    token drops out; the objects keep their order. Placement scores become
    ``<score>`` (``operator_summary`` sums them)."""
    docs = {}
    for kind in store.kinds():
        if kind == "Event":
            continue
        objs = sorted(store.scan(kind), key=lambda o: (o.metadata.namespace, o.metadata.name))
        docs[kind] = [json.dumps(export(o), sort_keys=True) for o in objs]
    seqs = sorted({int(m) for lines in docs.values() for line in lines
                   for m in _UID_RE.findall(line)})
    rank = {n: i for i, n in enumerate(seqs)}

    def canon(line: str) -> str:
        line = _SCORE_RE.sub(lambda m: f"{m.group(1)}<score>", line)
        return _UID_RE.sub(lambda m: f"uid#{rank[int(m.group(1))]}", line)

    return {kind: _digest([canon(line) for line in lines]) for kind, lines in docs.items()}


def _bindings_sha256(cluster) -> str:
    return _digest(sorted(f"{ns}/{pod}={node}" for (ns, pod), node in cluster.bindings.items()))


def _converge_recorded(pkg, harness, max_ticks: int, step: str, after_tick=None) -> dict:
    """``harness.converge`` with every tick recorded: ``tick_once()``'s
    (work, bound, started) and ``round_summary`` of the tick's schedule,
    and every event recorded in the converge as (reason, kind) counts."""
    ticks: List[dict] = []
    tick_once, schedule = harness.tick_once, harness.schedule
    sched_events: List[tuple] = []
    with EventCapture(pkg.EVENTS) as cap:

        def scheduled():
            start = len(cap.events)
            bound = schedule()
            sched_events[:] = cap.events[start:]
            return bound

        def tick():
            t0 = time.perf_counter()
            sched_events.clear()
            work, bound, started = tick_once()
            ticks.append({"work": work, "bound": bound, "started": started,
                          "round": round_summary(harness.store, harness.cluster, sched_events)})
            if after_tick is not None:
                after_tick(step, len(ticks), time.perf_counter() - t0, ticks[-1])
            return work, bound, started

        harness.schedule, harness.tick_once = scheduled, tick
        try:
            n = harness.converge(max_ticks=max_ticks)
        finally:
            del harness.schedule, harness.tick_once
    assert n == len(ticks)
    events = Counter(f"{e[4]}/{e[0]}" for e in cap.events)
    return {"ticks": ticks, "events": dict(sorted(events.items()))}


def operator_summary(pkg, harness) -> dict:
    """The store after a converge, read the same way from either package."""
    pods = list(harness.store.scan("Pod"))
    gangs = sorted(harness.store.scan("PodGang"),
                   key=lambda g: (g.metadata.namespace, g.metadata.name))
    scores = [float(g.status.placement_score) for g in gangs
              if g.status.placement_score is not None]
    reconciles = {k.split("/", 1)[1]: v for k, v in pkg.METRICS.counters.items()
                  if k.startswith("reconcile_total/")}
    return {
        "all_ready": bool(pods) and all(pkg.is_ready(p) for p in pods),
        "resource_version": harness.store.resource_version,
        "census": store_census(harness.store),
        "reconcile_total": dict(sorted(reconciles.items())),
        "digest": store_digest(harness.store, pkg.export_object),
        "scored_gangs": len(scores),
        "score_sum": sum(scores),
        "bindings_sha256": _bindings_sha256(harness.cluster),
    }


def package_names(module: Callable[[str], object], demo_text: Callable[[str], str],
                  root: str) -> types.SimpleNamespace:
    """The names ``run_operator_world``, ``run_samples_world``,
    ``run_churn_world``, ``run_scale_world``, ``run_sims_world`` and
    ``run_cluster_world`` read
    from one package: ``module(path)`` imports ``<package>.<path>``,
    ``demo_text(manifest_text)`` is what the package's demo prints for a
    manifest, ``root`` the package's name."""
    return types.SimpleNamespace(
        root=root,
        SimHarness=module("sim.harness").SimHarness,
        load_podcliquesets=module("api.load").load_podcliquesets,
        load_manifest_objects=module("api.load").load_manifest_objects,
        OperatorConfiguration=module("config.operator").OperatorConfiguration,
        deep_copy=module("api.meta").deep_copy,
        reset_uid_namespace=module("api.meta").reset_uid_namespace,
        export_object=module("api.serialize").export_object,
        is_ready=module("api.pod").is_ready,
        METRICS=module("observability.metrics").METRICS,
        EVENTS=module("observability.events").EVENTS,
        TRACER=module("observability.tracing").TRACER,
        JOURNEYS=module("observability.journey").JOURNEYS,
        FLIGHTREC=module("observability.flightrec").FLIGHTREC,
        TIMESERIES=module("observability.timeseries").TIMESERIES,
        deltachurn=module("sim.deltachurn"),
        scale=module("sim.scale"),
        parallel=module("sim.parallel"),
        recovery=module("sim.recovery"),
        store_dump=module("sim.recovery").store_dump,
        # the port keeps it in sim/recovery; the JAX package in sim/chaos
        resource_signature=getattr(module("sim.recovery"), "resource_signature", None)
        or module("sim.chaos").resource_signature,
        recover_store=module("durability").recover_store,
        verify_acked_prefix=module("durability").verify_acked_prefix,
        multitenant=module("sim.multitenant"),
        voluntary=module("sim.voluntary"),
        demo_text=demo_text,
        make_nodes=module("sim.cluster").make_nodes,
        load_operator_configuration=module("config.operator").load_operator_configuration,
        start_operator=module("cluster.manager").start_operator,
    )


def port_names(device=None) -> types.SimpleNamespace:
    """``package_names`` of this package; the harnesses' and the demo's
    solves run on ``device`` (the card unless the caller passes "cpu")."""
    def module(path: str):
        return importlib.import_module(f"grove_tpu_torch.{path}")

    demo = module("sim.demo")
    return package_names(module, functools.partial(demo.run_demo, device=device),
                         "grove_tpu_torch")


def _reset_singletons(pkg) -> None:
    for layer in (pkg.TRACER, pkg.EVENTS, pkg.JOURNEYS, pkg.FLIGHTREC, pkg.TIMESERIES):
        layer.clock = None


def run_operator_world(pkg, n_sets: Optional[int] = None, n_nodes: Optional[int] = None,
                       update_every: Optional[int] = None, device=None,
                       after_tick=None, then=None) -> dict:
    """Run (iota) through ``pkg``'s own harness (either package; ``pkg``
    names ``SimHarness``, ``load_podcliquesets``, ``deep_copy``,
    ``export_object``, ``is_ready``, ``reset_uid_namespace`` and the
    ``METRICS``, ``EVENTS``, ``TRACER``, ``JOURNEYS``, ``FLIGHTREC`` and
    ``TIMESERIES`` singletons). Apply every set, converge with cyclic GC
    frozen and off (as ``_run_population_bench``), then the rolling update
    and a second converge; ``after_tick(step, index, wall_s, tick)`` sees
    every tick. Returns the record both packages must agree on,
    and under ``"walls"`` the host times (left out of any comparison).
    ``device`` goes to the port's harness (None for the JAX one).
    ``then(harness)``, when given, runs on the converged harness before the
    singletons' clocks are released; its return value lands under
    ``"then"`` (the churn world (kappa) continues on (iota) so)."""
    world = operator_world(n_sets, n_nodes, update_every)
    n = world["n_sets"]
    pkg.reset_uid_namespace()
    pkg.METRICS.reset()
    pkg.EVENTS.reset()
    kwargs = {} if device is None else {"device": device}
    harness = pkg.SimHarness(num_nodes=world["n_nodes"], **kwargs)
    bases = {name: pkg.load_podcliquesets(text)[0] for name, text in world["texts"].items()}
    walls: Dict[str, object] = {}
    record: Dict[str, object] = {"world": {k: world[k] for k in ("n_sets", "n_nodes",
                                                               "update_every")}}
    try:
        t0 = time.perf_counter()
        for i in range(n):
            pcs = pkg.deep_copy(bases[operator_template(i)])
            pcs.metadata.name = f"svc-{i:05d}"
            harness.apply(pcs)
        walls["apply_s"] = time.perf_counter() - t0
        record["apply"] = {"resource_version": harness.store.resource_version,
                           "census": store_census(harness.store)}
        converges = []
        for step in ("converge", "rolling_update"):
            if step == "rolling_update":
                t0 = time.perf_counter()
                for i in range(0, n, world["update_every"]):
                    pcs = harness.store.get("PodCliqueSet", "default", f"svc-{i:05d}")
                    for clique in pcs.spec.template.cliques:
                        for container in clique.spec.pod_spec.containers:
                            container.image = OPERATOR_IMAGE
                    harness.apply(pcs)
                walls["update_apply_s"] = time.perf_counter() - t0
            solve0 = pkg.METRICS.hist_sum.get("gang_solve_seconds", 0.0)
            recon0 = sum(v for k, v in pkg.METRICS.counters.items()
                         if k.startswith("reconcile_total/"))
            gc.collect()
            gc.freeze()
            gc.disable()
            t0 = time.perf_counter()
            try:
                out = _converge_recorded(pkg, harness, 60 + 8 * n, step, after_tick)
            finally:
                wall = time.perf_counter() - t0
                gc.enable()
                gc.unfreeze()
                gc.collect()
            out["summary"] = operator_summary(pkg, harness)
            converges.append(out)
            reconciles = sum(v for k, v in pkg.METRICS.counters.items()
                             if k.startswith("reconcile_total/")) - recon0
            walls[step] = {
                "wall_s": wall,
                "ticks": len(out["ticks"]),
                "solver_s": pkg.METRICS.hist_sum.get("gang_solve_seconds", 0.0) - solve0,
                "reconciles": reconciles,
            }
        record["converges"] = converges
        if then is not None:
            record["then"] = then(harness)
    finally:
        _reset_singletons(pkg)
    record["walls"] = walls
    return record


def operator_missing(record: dict) -> List[str]:
    """What (iota) must show and did not: every pod Ready after each
    converge, and at least one rolling-update step."""
    missing = []
    for i, c in enumerate(record["converges"]):
        if not c["summary"]["all_ready"]:
            missing.append(f"converge {i}: not all pods Ready")
    if not any(k.startswith("RollingUpdateReplicaStarted/")
               for k in record["converges"][1]["events"]):
        missing.append("no rolling-update step")
    return missing


def run_samples_world(pkg, device=None) -> dict:
    """Each of the ten sample files in a fresh harness of the default size:
    the ClusterTopology sample as the harness's topology with
    ``cluster_topology.enabled``, the Queue sample's Queues through
    ``apply_queue`` (``SimHarness.apply``), every PodCliqueSet through
    ``apply``; then a converge. Per file: ticks, ``tree()``'s sha256, the
    store census, digest and placement-score sum. ``pkg`` as for ``run_operator_world`` plus
    ``load_manifest_objects`` and ``OperatorConfiguration``."""
    kwargs = {} if device is None else {"device": device}
    out = {}
    try:
        for name in SAMPLE_FILES:
            pkg.reset_uid_namespace()
            pkg.METRICS.reset()
            pkg.EVENTS.reset()
            objs = pkg.load_manifest_objects((SAMPLES_DIR / name).read_text())
            topo = [o for o in objs if o.kind == "ClusterTopology"]
            if topo:
                config = pkg.OperatorConfiguration()
                config.cluster_topology.enabled = True
                config.cluster_topology.name = topo[0].metadata.name
                harness = pkg.SimHarness(topology=topo[0], config=config, **kwargs)
            else:
                harness = pkg.SimHarness(**kwargs)
            for obj in objs:
                if obj.kind != "ClusterTopology":
                    harness.apply(obj)
            ticks = harness.converge()
            tree = harness.tree()
            summary = operator_summary(pkg, harness)
            out[name] = {
                "ticks": ticks,
                "tree_sha256": hashlib.sha256(tree.encode()).hexdigest(),
                "tree_lines": len(tree.splitlines()),
                **{k: summary[k] for k in ("resource_version", "census", "digest",
                                           "scored_gangs", "score_sum", "bindings_sha256")},
            }
    finally:
        _reset_singletons(pkg)
    return out


# ---------------------------------------------------------------------------
# The real-cluster world (tau): (iota)'s population applied over HTTP to the
# operator that start_operator boots (apiserver, TLS webhooks, HttpStore,
# controllers, scheduler)
# ---------------------------------------------------------------------------

# K, the first K sets of (iota)'s population: halved from 1,024 until the
# smoke's [cluster] process fits the card smoke's time limit (PERF.md
# section 4)
CLUSTER_SETS = 32
CLUSTER_NODES = OPERATOR_NODES
# deploy/operator.yaml's operator configuration (the ConfigMap's config.yaml)
CLUSTER_CONFIG_YAML = """
logLevel: info
controllers:
  podCliqueSet: { concurrentSyncs: 2 }
  podClique: { concurrentSyncs: 2 }
  podCliqueScalingGroup: { concurrentSyncs: 2 }
solver:
  chunkSize: 64
  maxWaves: 16
"""
CLUSTER_MAX_ROUNDS = 400
CLUSTER_SETTLE_S = 0.2  # a quiet round is read again after this long
_PCS_PATH = "/apis/grove.io/v1alpha1/namespaces/default/podcliquesets"


def cluster_world(n_sets: Optional[int] = None, n_nodes: Optional[int] = None) -> dict:
    """(tau) as wire documents: the first ``n_sets`` sets of (iota)'s
    population (``operator_template(i)``, named ``svc-%05d``) as the JSON a
    client POSTs, on ``n_nodes`` nodes of the harness's ``make_nodes``."""
    import yaml

    n_sets = CLUSTER_SETS if n_sets is None else n_sets
    world = operator_world(n_sets, CLUSTER_NODES if n_nodes is None else n_nodes)
    bases = {name: yaml.safe_load(text) for name, text in world["texts"].items()}
    docs = []
    for i in range(n_sets):
        doc = json.loads(json.dumps(bases[operator_template(i)]))
        doc["metadata"]["name"] = f"svc-{i:05d}"
        docs.append(doc)
    return {"n_sets": n_sets, "n_nodes": world["n_nodes"], "docs": docs}


def _http_json(method: str, url: str, doc=None, timeout: float = 60.0):
    import urllib.request

    data = json.dumps(doc).encode() if doc is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def cluster_converged(pkg, store, n_sets: int) -> bool:
    """Every set stored, at least one PodGang a set, every PodGang Running
    and every pod Ready (``store``: the apiserver's own store)."""
    if sum(1 for _ in store.scan("PodCliqueSet")) != n_sets:
        return False
    gangs = list(store.scan("PodGang"))
    if len(gangs) < n_sets or any(g.status.phase != "Running" for g in gangs):
        return False
    pods = list(store.scan("Pod"))
    return bool(pods) and all(pkg.is_ready(p) for p in pods)


def cluster_summary(pkg, rt) -> dict:
    """The converged world, read the same way from either package: the
    apiserver store's census by kind (counts), gangs by phase, pods (bound,
    Ready), the ``GET /events`` records by ``kind/reason`` and the sha256
    of the operator's bindings."""
    store = rt.apiserver.store
    with rt.apiserver.lock:
        census = {kind: sum(1 for _ in store.scan(kind)) for kind in sorted(store.kinds())}
        gangs = Counter(g.status.phase for g in store.scan("PodGang"))
        pods = list(store.scan("Pod"))
    events = _http_json("GET", rt.apiserver.address + "/events")["items"]
    by_reason = Counter(f"{e['involvedObject']['kind']}/{e['reason']}" for e in events)
    return {
        "census": census,
        "gangs": dict(sorted(gangs.items())),
        "pods": {"total": len(pods), "bound": sum(1 for p in pods if p.status.node_name),
                 "ready": sum(1 for p in pods if pkg.is_ready(p))},
        "events": dict(sorted(by_reason.items())),
        "bindings_sha256": _bindings_sha256(rt.cluster),
    }


def run_cluster_world(pkg, n_sets: Optional[int] = None, n_nodes: Optional[int] = None,
                      device=None, with_tls: bool = True, after_round=None,
                      inspect=None) -> dict:
    """Run (tau) through ``pkg``'s real-cluster tier (either package;
    ``pkg`` as for ``run_operator_world`` plus ``start_operator``,
    ``make_nodes`` and ``load_operator_configuration``): boot
    ``start_operator`` with the TLS webhooks (unless ``with_tls`` is False)
    and the authorizer on ``n_nodes`` nodes under ``CLUSTER_CONFIG_YAML``
    (the serial drain: the order of commits is the serial one), POST every
    set as JSON to the apiserver, then call ``converge_once``
    until ``cluster_converged`` holds after a quiet round (none of work,
    then again after ``CLUSTER_SETTLE_S``). ``after_round(index, wall_s,
    work)`` sees every round; ``inspect(rt)`` runs on the converged
    operator before it shuts down (its value lands under ``"inspect"``).
    ``device`` goes to the port's ``start_operator`` (None for the JAX
    one). Returns ``cluster_summary`` and, under ``"walls"``, the host
    times (apply, converge, the schedule passes' share, µs a reconcile),
    left out of any comparison."""
    world = cluster_world(n_sets, n_nodes)
    pkg.reset_uid_namespace()
    pkg.METRICS.reset()
    pkg.EVENTS.reset()
    kwargs = {} if device is None else {"device": device}
    rt = pkg.start_operator(
        nodes=pkg.make_nodes(world["n_nodes"]),
        config=pkg.load_operator_configuration(CLUSTER_CONFIG_YAML),
        with_tls=with_tls, with_authorizer=True, threaded=False, **kwargs)
    record: Dict[str, object] = {"world": {k: world[k] for k in ("n_sets", "n_nodes")}}
    walls: Dict[str, object] = {}
    try:
        t0 = time.perf_counter()
        for doc in world["docs"]:
            _http_json("POST", rt.apiserver.address + _PCS_PATH, doc)
        walls["apply_s"] = time.perf_counter() - t0
        schedule_s = [0.0]
        schedule = rt.scheduler.schedule_pending

        def timed_schedule():
            t = time.perf_counter()
            try:
                return schedule()
            finally:
                schedule_s[0] += time.perf_counter() - t

        rt.scheduler.schedule_pending = timed_schedule
        solve0 = pkg.METRICS.hist_sum.get("gang_solve_seconds", 0.0)
        rounds, quiet = 0, False
        t0 = time.perf_counter()
        while True:
            if rounds >= CLUSTER_MAX_ROUNDS:
                raise RuntimeError(f"(tau) did not converge within {CLUSTER_MAX_ROUNDS} rounds")
            t = time.perf_counter()
            work = rt.converge_once()
            rounds += 1
            if after_round is not None:
                after_round(rounds, time.perf_counter() - t, work)
            if work:
                quiet = False
                continue
            with rt.apiserver.lock:
                done = cluster_converged(pkg, rt.apiserver.store, world["n_sets"])
            if done and quiet:
                break
            quiet = done
            time.sleep(CLUSTER_SETTLE_S)
        wall = time.perf_counter() - t0
        reconciles = sum(v for k, v in pkg.METRICS.counters.items()
                         if k.startswith("reconcile_total/"))
        walls.update({
            "converge_s": wall, "rounds": rounds, "reconciles": reconciles,
            "us_per_reconcile": 1e6 * wall / max(reconciles, 1),
            "schedule_s": schedule_s[0], "schedule_share": schedule_s[0] / wall,
            "solver_s": pkg.METRICS.hist_sum.get("gang_solve_seconds", 0.0) - solve0,
        })
        record.update(cluster_summary(pkg, rt))
        if inspect is not None:
            record["inspect"] = inspect(rt)
    finally:
        rt.shutdown()
        _reset_singletons(pkg)
    record["walls"] = walls
    return record


# ---------------------------------------------------------------------------
# The sim scenarios' worlds: (kappa) the churn on (iota), (lambda) the sharded
# A/Bs, (nu) the small scenarios (bench.py's delta, scale, quota, explain
# and drain blocks)
# ---------------------------------------------------------------------------

CHURN_TICKS = 96  # delta_artifact's churn ticks (bench.py)
CHURN_FULLPATH_TICKS = 32  # and its from-scratch comparison segment
CHURN_SEED = 8
# report fields of delta_artifact that time nothing
CHURN_REPORT_FIELDS = (
    "ticks", "seed", "ops", "spec_encodes", "reencode_fraction", "warm_start_hit_rate",
    "warm_start_hits", "solve_reuses", "full_fallbacks", "drift_detected", "ab_ticks", "ab_ok",
)


def _reconcile_total(metrics) -> int:
    return int(sum(v for k, v in metrics.counters.items() if k.startswith("reconcile_total")))


def run_churn_world(pkg, harness, ticks: int = CHURN_TICKS,
                    fullpath_ticks: int = CHURN_FULLPATH_TICKS, seed: int = CHURN_SEED,
                    after_tick=None) -> dict:
    """(kappa): ``pkg.deltachurn.delta_artifact`` (either package's) on a
    converged harness, its comparison segment cut to ``fullpath_ticks``
    (the module's ``fullpath_comparison`` is wrapped), every schedule call
    recorded: ``round_summary`` of its events, the delta counters (None
    while the comparison segment detaches the delta state) and whether the
    round ran the A/B self-check. ``after_tick(index, wall_s, tick)`` sees
    each. Returns ``{"ticks": [...], "report": ..., "times": ...}``, the
    report less its times, which land under ``"times"``."""
    sched = harness.scheduler
    schedule = harness.schedule
    ticks_out: List[dict] = []
    with EventCapture(pkg.EVENTS) as cap:

        def scheduled():
            start = len(cap.events)
            selfcheck = bool(sched.delta is not None and sched.delta_selfcheck)
            t0 = time.perf_counter()
            bound = schedule()
            wall = time.perf_counter() - t0
            tick = {
                "bound": bound,
                "selfcheck": selfcheck,
                "round": round_summary(harness.store, harness.cluster, cap.events[start:]),
                "delta": delta_counters(sched.delta) if sched.delta is not None else None,
            }
            ticks_out.append(tick)
            if after_tick is not None:
                after_tick(len(ticks_out), wall, tick)
            return bound

        harness.schedule = scheduled
        dc = pkg.deltachurn
        fullpath = dc.fullpath_comparison
        # delta_artifact runs 32 comparison ticks: a cut goes through the
        # module's fullpath_comparison, the same way in either package
        dc.fullpath_comparison = lambda h, ticks, seed: fullpath(
            h, ticks=fullpath_ticks, seed=seed)
        try:
            report = dc.delta_artifact(harness, ticks=ticks, seed=seed)
        finally:
            dc.fullpath_comparison = fullpath
            del harness.schedule
    return {
        "ticks": ticks_out,
        "report": {k: report[k] for k in CHURN_REPORT_FIELDS},
        "times": {k: v for k, v in report.items() if k not in CHURN_REPORT_FIELDS},
    }


SCALE_FRONTIER_SHAPE = (4096, 6400)  # scale_artifact's full-size frontier_ab
SCALE_INERT_SHAPE = (192, 64)  # and inert_ab
SCALE_SHARDS = 8


def dump_digest(dump: dict) -> dict:
    """A canonical store dump (``store_dump``, either package's) as the
    sha256 of its documents in key order, each as sorted JSON with its
    placement scores replaced by ``<score>``, and the sum of those scores
    apart (the card and the CPU agree on them to rtol 1e-6)."""
    lines, scores = [], 0.0
    for key in sorted(dump):
        line = json.dumps(dump[key], sort_keys=True)
        for m in _SCORE_RE.finditer(line):
            scores += float(m.group(2))
        lines.append(key + " " + _SCORE_RE.sub(lambda m: f"{m.group(1)}<score>", line))
    return {"objects": len(lines), "sha256": _digest(lines), "score_sum": scores}


class RetiredHarnesses:
    """While active, every harness ``pkg.scale._close_harness`` (either
    package's ``sim/scale``; ``pkg`` also names ``store_dump``, ``METRICS``
    and ``is_ready``) releases is read first: the canonical dump's
    digest (rv-normalised, Events left out), every pod Ready, the scalar
    resourceVersion, the shard census, the frontier's deterministic
    counters, and the reconciles since the previous release (or since
    entry)."""

    def __init__(self, pkg) -> None:
        self.scale, self.store_dump, self.metrics = pkg.scale, pkg.store_dump, pkg.METRICS
        self.is_ready = pkg.is_ready
        self.records: List[dict] = []

    def _read(self, h) -> None:
        from_ = self._reconciles
        self._reconciles = _reconcile_total(self.metrics)
        dump = self.scale._rv_normalized(
            self.store_dump(h.store, canonical_uids=True, include_events=False))
        pods = list(h.store.scan("Pod"))
        frontier = h.scheduler.frontier if h.scheduler is not None else None
        self.records.append({
            "shards": h.store.num_shards,
            "pods": len(pods),
            "all_ready": bool(pods) and all(self.is_ready(p) for p in pods),
            "resource_version": h.store.resource_version,
            "shard_census": h.store.shard_census(),
            "reconciles": self._reconciles - from_,
            "dump": dump_digest(dump),
            "frontier": frontier_counters(frontier) if frontier is not None else None,
        })
        self._close(h)

    def __enter__(self) -> "RetiredHarnesses":
        self._reconciles = _reconcile_total(self.metrics)
        self._close = self.scale._close_harness
        self.scale._close_harness = self._read
        return self

    def __exit__(self, *exc) -> None:
        self.scale._close_harness = self._close


def run_scale_world(pkg, frontier_shape=SCALE_FRONTIER_SHAPE, inert_shape=SCALE_INERT_SHAPE,
                    num_shards: int = SCALE_SHARDS, device=None) -> dict:
    """(lambda): ``pkg.scale.frontier_ab(*frontier_shape, num_shards)`` and
    ``pkg.scale.inert_ab(*inert_shape, num_shards)`` (either package's
    ``sim/scale``), each retired harness read (``RetiredHarnesses``: the
    two warm-ups and the global and frontier arms; the warm-up, S=1 and
    S=``num_shards`` arms). Returns the records, each A/B's result less its
    times (under ``"times"``), and ``census_spread_problems`` of the
    frontier arms."""
    kwargs = {} if device is None else {"device": device}
    out: Dict[str, object] = {"world": {"frontier_shape": list(frontier_shape),
                                        "inert_shape": list(inert_shape),
                                        "shards": num_shards}}
    times: Dict[str, object] = {}
    pkg.METRICS.reset()
    with RetiredHarnesses(pkg) as retired:
        t0 = time.perf_counter()
        ab = pkg.scale.frontier_ab(*frontier_shape, num_shards=num_shards, **kwargs)
        times["frontier_ab_s"] = time.perf_counter() - t0
    out["frontier_arms"] = retired.records
    times["frontier_ab"] = {k: ab[k] for k in ("wall_off", "wall_on", "solver_off", "solver_on",
                                              "speedup_wall", "speedup_solver")}
    out["frontier_ab"] = {"sets": ab["sets"], "nodes": ab["nodes"],
                          "all_ready_both": ab["all_ready_both"]}
    out["spread_problems"] = sorted(
        {p for r in retired.records[2:] for p in pkg.scale.census_spread_problems(
            r["shard_census"], num_shards)})
    with RetiredHarnesses(pkg) as retired:
        t0 = time.perf_counter()
        inert = pkg.scale.inert_ab(*inert_shape, num_shards=num_shards, **kwargs)
        times["inert_ab_s"] = time.perf_counter() - t0
    out["inert_arms"] = retired.records
    times["inert_ab"] = {k: inert[k] for k in ("wall_s1", "wall_sharded")}
    out["inert_ab"] = {k: v for k, v in inert.items() if k not in times["inert_ab"]}
    out["times"] = times
    return out


SIMS_SMOKE_SEED = 0  # smoke_ab_run's storm (scripts/delta_smoke.py's legs)
SIMS_SMOKE_TICKS = 36
# contended_report fields that time the ordering pass and the solver
_CONTENDED_TIMES = ("order_seconds", "solver_seconds", "order_overhead_ratio")


def _sha(obj) -> str:
    return _digest([json.dumps(obj, sort_keys=True, default=str)])


def explain_scenario_docs(engine, refs: dict) -> dict:
    """The explain scenario's documents (less timing): ``explain`` of each
    actor, ``capacity()``, and the what-if draining the bridge gang's
    block-0 node for ``frag``."""
    out = {}
    for actor in ("frag", "fits", "capped", "bridge"):
        out[f"explain {actor}"] = strip_timing(engine.explain("default", refs[actor]))
    out["capacity"] = strip_timing(engine.capacity())
    out["whatif drain-node"] = strip_timing(engine.whatif({
        "gang": {"namespace": "default", "name": refs["frag"]},
        "actions": [{"action": "drain-node", "node": refs["bridge_node"]}],
    }))
    return out


def run_sims_world(pkg, device=None, after=None) -> dict:
    """(nu): either package's small scenarios at its own shapes, each in a
    fresh harness with the metrics and events reset and the uid counter
    rewound: ``multitenant.run_contended`` (its report less times),
    ``single_queue_ab(24, 16)``, ``build_explain_scenario`` (the actors'
    documents as ``doc_digests``), ``voluntary.drain_artifact``,
    ``deltachurn.smoke_ab_run`` with and without the delta state (the sha256
    of each leg's bindings and phases), and ``pkg.demo_text`` of
    simple1.yaml (what the demo prints). ``after(name, wall_s, result)``
    sees each. Times land under ``"times"``."""
    kwargs = {} if device is None else {"device": device}
    out: Dict[str, object] = {}
    times: Dict[str, float] = {}

    def step(name, fn):
        pkg.reset_uid_namespace()
        pkg.METRICS.reset()
        pkg.EVENTS.reset()
        t0 = time.perf_counter()
        result = fn()
        times[name] = time.perf_counter() - t0
        out[name] = result
        if after is not None:
            after(name, times[name], result)

    def contended():
        harness, report = pkg.multitenant.run_contended(**kwargs)
        return {k: v for k, v in report.items() if k not in _CONTENDED_TIMES}

    def single_queue():
        ab = pkg.multitenant.single_queue_ab(24, 16, **kwargs)
        return {k: ab[k] for k in ("identical_admissions", "admitted_pods")}

    def explain():
        harness, refs = pkg.multitenant.build_explain_scenario(**kwargs)
        docs = explain_scenario_docs(harness.explain, refs)
        return {"refs": refs, "docs": doc_digests(docs)}

    def smoke_ab():
        legs = {}
        for delta in (True, False):
            bindings, phases = pkg.deltachurn.smoke_ab_run(SIMS_SMOKE_SEED, delta,
                                                           SIMS_SMOKE_TICKS, **kwargs)
            legs["delta" if delta else "full"] = {
                "bindings": len(bindings),
                "bindings_sha256": _sha(sorted(f"{ns}/{p}={n}" for (ns, p), n in bindings.items())),
                "phases_sha256": _sha(sorted(phases.items())),
            }
        return legs

    def demo():
        text = pkg.demo_text((SAMPLES_DIR / "simple1.yaml").read_text())
        return {"sha256": _digest([text]), "lines": len(text.splitlines())}

    try:
        step("contended", contended)
        step("single_queue_ab", single_queue)
        step("explain", explain)
        step("drain", lambda: pkg.voluntary.drain_artifact(**kwargs))
        step("smoke_ab", smoke_ab)
        step("demo", demo)
    finally:
        _reset_singletons(pkg)
    out["times"] = times
    return out


def sims_missing(result: dict) -> List[str]:
    """What (nu) must show and did not."""
    missing = []
    if not result["contended"]["within_one_gang"]:
        missing.append("contended: a queue ended more than one gang from its share")
    if not result["contended"]["reclaims"]:
        missing.append("contended: no reclaim")
    if not result["single_queue_ab"]["identical_admissions"]:
        missing.append("single_queue_ab: admissions differ")
    if not result["drain"]["ok"]:
        missing.append("drain: the voluntary-disruption contract failed")
    legs = result["smoke_ab"]
    if legs["delta"] != legs["full"]:
        missing.append("smoke_ab: the delta and full legs differ")
    return missing


# ---------------------------------------------------------------------------
# The parallel drain and durability: (pi), the headline converge at
# (lambda)'s frontier shape through the process drain with a per-shard WAL,
# then its crash, recovery and cold restart; and the parallel-drain
# scenarios at the JAX package's own shapes
# ---------------------------------------------------------------------------

PARALLEL_WORKERS = 4  # the JAX bench's full-size configuration: 8 shards, 4 workers
PARALLEL_BACKEND = "process"
PARALLEL_TORN_TAIL = 53  # bytes of the torn frame the crash leaves on shard 0's stream
# parallel_ab runs of the [parallel] phase: (backend, workers, seed), each
# with per-shard WALs on both twins, at parallel_ab's own shape
PARALLEL_AB_RUNS = tuple((b, w, s) for b in ("thread", "process") for w in (2, 4)
                         for s in (1234, 7))
PARALLEL_SWEEP = (192, 64, 8)  # worker_sweep's sets, nodes, shards
PARALLEL_SWEEP_COUNTS = (1, 2, 4, 8)
DURABILITY_SHAPE = (192, 192)  # durability_artifact's sets and nodes
# converge_population's report fields that time nothing
CONVERGE_FIELDS = ("sets", "nodes", "shards", "tenants", "pods", "all_ready", "reconciles",
                   "pod_summary", "fold_depth_histogram", "shard_census", "workers")
_PARALLEL_STATS = ("backend", "workers", "reconciles_by_worker", "worker_crashes",
                   "boundary_faults")


def wal_summary(pkg, durability, wal_dir: str) -> dict:
    """Per shard stream: records flushed, and the durable state
    (``durable_state_normalized``: the acked prefix, rv-stripped, uids
    canonical) as ``dump_digest`` reads a dump (placement scores summed
    apart: the card and the CPU agree on them to rtol 1e-6)."""
    states = pkg.parallel.durable_state_normalized(wal_dir)
    out = {}
    for i, wal in enumerate(durability.wals):
        state = states.get(i, {})
        out[str(i)] = {"records": wal.flushed_records,
                       "durable": dump_digest({k: v for k, v in state.items() if v is not None}),
                       "tombstones": sum(1 for v in state.values() if v is None)}
    return out


def _parallel_stats(stats: dict) -> dict:
    return {k: stats[k] for k in _PARALLEL_STATS if k in stats}


def _scheduled_gangs(store) -> int:
    return sum(1 for g in store.scan("PodGang") if _scheduled(g))


def run_parallel_world(pkg, wal_dir: str, n_sets: int = SCALE_FRONTIER_SHAPE[0],
                       n_nodes: int = SCALE_FRONTIER_SHAPE[1], num_shards: int = SCALE_SHARDS,
                       workers: int = PARALLEL_WORKERS, backend: str = PARALLEL_BACKEND,
                       torn_tail: int = PARALLEL_TORN_TAIL, device=None) -> dict:
    """(pi) through either package (``pkg`` as for ``run_scale_world``,
    plus ``parallel``, ``recover_store``, ``verify_acked_prefix`` and
    ``resource_signature``): ``scale.converge_population(n_sets, n_nodes,
    num_shards, frontier=True, glassbox=True, workers=workers)`` with
    ``GROVE_TPU_CP_BACKEND=backend`` and a per-shard WAL in ``wal_dir``
    attached before the first commit (the module's ``SimHarness`` is
    wrapped for the call; the harness arms the overlap pump). Recorded: the
    report less its times, the scalar resourceVersion, the canonical dump's
    digest (rv-normalised, Events left out), the scheduled gangs, the
    frontier counters, the overlap hits and stale specs, each shard
    stream's ``wal_summary``. Then the crash (``simulate_crash`` with a
    ``torn_tail``-byte torn frame), ``recover_store``,
    ``verify_acked_prefix``, the recovered dump against the pre-crash one,
    and ``cold_restart`` with the same drain and the frontier, converged
    to the pre-crash ``resource_signature``. Times land under
    ``"times"``."""
    kwargs = {} if device is None else {"device": device}
    pkg.reset_uid_namespace()
    pkg.METRICS.reset()
    pkg.EVENTS.reset()
    scale = pkg.scale
    harness_cls = scale.SimHarness

    class DurableHarness(harness_cls):
        def __init__(self, *args, **kw):
            kw.setdefault("durability_dir", wal_dir)
            super().__init__(*args, **kw)

    times: Dict[str, object] = {}
    out: Dict[str, object] = {"world": {"sets": n_sets, "nodes": n_nodes, "shards": num_shards,
                                       "workers": workers, "backend": backend,
                                       "torn_tail": torn_tail}}
    env_backend = os.environ.get("GROVE_TPU_CP_BACKEND")
    os.environ["GROVE_TPU_CP_BACKEND"] = backend
    scale.SimHarness = DurableHarness
    try:
        t0 = time.perf_counter()
        h, report = scale.converge_population(n_sets, n_nodes, num_shards, frontier=True,
                                              glassbox=True, workers=workers, **kwargs)
        times["converge_s"] = time.perf_counter() - t0
    finally:
        scale.SimHarness = harness_cls
        if env_backend is None:
            os.environ.pop("GROVE_TPU_CP_BACKEND", None)
        else:
            os.environ["GROVE_TPU_CP_BACKEND"] = env_backend
    try:
        times["report"] = {k: report[k] for k in (
            "wall_seconds", "apply_seconds", "solver_seconds", "control_plane_seconds",
            "us_per_reconcile")}
        times["parallel"] = {k: report["parallel"][k] for k in (
            "busy_seconds_by_worker", "utilization", "boundary_bytes") if k in report["parallel"]}
        times["attribution"] = {k: report["attribution"].get(k) for k in (
            "coverage", "cp_coverage", "by_worker")}
        dump = scale._rv_normalized(
            pkg.store_dump(h.store, canonical_uids=True, include_events=False))
        counters = pkg.METRICS.counters
        out["converge"] = {
            **{k: report[k] for k in CONVERGE_FIELDS},
            "parallel": _parallel_stats(report["parallel"]),
            "resource_version": h.store.resource_version,
            "dump": dump_digest(dump),
            "scheduled_gangs": _scheduled_gangs(h.store),
            "frontier": frontier_counters(h.scheduler.frontier),
            "overlap": {"hits": int(counters.get("cp_overlap_hits_total", 0)),
                        "stale": int(counters.get("cp_overlap_stale_total", 0))},
            "wal": wal_summary(pkg, h.durability, wal_dir),
        }
        signature = pkg.resource_signature(h.store)
        lost = h.durability.simulate_crash(torn_tail_bytes=torn_tail)
        t0 = time.perf_counter()
        store, recovery = pkg.recover_store(wal_dir, clock=h.clock, cache_lag=True)
        times["recover_s"] = time.perf_counter() - t0
        problems = list(pkg.verify_acked_prefix(wal_dir, store))
        recovered = scale._rv_normalized(
            pkg.store_dump(store, canonical_uids=True, include_events=False))
        if recovered != dump:
            problems.append("the recovered store differs from the pre-crash committed state")
        nodes, config = h.cluster.nodes, h.config
    finally:
        scale._close_harness(h)
    rec = recovery.as_dict()
    times["recovery"] = {k: rec.pop(k) for k in ("wall_seconds", "replay_records_per_sec")}
    restarted = pkg.SimHarness.cold_restart(store, nodes, config=config, durability_dir=wal_dir,
                                            **kwargs)
    try:
        restarted.engine.enable_workers(workers, backend=backend)
        restarted.scheduler.enable_frontier()
        r0 = _reconcile_total(pkg.METRICS)
        t0 = time.perf_counter()
        ticks = restarted.converge(max_ticks=60 + 8 * n_sets)
        times["reconverge_s"] = time.perf_counter() - t0
        pods = list(restarted.store.scan("Pod"))
        if not pods or not all(pkg.is_ready(p) for p in pods):
            problems.append("the cold restart did not converge to all-Ready")
        if pkg.resource_signature(restarted.store) != signature:
            problems.append("the cold restart's resource tree differs from the pre-crash one")
        stats = restarted.engine.workers.stats()
        out["crash"] = {
            "lost_unacked_records": lost,
            "recovery": rec,
            "reconverge_ticks": ticks,
            "reconverge_reconciles": _reconcile_total(pkg.METRICS) - r0,
            "reconverge_parallel": _parallel_stats(stats),
            "problems": problems,
        }
    finally:
        restarted.durability.close()
        scale._close_harness(restarted)
        _reset_singletons(pkg)
    out["times"] = times
    return out


def run_parallel_suite(pkg, tmp_root: str, device=None, sweep_counts=PARALLEL_SWEEP_COUNTS,
                       after=None) -> dict:
    """The parallel-drain scenarios at the JAX package's own shapes through
    either package (``pkg`` as for ``run_parallel_world``), each from a
    fresh uid namespace, metrics and events: ``parallel.parallel_ab`` at its
    own shape for every ``PARALLEL_AB_RUNS`` entry, with per-shard WALs
    under ``tmp_root``; the worker crash (a process drain whose worker 1 is
    killed right after its first batch, against a serial twin); a run with
    seeded boundary faults on the process drain's wire against a serial
    twin; ``worker_sweep(*PARALLEL_SWEEP, sweep_counts)`` for both
    backends; ``recovery.durability_artifact(*DURABILITY_SHAPE)``. Each
    report less its times; ``after(name, wall_s, result)`` sees each.
    Times land under ``"times"``."""
    kwargs = {} if device is None else {"device": device}
    par = pkg.parallel
    out: Dict[str, object] = {}
    times: Dict[str, object] = {}

    def step(name, fn):
        pkg.reset_uid_namespace()
        pkg.METRICS.reset()
        pkg.EVENTS.reset()
        t0 = time.perf_counter()
        result, timed = fn()
        times[name] = {"wall_s": time.perf_counter() - t0, **timed}
        out[name] = result
        if after is not None:
            after(name, times[name]["wall_s"], result)

    def ab(backend, workers, seed):
        dirs = tuple(os.path.join(tmp_root, f"ab-{backend}-{workers}-{seed}-{arm}")
                     for arm in ("serial", "workers"))
        rep = par.parallel_ab(workers=workers, seed=seed, wal_dirs=dirs, backend=backend,
                              **kwargs)
        stats = rep["worker_stats"]
        timed = {k: stats[k] for k in ("busy_seconds_by_worker", "boundary_bytes") if k in stats}
        rep["worker_stats"] = _parallel_stats(stats)
        return rep, timed

    def twin(n_sets, n_nodes, num_shards, workers, n_tenants, arm):
        """A serial harness and a process-drain one over one population;
        ``arm(drain)`` arms the drain's fault before the converge."""
        tenants = pkg.scale.tenant_namespaces(n_tenants)
        dumps, stats, reconciles = [], {}, []
        for w in (1, workers):
            h = par._make_harness(n_nodes, num_shards, w, backend="process", **kwargs)
            if w > 1:
                arm(h.engine.workers)
            r0 = _reconcile_total(pkg.METRICS)
            par._populate(h, n_sets, tenants)
            h.converge(max_ticks=60 + 8 * n_sets)
            reconciles.append(_reconcile_total(pkg.METRICS) - r0)
            dumps.append(par._dump(h))
            if w > 1:
                stats = h.engine.workers.stats()
            h.engine.close()
        return {"identical": dumps[0] == dumps[1], "reconciles": reconciles,
                "dump": dump_digest(dumps[1]), "worker_stats": _parallel_stats(stats),
                "crashes_total": int(pkg.METRICS.counters.get("cp_worker_crashes_total", 0))}, {}

    def kill(drain):
        drain.chaos_kill_worker = 1

    def faults(drain):
        drain.inject_boundary_faults(7, drop_rate=0.08, dup_rate=0.08, delay_rate=0.08)

    def sweep(backend):
        rep = par.worker_sweep(*PARALLEL_SWEEP, worker_counts=tuple(sweep_counts),
                               backend=backend, **kwargs)
        timed = [{k: row.get(k) for k in ("wall_seconds", "control_plane_seconds",
                                          "us_per_reconcile", "speedup", "utilization")}
                 for row in rep["sweep"]]
        rep["sweep"] = [{k: row[k] for k in ("workers", "effective_workers", "reconciles",
                                             "all_ready")} for row in rep["sweep"]]
        return rep, {"rows": timed}

    def durability():
        rep = pkg.recovery.durability_artifact(*DURABILITY_SHAPE, **kwargs)
        # the bytes carry the placement scores' text, so they are measured
        # and not compared
        timed_keys = ("overhead_pct", "overhead_ab_pct", "wal_cpu_seconds", "recovery_wall_s",
                      "replay_records_per_sec", "wal_bytes")
        return ({k: v for k, v in rep.items() if k not in timed_keys},
                {k: rep[k] for k in timed_keys})

    try:
        for backend, workers, seed in PARALLEL_AB_RUNS:
            step(f"ab {backend} w{workers} s{seed}", lambda: ab(backend, workers, seed))
        step("worker_crash", lambda: twin(8, 16, 3, 2, 4, kill))
        step("boundary_faults", lambda: twin(48, 32, 4, 2, 8, faults))
        for backend in ("thread", "process"):
            step(f"sweep {backend}", lambda: sweep(backend))
        step("durability", durability)
    finally:
        _reset_singletons(pkg)
    out["times"] = times
    return out


def parallel_missing(suite: dict) -> List[str]:
    """What the parallel-drain scenarios must show and did not."""
    missing = []
    for name, rep in suite.items():
        if name.startswith("ab "):
            if rep["problems"] or not rep["identical"] or rep["wal_acked_identical"] is not True:
                missing.append(f"{name}: the serial twin differs: {rep['problems'][:2]}")
            if rep["worker_stats"].get("worker_crashes"):
                missing.append(f"{name}: a worker was repatriated")
    crash = suite["worker_crash"]
    if not crash["identical"] or crash["worker_stats"].get("worker_crashes") != 1:
        missing.append(f"worker_crash: {crash}")
    fault = suite["boundary_faults"]
    counts = fault["worker_stats"].get("boundary_faults", {})
    if not fault["identical"] or not counts.get("retransmits") or fault["worker_stats"].get(
            "worker_crashes"):
        missing.append(f"boundary_faults: {fault}")
    for backend in ("thread", "process"):
        rows = suite[f"sweep {backend}"]["sweep"]
        if not all(r["all_ready"] for r in rows) or len({r["reconciles"] for r in rows}) != 1:
            missing.append(f"sweep {backend}: {rows}")
    dur = suite["durability"]
    if not (dur["recovery_ok"] and dur["inert_ab_identical"]):
        missing.append(f"durability: {dur}")
    return missing
