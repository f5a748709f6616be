"""The multi-tenant contended scenarios of the quota subsystem.

Counterpart of ``grove_tpu/sim/multitenant.py``:

- ``build_contended_harness`` / ``run_contended``: N tenant queues whose
  deserved shares sum to the cluster's capacity, each tenant submitting
  more gangs than its share covers. The first tenant converges alone and
  takes the whole cluster, so reaching every queue's share within one gang
  takes cross-queue reclaim, not only a fair admission order.
  ``contended_report`` reads the outcome (per queue achieved against
  deserved, reclaims, the ordering pass's share of solver time).
- ``single_queue_ab``: the same workload with no Queue CRs and with
  everything in one queue must give the same bindings.
- ``build_explain_scenario``: a fragmented two-block cluster where one gang
  is fragmentation-blocked, one fits now, one is held at its queue's
  ceiling, and draining one node flips the first to fits-now.

The harnesses run their solves and the DRF order on ``device`` (the card
unless the caller passes ``device="cpu"``); ``quota.warm`` runs the
ordering pass once at the workload's padded shape before the measured
rounds.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.load import load_podcliquesets
from grove_tpu_torch.api.meta import ObjectMeta
from grove_tpu_torch.api.types import PodCliqueSet, Queue, QueueSpec

_TENANT_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: placeholder
spec:
  replicas: 1
  template:
    cliques:
      - name: worker
        spec:
          roleName: role-worker
          replicas: 1
          podSpec:
            containers:
              - name: worker
                image: busybox:stable
                resources:
                  requests:
                    cpu: 1
"""


def tenant_queue(
    name: str,
    deserved_cpu: float,
    ceiling_cpu: Optional[float] = None,
) -> Queue:
    spec = QueueSpec(deserved={"cpu": float(deserved_cpu)})
    if ceiling_cpu is not None:
        spec.ceiling = {"cpu": float(ceiling_cpu)}
    return Queue(metadata=ObjectMeta(name=name), spec=spec)


def tenant_pcs(tenant: str, index: int, namespace: Optional[str] = None) -> PodCliqueSet:
    """One 1-pod / 1-cpu gang for `tenant`, queue-labeled, in the tenant's
    own namespace (exercises the cross-namespace event attribution the
    QuotaReclaim tests pin)."""
    from grove_tpu_torch.api.meta import deep_copy

    pcs = deep_copy(_TENANT_BASE)
    pcs.metadata.name = f"{tenant}-{index:03d}"
    pcs.metadata.namespace = namespace or tenant
    pcs.metadata.labels[namegen.LABEL_QUEUE] = tenant
    return pcs


_TENANT_BASE = load_podcliquesets(_TENANT_YAML)[0]


def build_contended_harness(
    tenants: Sequence[Tuple[str, float, int]] = (
        ("team-a", 6.0, 12),
        ("team-b", 4.0, 12),
        ("team-c", 2.0, 12),
    ),
    node_cpu: float = 2.0,
    stagger: bool = True,
    device=None,
):
    """(harness, tenants): cluster capacity == sum of deserved shares; each
    tenant submits `gangs` 1-cpu gangs. With ``stagger`` the first tenant
    converges alone first (and hogs the cluster), forcing reclaim."""
    from grove_tpu_torch.sim.cluster import Node
    from grove_tpu_torch.sim.harness import SimHarness

    total_cpu = sum(d for _, d, _ in tenants)
    n_nodes = max(1, int(round(total_cpu / node_cpu)))
    harness = SimHarness(num_nodes=1, device=device)
    harness.cluster.nodes = [
        Node(
            name=f"node-{i}",
            capacity={"cpu": node_cpu},
            labels={"kubernetes.io/hostname": f"node-{i}"},
        )
        for i in range(n_nodes)
    ]
    for name, deserved, _ in tenants:
        harness.apply_queue(tenant_queue(name, deserved))
    # one ordering pass at this workload's padded shape, so the measured
    # order_seconds are the steady state's, not the kernels' build and load
    harness.scheduler.quota.warm(
        len(tenants) + 1, max(g for _, _, g in tenants)
    )
    first, rest = tenants[0], tenants[1:]
    for i in range(first[2]):
        harness.apply(tenant_pcs(first[0], i))
    if stagger:
        harness.converge(max_ticks=120)
    for name, _, gangs in rest:
        for i in range(gangs):
            harness.apply(tenant_pcs(name, i))
    return harness, list(tenants)


_EXPLAIN_GANG_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: placeholder
spec:
  replicas: 1
  template:
    cliques:
      - name: w
        spec:
          roleName: role-w
          replicas: 1
          podSpec:
            containers:
              - name: w
                image: busybox:stable
                resources:
                  requests:
                    cpu: 1
"""


def _explain_pcs(
    name: str,
    queue: str,
    cpu: float,
    replicas: int = 1,
    pack_domain: Optional[str] = None,
    spread_domain: Optional[str] = None,
    spread_min: int = 2,
):
    """One parameterized gang for the explain scenario: `replicas` pods of
    `cpu` each, optional gang-level pack/spread constraint."""
    from grove_tpu_torch.api.types import (
        SPREAD_DO_NOT_SCHEDULE,
        TopologyConstraint,
    )

    pcs = load_podcliquesets(_EXPLAIN_GANG_YAML)[0]
    pcs.metadata.name = name
    pcs.metadata.labels[namegen.LABEL_QUEUE] = queue
    clique = pcs.spec.template.cliques[0]
    clique.spec.replicas = replicas
    for c in clique.spec.pod_spec.containers:
        c.requests = {"cpu": float(cpu)}
    if pack_domain or spread_domain:
        pcs.spec.template.topology_constraint = TopologyConstraint(
            pack_domain=pack_domain,
            spread_domain=spread_domain,
            spread_min_domains=spread_min if spread_domain else None,
            spread_when_unsatisfiable=(
                SPREAD_DO_NOT_SCHEDULE if spread_domain else None
            ),
        )
    return pcs


def build_explain_scenario(device=None):
    """The explain scenario (the JAX bench's "explain" block): a fragmented
    2-block cluster where, simultaneously,

    - ``frag``   (queue team-a) is FRAGMENTATION-blocked: 4x1 cpu packed
      inside one ici-block, while each block holds only 3 free cpu
      (aggregate free 6 covers the floor - no contiguous domain does);
    - ``capped-1`` (queue team-b) FITS NOW (2x1 cpu, unconstrained);
    - ``capped-2`` (queue team-b) is QUOTA-blocked at team-b's ceiling;
    - draining the ``bridge`` gang's block-0 node (gang-whole eviction
      frees its block-1 pod too) flips ``frag`` to fits-now - the what-if
      a real drain then confirms.

    Returns (harness, refs) with refs naming every actor:
    {frag, fits, capped, bridge, bridge_node, filler_queue}.
    """
    from grove_tpu_torch.sim.cluster import make_nodes
    from grove_tpu_torch.sim.harness import SimHarness

    harness = SimHarness(num_nodes=1, device=device)
    # 8 nodes x 4 cpu: block-0 = node-0..3 (slice-0), block-1 = node-4..7
    # (slice-1) - cpu-only capacity keeps every number legible
    harness.cluster.nodes = make_nodes(
        8,
        capacity={"cpu": 4.0},
        hosts_per_ici_block=4,
        blocks_per_slice=1,
    )
    # tenant-z: infrastructure filler queue, deserved far below its usage
    # so its re-pended gangs always order LAST (never steal the capacity
    # a what-if frees for team-a/team-b)
    harness.apply_queue(tenant_queue("tenant-z", 10.0))
    harness.apply_queue(tenant_queue("team-a", 4.0))
    harness.apply_queue(tenant_queue("team-b", 2.0, ceiling_cpu=2.0))
    harness.scheduler.quota.warm(4, 8)
    # fill: one 3-cpu pod per node (exactly one fits a 4-cpu node) - every
    # node keeps 1 cpu free
    for i in range(8):
        harness.apply(_explain_pcs(f"fill-{i}", "tenant-z", 3.0))
    # bridge: 2x1 cpu spread HARD across slices - one pod lands in each
    # block, so a gang-whole drain of its block-0 node frees block-1 too
    harness.apply(
        _explain_pcs(
            "bridge", "tenant-z", 1.0, replicas=2,
            spread_domain="slice", spread_min=2,
        )
    )
    harness.converge(max_ticks=120)
    # the three explain subjects arrive AFTER the fillers converged; the
    # caller materializes their pods without solving (engine drains) so
    # all three verdicts are observable at once
    harness.apply(
        _explain_pcs("frag", "team-a", 1.0, replicas=4,
                     pack_domain="ici-block")
    )
    harness.apply(_explain_pcs("capped-1", "team-b", 1.0, replicas=2))
    harness.apply(_explain_pcs("capped-2", "team-b", 2.0))
    for _ in range(6):
        harness.engine.drain()
        harness.clock.advance(1.0)
    # the bridge gang's block-0 node (drain target for the flip)
    bridge_node = None
    for (ns, pod_name), node_name in harness.cluster.bindings.items():
        pod = harness.store.get("Pod", ns, pod_name, readonly=True)
        if pod is None:
            continue
        if (pod.metadata.labels.get(namegen.LABEL_PODGANG) or "").startswith(
            "bridge"
        ):
            node = harness.cluster.node(node_name)
            if (
                node is not None
                and node.labels.get("cloud.google.com/gke-tpu-ici-block")
                == "block-0"
            ):
                bridge_node = node_name
    refs = {
        "frag": _gang_name_of(harness, "frag"),
        "fits": _gang_name_of(harness, "capped-1"),
        "capped": _gang_name_of(harness, "capped-2"),
        "bridge": _gang_name_of(harness, "bridge"),
        "bridge_node": bridge_node,
        "filler_queue": "tenant-z",
    }
    return harness, refs


def _gang_name_of(harness, pcs_name: str) -> Optional[str]:
    for gang in harness.store.list("PodGang"):
        if gang.metadata.name.startswith(f"{pcs_name}-"):
            return gang.metadata.name
    return None


def metrics_baseline() -> Dict[str, float]:
    """Snapshot of the process-global counters the contended report deltas
    against (the bench runs other workloads in the same process first)."""
    from grove_tpu_torch.observability.metrics import METRICS

    return {
        "order": METRICS.hist_sum.get("quota_order_seconds", 0.0),
        "solver": METRICS.hist_sum.get("gang_solve_seconds", 0.0),
        "reclaims": METRICS.counters.get("quota_reclaims_total", 0),
    }


def contended_report(harness, tenants, base: Optional[Dict] = None) -> Dict:
    """Per-queue achieved vs deserved (in gangs), reclaim count, and the
    ordering-overhead share of solver wall time (deltas vs `base`)."""
    from grove_tpu_torch.observability.metrics import METRICS
    from grove_tpu_torch.quota.manager import quota_snapshot

    base = base or {"order": 0.0, "solver": 0.0, "reclaims": 0}
    snap = {row["name"]: row for row in quota_snapshot(harness.store)}
    per_queue = {}
    converged = True
    for name, deserved_cpu, _ in tenants:
        achieved = snap.get(name, {}).get("admittedGangs", 0)
        deserved_gangs = deserved_cpu  # 1 cpu per gang in this scenario
        ok = abs(achieved - deserved_gangs) <= 1.0
        converged = converged and ok
        per_queue[name] = {
            "deserved_gangs": deserved_gangs,
            "achieved_gangs": achieved,
            "dominant_share": round(snap.get(name, {}).get("dominantShare", 0.0), 4),
            "within_one_gang": ok,
        }
    order_s = (
        METRICS.hist_sum.get("quota_order_seconds", 0.0) - base["order"]
    )
    solver_s = (
        METRICS.hist_sum.get("gang_solve_seconds", 0.0) - base["solver"]
    )
    return {
        "tenants": per_queue,
        "within_one_gang": converged,
        "reclaims": int(
            METRICS.counters.get("quota_reclaims_total", 0)
            - base["reclaims"]
        ),
        "order_seconds": round(order_s, 4),
        "solver_seconds": round(solver_s, 4),
        "order_overhead_ratio": round(order_s / solver_s, 4) if solver_s else 0.0,
    }


def run_contended(
    tenants: Sequence[Tuple[str, float, int]] = (
        ("team-a", 6.0, 12),
        ("team-b", 4.0, 12),
        ("team-c", 2.0, 12),
    ),
    max_ticks: int = 200,
    device=None,
) -> Tuple[object, Dict]:
    base = metrics_baseline()
    harness, tenants = build_contended_harness(tenants, device=device)
    harness.converge(max_ticks=max_ticks)
    return harness, contended_report(harness, tenants, base)


def single_queue_ab(n_sets: int = 24, num_nodes: int = 16, device=None) -> Dict:
    """A/B guard: the same workload with NO Queue CRs vs EVERYTHING in one
    queue must produce identical admissions (pod -> node bindings), pinning
    the single-queue bit-identical contract end to end."""
    import time as _time

    from grove_tpu_torch.api.meta import deep_copy
    from grove_tpu_torch.sim.harness import SimHarness

    def run(with_queue: bool):
        harness = SimHarness(num_nodes=num_nodes, device=device)
        if with_queue:
            harness.apply_queue(tenant_queue("everyone", 1e9))
        t0 = _time.perf_counter()
        for i in range(n_sets):
            pcs = deep_copy(_TENANT_BASE)
            pcs.metadata.name = f"svc-{i:04d}"
            if with_queue:
                pcs.metadata.labels[namegen.LABEL_QUEUE] = "everyone"
            harness.apply(pcs)
        harness.converge(max_ticks=60 + n_sets)
        wall = _time.perf_counter() - t0
        bindings = sorted(
            (ns, name, node)
            for (ns, name), node in harness.cluster.bindings.items()
        )
        return bindings, wall

    base_bindings, base_wall = run(False)
    quota_bindings, quota_wall = run(True)
    return {
        "identical_admissions": base_bindings == quota_bindings,
        "admitted_pods": len(base_bindings),
        "base_wall_s": round(base_wall, 3),
        "quota_wall_s": round(quota_wall, 3),
    }
