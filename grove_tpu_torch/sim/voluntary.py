"""The voluntary-disruption scenario: drain the busiest node of a loaded,
budgeted cluster.

Counterpart of ``grove_tpu/sim/voluntary.py``. ``run_drain_scenario``
drains the node hosting the most gangs and checks the contract tick by
tick: every affected gang is evicted whole, no PodCliqueSet's
``disruptionBudget`` is ever exceeded, at least one gang gets a trial-solved
placement on the remaining nodes before its pods are evicted, every drained
gang is re-admitted and the node reaches ``Drained``. ``run_breaker_storm``
opens the broker's circuit breaker with an eviction storm and closes it with
a quiet window; ``inert_ab`` holds admissions with the broker wired and
detached (no budgets, no drains) equal; ``drain_artifact`` is the JAX
bench's ``"drain"`` block. The harnesses solve on ``device`` (the card unless
the caller passes ``device="cpu"``).
"""

from __future__ import annotations

from typing import Dict, Tuple

from grove_tpu_torch.api.load import load_podcliquesets
from grove_tpu_torch.api.meta import deep_copy
from grove_tpu_torch.api.pod import is_ready
from grove_tpu_torch.api.types import PHASE_RUNNING
from grove_tpu_torch.observability.events import EVENTS
from grove_tpu_torch.sim.harness import SimHarness

_BUDGETED_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: svc
spec:
  replicas: 2
  template:
    disruptionBudget:
      maxUnavailableGangs: 1
      quietWindow: 2s
    cliques:
      - name: worker
        spec:
          roleName: worker
          replicas: 3
          minAvailable: 2
          podSpec:
            containers:
              - name: w
                image: busybox:stable
                resources:
                  requests:
                    cpu: 3
"""
# replicas: 2 → TWO gangs per set under ONE budget (maxUnavailableGangs=1:
# draining a node hosting both must evict them one at a time); cpu 3 → a
# 3-pod gang (9 cpu) never fits one 8-cpu node, so nodes host pods of
# multiple gangs and a drain touches several budgets at once.

_BASE = load_podcliquesets(_BUDGETED_YAML)[0]


def _build(
    n_sets: int,
    num_nodes: int,
    with_budget: bool = True,
    with_broker: bool = True,
    device=None,
) -> SimHarness:
    h = SimHarness(num_nodes=num_nodes, device=device)
    if not with_broker:
        # A/B control leg: detach BEFORE anything converges, so the whole
        # admission history runs broker-less (detaching after a converge
        # would compare a run against itself)
        h.scheduler.broker = None
        h.ctx.disruption = None
    for i in range(n_sets):
        pcs = deep_copy(_BASE)
        pcs.metadata.name = f"svc-{i:02d}"
        if not with_budget:
            pcs.spec.template.disruption_budget = None
        h.apply(pcs)
    h.converge()
    return h


def _busiest_node(h: SimHarness) -> Tuple[str, int]:
    """(node hosting pods of the most distinct gangs, gang count)."""
    from grove_tpu_torch.api import names as namegen

    gangs_per_node: Dict[str, set] = {}
    for (ns, pod_name), node in sorted(h.cluster.bindings.items()):
        pod = h.store.get("Pod", ns, pod_name, readonly=True)
        if pod is None:
            continue
        gang = pod.metadata.labels.get(namegen.LABEL_PODGANG)
        if gang:
            gangs_per_node.setdefault(node, set()).add((ns, gang))
    node = max(sorted(gangs_per_node), key=lambda n: len(gangs_per_node[n]))
    return node, len(gangs_per_node[node])


def run_drain_scenario(
    n_sets: int = 3, num_nodes: int = 12, max_ticks: int = 400, device=None
) -> Tuple[SimHarness, Dict]:
    """Drain the busiest node under per-tick budget watch. Returns
    (harness, report)."""
    h = _build(n_sets, num_nodes, device=device)
    pods_before = len(h.store.list("Pod"))
    target, gangs_on_node = _busiest_node(h)
    h.drainer.request_drain(target)

    budget_max_observed = 0
    budget_exceeded = False
    whole_violations = 0
    ticks = 0
    ticks_to_drained = None
    for _ in range(max_ticks):
        work = h.engine.drain()
        work += h.autoscaler.tick()
        work += h.node_monitor.tick()
        work += h.drainer.tick()
        bound = h.schedule()
        started = h.cluster.kubelet_tick()
        work += h.engine.drain()
        ticks += 1
        # per-tick budget invariant (the acceptance bar: never exceeded)
        for pcs in h.store.scan("PodCliqueSet"):
            budget = pcs.spec.template.disruption_budget
            if budget is None:
                continue
            key = (pcs.metadata.namespace, pcs.metadata.name)
            disrupted = h.disruption.voluntarily_disrupted_gangs(key)
            budget_max_observed = max(budget_max_observed, disrupted)
            if disrupted > (budget.max_unavailable_gangs or 0):
                budget_exceeded = True
        # gang-whole invariant: a gang is never left PARTIALLY evicted by
        # the drain - each drained gang's pods die together, so any gang
        # with a Drained disruption mark must have zero bound pods
        from grove_tpu_torch.api.meta import get_condition
        from grove_tpu_torch.api.types import (
            COND_PODGANG_DISRUPTION_TARGET,
            COND_PODGANG_SCHEDULED,
        )

        for gang in h.store.scan("PodGang"):
            dt = get_condition(
                gang.status.conditions, COND_PODGANG_DISRUPTION_TARGET
            )
            sched = get_condition(
                gang.status.conditions, COND_PODGANG_SCHEDULED
            )
            if (
                dt is None
                or not dt.is_true()
                or dt.reason != "Drained"
                or (sched is not None and sched.is_true())
            ):
                continue
            still_bound = sum(
                1
                for group in gang.spec.pod_groups
                for ref in group.pod_references
                if (ref.namespace, ref.name) in h.cluster.bindings
            )
            if still_bound:
                whole_violations += 1
        if ticks_to_drained is None and h.drainer.drain_state(target) == (
            "Drained"
        ):
            ticks_to_drained = ticks
        if not work and not bound and not started:
            # idle: a requeue backoff, drain retry (quiet window), or gate
            # retry may still be pending - jump to the earliest wakeup
            # (converge() pattern) instead of stopping mid-recovery
            wakes = [
                w
                for w in (
                    h.engine.next_wakeup(),
                    h.autoscaler.next_deadline(),
                    h.node_monitor.next_deadline(),
                    h.drainer.next_deadline(),
                )
                if w is not None
            ]
            wake = min(wakes) if wakes else None
            if wake is not None and wake - h.clock.now() <= 120.0:
                h.clock.advance(max(wake - h.clock.now(), 0.0))
                continue
            if ticks_to_drained is not None:
                break
        h.clock.advance(1.0)

    pods = h.store.list("Pod")
    gangs = h.store.scan("PodGang")
    drained = h.drainer.drained_gangs
    report = {
        "sets": n_sets,
        "nodes": num_nodes,
        "drained_node": target,
        "gangs_on_node": gangs_on_node,
        "drain_evictions": len(drained),
        "pre_placed": sum(1 for d in drained if d["pre_placed"]),
        "budget_cap": 1,
        "budget_max_observed": budget_max_observed,
        "budget_exceeded": budget_exceeded,
        "gang_whole_violations": whole_violations,
        "ticks_to_drained": ticks_to_drained,
        "node_drained": h.drainer.drain_state(target) == "Drained",
        "node_empty": not any(
            n == target for n in h.cluster.bindings.values()
        ),
        "readmitted": (
            len(pods) == pods_before
            and all(is_ready(p) for p in pods)
            and all(g.status.phase == PHASE_RUNNING for g in gangs)
        ),
    }
    return h, report


def run_breaker_storm(h: SimHarness, burst: int = 3) -> Dict:
    """Injected eviction storm against a tight broker: grants must exhaust
    the token bucket (BreakerOpen), further requests are throttled, and the
    quiet window closes it again (BreakerClosed)."""
    from grove_tpu_torch.disruption import DisruptionBroker

    broker = DisruptionBroker(
        h.store,
        bucket_capacity=burst,
        refill_per_second=0.0,
        close_after=5.0,
    )
    broker.arm()
    gangs = sorted(
        h.store.scan("PodGang"),
        key=lambda g: (g.metadata.namespace, g.metadata.name),
    )
    granted = denied = 0
    opened = False
    for gang in gangs:
        if broker.grant([gang], "storm"):
            granted += 1
        else:
            denied += 1
        if broker.breaker_open:
            opened = True
    # while open every request is denied
    denied_while_open = (
        not broker.grant([gangs[0]], "storm") if opened else False
    )
    # a quiet window closes it - but pressure during the window must NOT
    h.clock.advance(broker.close_after + 1.0)
    closed_after_quiet = broker.grant([gangs[0]], "storm")
    return {
        "burst": burst,
        "granted": granted,
        "denied": denied,
        "opened": opened,
        "denied_while_open": denied_while_open,
        "closed_after_quiet": bool(closed_after_quiet),
        "breaker_open_event": bool(EVENTS.list(reason="BreakerOpen")),
        "breaker_closed_event": bool(EVENTS.list(reason="BreakerClosed")),
    }


def inert_ab(n_sets: int = 4, num_nodes: int = 12, device=None) -> Dict:
    """A/B guard rail: the same un-budgeted workload with the broker wired
    vs with it DETACHED must produce identical admissions - the broker is
    provably inert when nothing configures it."""

    def run(with_broker: bool):
        h = _build(
            n_sets, num_nodes, with_budget=False, with_broker=with_broker, device=device
        )
        return sorted(
            (ns, name, node)
            for (ns, name), node in h.cluster.bindings.items()
        )

    detached = run(False)
    wired = run(True)
    return {
        "identical_admissions": detached == wired,
        "admitted_pods": len(detached),
    }


def drain_artifact(device=None) -> Dict:
    """The JAX bench's ``"drain"`` block."""
    h, report = run_drain_scenario(device=device)
    report["breaker"] = run_breaker_storm(h)
    report["ab"] = inert_ab(device=device)
    report["ok"] = (
        not report["budget_exceeded"]
        and report["gang_whole_violations"] == 0
        and report["pre_placed"] >= 1
        and report["node_drained"]
        and report["readmitted"]
        and report["breaker"]["opened"]
        and report["breaker"]["closed_after_quiet"]
        and report["ab"]["identical_admissions"]
    )
    return report
