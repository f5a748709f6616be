"""Everything-at-once day: the remediation loop's A/B proving ground.

Counterpart of ``grove_tpu/sim/remediation.py``. One seeded serving day
composes every stressor at once (the diurnal wave and flash crowds of
``sim/traffic.py``, a 3-node crash landing in the first crowd, an operator
node drain mid-run and tenant quota churn through Queue CRs, which run the
DRF order) and runs it twice from the same seed: remediator ON and OFF.
The delta between the runs' SLO error-budget trajectories is the loop's
value measured end to end, and the ledger ties every ON-run action back to
its trigger, diagnosis, simulation and effect.

``cluster_signature()`` hashes the store population, the bindings and the
node states, and ``inert_ab()`` replays the OFF day with the remediator's
tick replaced by a tripwire: equal signatures prove a disabled remediator
contributes nothing. Every harness solves on ``device`` (the card unless
the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import hashlib
from typing import Callable, List, Optional, Tuple

from grove_tpu_torch.api.meta import ObjectMeta
from grove_tpu_torch.api.types import Queue, QueueSpec
from grove_tpu_torch.observability.forecast import FORECASTER
from grove_tpu_torch.observability.ledger import LEDGER
from grove_tpu_torch.observability.slo import SLO
from grove_tpu_torch.observability.timeseries import TIMESERIES
from grove_tpu_torch.sim.traffic import (
    FAULT_NODES,
    ServingScenario,
    TrafficModel,
    default_slos,
)

# the objective whose error budget the effect measurements track (the
# cluster-health one — remediation aims at keeping serving ready)
EFFECT_SLO = "ready_fraction"


def cluster_signature(harness) -> str:
    """Deterministic digest of the world: every committed object's
    (kind, ns, name, rv, generation), the pod->node binding table, and
    each node's health/cordon state. Two runs that agree here made the
    same decisions at every step."""
    lines: List[str] = []
    store = harness.store
    for kind in sorted(store.kinds()):
        for obj in store.scan(kind):
            m = obj.metadata
            lines.append(
                f"{kind}|{m.namespace}|{m.name}|{m.resource_version}"
                f"|{m.generation}"
            )
    for (ns, pod), node in sorted(harness.cluster.bindings.items()):
        lines.append(f"bind|{ns}|{pod}|{node}")
    for n in harness.cluster.nodes:
        lines.append(
            f"node|{n.name}|{n.state}|{int(n.cordoned)}|{int(n.crashed)}"
        )
    lines.sort()
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def _quota_churn(harness, tenants: List[str]) -> Tuple[Callable, Callable]:
    """Two fault callables: clamp the heaviest tenant's queue hard (scale
    churn piles into QueuePending), then relax it (the backlog floods
    back) — the quota stressor of the everything-at-once day."""

    def _clamp() -> None:
        harness.apply_queue(
            Queue(
                metadata=ObjectMeta(name=tenants[0], namespace=""),
                spec=QueueSpec(
                    deserved={"cpu": 2.0}, ceiling={"cpu": 3.0}
                ),
            )
        )

    def _relax() -> None:
        harness.apply_queue(
            Queue(
                metadata=ObjectMeta(name=tenants[0], namespace=""),
                spec=QueueSpec(
                    deserved={"cpu": 32.0}, ceiling={"cpu": 64.0}
                ),
            )
        )

    return _clamp, _relax


def remediation_day(
    seed: int = 2026,
    remediate: bool = False,
    tenants: int = 3,
    num_nodes: int = 24,
    duration: float = 1200.0,
    dt: float = 10.0,
    warm: bool = True,
    flightrec_dir: Optional[str] = None,
    sabotage_tick: bool = False,
    device=None,
) -> dict:
    """One seeded everything-at-once day; returns the run's report doc.

    ``remediate`` arms the controller (forecast scale-up policies per
    scaling group + burn-triggered defrag). ``sabotage_tick`` (OFF runs
    only) replaces the disabled remediator's tick with a tripwire — the
    inert A/B's proof that the disabled path is never consulted."""
    from grove_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)
    TIMESERIES.reset()
    SLO.reset()
    LEDGER.reset()
    FORECASTER.reset()
    tenant_names = [f"tenant-{i}" for i in range(tenants)]
    model = TrafficModel(seed, tenant_names, horizon=duration)
    scenario = ServingScenario(
        seed=seed,
        tenants=tenants,
        num_nodes=num_nodes,
        model=model,
        warm=warm,
        device=device,
    )
    h = scenario.harness
    from grove_tpu_torch.observability.timeseries import install_serving_collector

    TIMESERIES.enable(clock=h.clock)
    SLO.enable()
    collector = install_serving_collector(
        h.store, scheduler=h.scheduler, clock=h.clock
    )
    for text in default_slos():
        SLO.add(text)
    # dense demand trace: the scenario only feeds traffic_demand once per
    # step, but converge's wake-jumps make steps sparse in virtual time —
    # the forecaster needs the diurnal shape at sampling resolution, so a
    # collector re-evaluates the (pure, seeded) model every sample round
    t_base = h.clock.now()

    def _demand_collector(now: float) -> None:
        rel = now - (scenario.t0 if scenario.t0 is not None else t_base)
        demands = model.demand(rel)
        for tenant in tenant_names:
            for role in ("prefill", "decode"):
                TIMESERIES.gauge(
                    f"traffic_demand/{tenant}/{role}",
                    demands[tenant][role],
                    vt=now,
                )

    TIMESERIES.add_collector(_demand_collector)
    # zero-violation gate (the chaos invariant-4 check, serving edition):
    # every sampling round, no PodCliqueSet may have more voluntarily-
    # disrupted gangs than its disruptionBudget allows — remediation acts
    # through broker grants, so an armed remediator must never move this
    budget_violations: List[str] = []

    def _budget_probe(now: float) -> None:
        for pcs in h.store.scan("PodCliqueSet"):
            budget = pcs.spec.template.disruption_budget
            if budget is None:
                continue
            key = (pcs.metadata.namespace, pcs.metadata.name)
            disrupted = h.disruption.voluntarily_disrupted_gangs(key)
            cap = budget.max_unavailable_gangs or 0
            if disrupted > cap:
                budget_violations.append(
                    f"t={now:.0f}s: PCS {key[0]}/{key[1]} has {disrupted}"
                    f" voluntarily-disrupted gang(s), budget allows {cap}"
                )

    TIMESERIES.add_collector(_budget_probe)
    # the new layers are armed in BOTH runs: ledger/forecaster writes only
    # happen on remediator calls, so arming them is part of the inertness
    # claim, not a confound
    LEDGER.enable(clock=h.clock)
    FORECASTER.enable(
        clock=h.clock, period=model.period, horizon=240.0, history=duration
    )
    watched = []
    for tenant in tenant_names:
        for role in ("prefill", "decode"):
            series = f"traffic_demand/{tenant}/{role}"
            FORECASTER.watch(series)
            watched.append(series)
    if flightrec_dir is not None:
        from grove_tpu_torch.observability.flightrec import FLIGHTREC

        FLIGHTREC.enable(out_dir=flightrec_dir, clock=h.clock)
    if remediate:
        h.remediator.enable(
            effect_slo=EFFECT_SLO,
            effect_window=120.0,
            cooldown=90.0,
        )
        for tenant in tenant_names:
            for role in ("prefill", "decode"):
                h.remediator.add_scale_policy(
                    series=f"traffic_demand/{tenant}/{role}",
                    threshold=3.0,
                    kind="PodCliqueScalingGroup",
                    namespace=tenant,
                    name=f"serve-0-{role}",
                    max_replicas=8,
                )
    elif sabotage_tick:
        def _tripwire() -> int:  # pragma: no cover - must never run
            raise AssertionError(
                "disabled remediator was ticked — inertness broken"
            )

        h.remediator.tick = _tripwire
    # -- the everything-at-once fault schedule (run-relative vt) --------
    faults: List[Tuple[float, Callable[[], None]]] = []
    if scenario.model.crowds:
        crowd = scenario.model.crowds[0]
        victims = [n.name for n in h.cluster.nodes[:FAULT_NODES]]

        def _crash() -> None:
            for name in victims:
                h.cluster.crash_node(name)

        def _restore() -> None:
            for name in victims:
                h.cluster.restart_node(name)

        faults.append((crowd.start + 5.0, _crash))
        faults.append((crowd.start + crowd.duration, _restore))
    drain_node = h.cluster.nodes[-1].name
    faults.append(
        (duration * 0.35, lambda: h.drainer.request_drain(drain_node))
    )
    faults.append(
        (duration * 0.35 + 180.0, lambda: h.drainer.uncordon(drain_node))
    )
    clamp, relax = _quota_churn(h, tenant_names)
    faults.append((duration * 0.55, clamp))
    faults.append((duration * 0.75, relax))
    scenario.faults = sorted(faults, key=lambda f: f[0])
    scenario._fired = 0
    scenario.run(duration, dt=dt)
    # -- report ----------------------------------------------------------
    status = SLO.status()
    objectives = {
        row["name"]: {
            "attainment": row["attainment"],
            "budget_remaining": row["budget_remaining"],
            "state": row["state"],
            "breaches": row["breaches"],
            "recoveries": row["recoveries"],
        }
        for row in status["objectives"]
    }
    forecasts = {}
    for series in watched:
        fc = FORECASTER.forecast(series, now=h.clock.now())
        if fc.get("skill") is not None:
            forecasts[series] = {
                "mae": round(fc["mae"], 4),
                "persistence_mae": round(fc["persistence_mae"], 4),
                "skill": round(fc["skill"], 4),
            }
    ledger = LEDGER.status()
    doc = {
        "seed": seed,
        "remediate": remediate,
        "duration_vt_s": duration,
        "objectives": objectives,
        "budget_remaining": objectives.get(EFFECT_SLO, {}).get(
            "budget_remaining"
        ),
        "scale_ups": scenario.scale_ups,
        "scale_downs": scenario.scale_downs,
        "time_under_min_vt_s": round(scenario.time_under_min, 1),
        "forecast": forecasts,
        "ledger": {
            "recorded_total": ledger["recorded_total"],
            "executed": ledger["executed"],
            "skipped": ledger["skipped"],
            "flip_confirmed_rate": ledger["flip_confirmed_rate"],
            "mean_budget_delta": ledger["mean_budget_delta"],
            "by_kind": ledger["by_kind"],
        },
        "entries": ledger["entries"],
        "budget_violations": budget_violations,
        "signature": cluster_signature(h),
    }
    if flightrec_dir is not None:
        from grove_tpu_torch.observability.flightrec import FLIGHTREC

        doc["flight_bundles"] = list(FLIGHTREC.dumps)
        FLIGHTREC.disable()
    SLO.disable()
    TIMESERIES.disable()
    TIMESERIES.remove_collector(collector)
    TIMESERIES.remove_collector(_demand_collector)
    TIMESERIES.remove_collector(_budget_probe)
    LEDGER.disable()
    FORECASTER.disable()
    h.remediator.disable()
    return doc


def remediation_artifact(
    seed: int = 2026,
    tenants: int = 3,
    num_nodes: int = 24,
    duration: float = 1200.0,
    dt: float = 10.0,
    warm: bool = True,
    device=None,
) -> dict:
    """The bench ``"remediation"`` block: the ON and OFF days from one
    seed, the on/off budget-recovery comparison, actions by kind, the
    flip-confirmed rate, and forecast skill vs the persistence baseline."""
    off = remediation_day(
        seed,
        remediate=False,
        tenants=tenants,
        num_nodes=num_nodes,
        duration=duration,
        dt=dt,
        warm=warm,
        device=device,
    )
    on = remediation_day(
        seed,
        remediate=True,
        tenants=tenants,
        num_nodes=num_nodes,
        duration=duration,
        dt=dt,
        warm=warm,
        device=device,
    )
    b_on = on.get("budget_remaining")
    b_off = off.get("budget_remaining")
    ratio = None
    if b_on is not None and b_off is not None:
        ratio = round((b_on + 1e-9) / (b_off + 1e-9), 4)
    skills = [f["skill"] for f in on["forecast"].values()]
    return {
        "seed": seed,
        "duration_vt_s": duration,
        "actions_by_kind": on["ledger"]["by_kind"],
        "executed": on["ledger"]["executed"],
        "skipped": on["ledger"]["skipped"],
        "flip_confirmed_rate": on["ledger"]["flip_confirmed_rate"],
        "mean_budget_delta": on["ledger"]["mean_budget_delta"],
        "forecast_skill_mean": (
            round(sum(skills) / len(skills), 4) if skills else None
        ),
        "forecast_beats_naive": bool(skills)
        and sum(skills) / len(skills) > 0.0,
        "budget_remaining_on": b_on,
        "budget_remaining_off": b_off,
        "budget_recovery_ratio": ratio,
        "disruption_budget_violations": len(on["budget_violations"])
        + len(off["budget_violations"]),
        "objectives_on": on["objectives"],
        "objectives_off": off["objectives"],
    }


def inert_ab(
    seed: int = 2026,
    tenants: int = 2,
    num_nodes: int = 12,
    duration: float = 300.0,
    dt: float = 10.0,
    warm: bool = False,
    device=None,
) -> Tuple[str, str]:
    """The inertness pin: the OFF day, then the OFF day again with the
    remediator's tick replaced by a tripwire. Returns both cluster
    signatures — byte-identical ⇔ the disabled path is never consulted
    and contributes nothing."""
    a = remediation_day(
        seed,
        remediate=False,
        tenants=tenants,
        num_nodes=num_nodes,
        duration=duration,
        dt=dt,
        warm=warm,
        device=device,
    )
    b = remediation_day(
        seed,
        remediate=False,
        tenants=tenants,
        num_nodes=num_nodes,
        duration=duration,
        dt=dt,
        warm=warm,
        sabotage_tick=True,
        device=device,
    )
    return a["signature"], b["signature"]
