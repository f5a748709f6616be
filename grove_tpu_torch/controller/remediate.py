"""Forecast-driven remediation: the policy controller that closes the loop.

Counterpart of ``grove_tpu/controller/remediate.py``. Burn-rate alerts
detect, explain verdicts diagnose, what-if trial solves simulate (on the
scheduler's device: the fill kernel on the card); this controller is the
verb: ticked by the harness like the HPA and the node monitor, it turns
those signals into ACTIONS, under three hard rules:

1. **Prove before acting.** A structural remediation (drain of a node,
   defrag migration of a gang) executes only when the what-if engine's
   commit-nothing trial solve says the action FLIPS the cited gang's
   verdict to ``fits_now``. No speculation: the same solver kernel that
   would place the gang afterwards judges the hypothesis first.
2. **Mechanism stays put.** Every action goes through the existing
   machinery — node drains through ``NodeDrainController`` (which runs
   each eviction through the ``DisruptionBroker``'s per-PCS budget
   grants), scale-ups through the autoscaler's decision log. The storm
   breaker is respected: an open breaker pauses all remediation.
3. **Account for everything.** Every considered action — executed or
   skipped — writes one causal chain into ``LEDGER``
   (trigger→diagnosis→simulation→action→effect), written in the same
   function as the act call. Effects are measured: the SLO error-budget delta over the
   effect window lands on the entry once the window elapses.

Triggers: ``SloBurnRateHigh`` (walk pending gangs' explain verdicts,
defrag-migrate the one provably unblocked), forecast-peak (preemptive
scale-up ahead of the diurnal peak the forecaster predicts), and a
fragmentation threshold (defrag without waiting for the burn).

Off by default with a one-boolean check
(``GROVE_TPU_REMEDIATE=1`` / ``enable()``); a disabled remediator is
provably inert — byte-identical A/B pinned in tests and the smoke.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import get_condition
from grove_tpu_torch.api.types import COND_PODGANG_SCHEDULED
from grove_tpu_torch.observability.forecast import FORECASTER
from grove_tpu_torch.observability.ledger import (
    ACTION_DRAIN_NODE,
    ACTION_MIGRATE_GANG,
    ACTION_SCALE_UP,
    LEDGER,
    OUTCOME_EXECUTED,
    OUTCOME_SKIPPED,
    TRIGGER_FAILSLOW,
    TRIGGER_FORECAST_PEAK,
    TRIGGER_FRAG_THRESHOLD,
    TRIGGER_SLO_BURN,
)
from grove_tpu_torch.observability.slo import SLO
from grove_tpu_torch.sim.cluster import NODE_DEGRADED

DEFAULT_EFFECT_WINDOW = 120.0  # seconds from action to effect measurement
DEFAULT_COOLDOWN = 60.0  # per (action kind, target) re-trigger damping
MAX_PENDING_WALK = 4  # explain verdicts consulted per burn tick
MAX_DRAIN_CANDIDATES = 3  # filler nodes trial-solved per defrag attempt


class RemediationController:
    """One instance per harness, wired over the existing mechanism layer
    (store/cluster/scheduler/drainer/broker/autoscaler/explain). Keeps
    only policy state (cooldowns, scale policies, pending effect
    measurements) — every cluster fact is re-read per tick."""

    def __init__(
        self,
        store,
        cluster,
        scheduler,
        drainer,
        broker,
        autoscaler,
        explain,
    ) -> None:
        self.store = store
        self.cluster = cluster
        self.scheduler = scheduler
        self.drainer = drainer
        self.broker = broker
        self.autoscaler = autoscaler
        self.explain = explain
        self.enabled = os.environ.get("GROVE_TPU_REMEDIATE", "") not in (
            "",
            "0",
            "false",
        )
        self.effect_slo: Optional[str] = None
        self.effect_window = DEFAULT_EFFECT_WINDOW
        self.cooldown = DEFAULT_COOLDOWN
        self.frag_threshold: Optional[float] = None
        # forecast scale-up policies: series → HPA-shaped target
        self._scale_policies: List[dict] = []
        # (action_kind, target) -> vt before which we will not re-consider
        self._cooldowns: Dict[Tuple[str, str], float] = {}
        # (due_vt, ledger entry id, slo name, budget_before)
        self._pending_effects: List[Tuple[float, int, Optional[str], Optional[float]]] = []

    # -- lifecycle -------------------------------------------------------

    def enable(
        self,
        effect_slo: Optional[str] = None,
        effect_window: Optional[float] = None,
        cooldown: Optional[float] = None,
        frag_threshold: Optional[float] = None,
    ) -> "RemediationController":
        if effect_slo is not None:
            self.effect_slo = effect_slo
        if effect_window is not None:
            self.effect_window = float(effect_window)
        if cooldown is not None:
            self.cooldown = float(cooldown)
        if frag_threshold is not None:
            self.frag_threshold = float(frag_threshold)
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def add_scale_policy(
        self,
        series: str,
        threshold: float,
        kind: str,
        namespace: str,
        name: str,
        max_replicas: int,
        step: int = 1,
    ) -> None:
        """Preemptive scale-up policy: when the forecast's peak mean over
        the horizon crosses ``threshold``, raise the target by ``step``
        replicas (never past ``max_replicas``) BEFORE the peak arrives."""
        self._scale_policies.append(
            {
                "series": series,
                "threshold": float(threshold),
                "kind": kind,
                "namespace": namespace,
                "name": name,
                "max_replicas": int(max_replicas),
                "step": int(step),
            }
        )

    def next_deadline(self) -> Optional[float]:
        """Earliest pending effect-measurement instant — lets the harness
        jump virtual time to it instead of idling short ticks."""
        if not self.enabled or not self._pending_effects:
            return None
        return min(due for due, _, _, _ in self._pending_effects)

    # -- tick ------------------------------------------------------------

    def tick(self) -> int:
        """One policy round: measure due effects, then at most one
        structural action plus any forecast scale-ups. Returns work units
        so harness quiescence sees remediation as progress."""
        if not self.enabled:
            return 0
        now = self.store.clock.now()
        work = self._measure_effects(now)
        burning = SLO.burning()
        if burning:
            structural = self._on_burn(burning[0], now)
        elif self.frag_threshold is not None:
            structural = self._on_frag(now)
        else:
            structural = 0
        if not structural:
            # fail-slow drains ride the same one-structural-action-per-
            # tick discipline as burn/frag defrags
            structural = self._on_failslow(now)
        work += structural
        work += self._on_forecast(now)
        return work

    # -- triggers --------------------------------------------------------

    def _on_burn(self, burn: dict, now: float) -> int:
        """Burn alert: walk pending gangs' explain verdicts; defrag the
        first one the what-if engine proves a drain would unblock."""
        slo_name = burn["name"]
        fast = burn.get("burn_rate_fast")
        detail = f"slo {slo_name} burn" + (
            f" fast={fast:.1f}x" if isinstance(fast, float) else ""
        )
        for ns, name in self._pending_gangs():
            doc = self.explain.explain(ns, name)
            if doc is None or doc.get("fits_now"):
                continue
            diagnosis = {
                "gang": f"{ns}/{name}",
                "binding_constraint": doc.get("binding_constraint"),
                "detail": doc.get("detail"),
            }
            if self._defraggable(doc):
                acted = self._defrag(
                    TRIGGER_SLO_BURN, detail, ns, name, diagnosis,
                    slo_name, now,
                )
                if acted:
                    return acted
        return 0

    def _on_frag(self, now: float) -> int:
        """Fragmentation threshold: defrag a blocked gang before the frag
        turns into a burn."""
        report = self.explain.capacity()
        score = 0.0
        for level in report.get("levels", []):
            for frac in (level.get("fragmentation") or {}).values():
                score = max(score, float(frac))
        if score < self.frag_threshold:
            return 0
        detail = f"fragmentation {score:.2f} >= {self.frag_threshold:.2f}"
        for ns, name in self._pending_gangs():
            doc = self.explain.explain(ns, name)
            if doc is None or doc.get("fits_now"):
                continue
            if not self._defraggable(doc):
                continue
            diagnosis = {
                "gang": f"{ns}/{name}",
                "binding_constraint": doc.get("binding_constraint"),
                "detail": doc.get("detail"),
            }
            acted = self._defrag(
                TRIGGER_FRAG_THRESHOLD, detail, ns, name, diagnosis,
                self.effect_slo, now,
            )
            if acted:
                return acted
        return 0

    def _on_failslow(self, now: float) -> int:
        """Fail-slow trigger (docs/robustness.md "Gray failures"): a node
        the suspicion EWMA flipped to Degraded is already masked from new
        placements; this decides whether to also DRAIN it — only when the
        what-if engine proves every victim gang re-places on the remaining
        healthy capacity (the scheduled-gang analogue of a verdict flip:
        Scheduled → fits-elsewhere), and every victim clears the
        disruption broker's budget. A gray failure never justifies
        breaking a gang the failure itself did not break."""
        degraded = sorted(
            n.name
            for n in self.cluster.nodes
            if n.state == NODE_DEGRADED
        )
        work = 0
        for node in degraded:
            if self._cooling("failslow", node, now):
                continue
            victims = self._bound_gangs(node)
            if not victims:
                # nothing bound: the schedulable mask alone contains the
                # gray failure; draining an empty node is pure churn
                self._cool("failslow", node, now)
                continue
            trigger_detail = (
                f"node {node} Degraded (fail-slow suspicion over threshold)"
            )
            diagnosis = {
                "node": node,
                "victims": [f"{vns}/{vname}" for vns, vname in victims],
            }
            if self.broker.active() and self.broker.breaker_open:
                self._cool("failslow", node, now)
                LEDGER.record(
                    TRIGGER_FAILSLOW, ACTION_DRAIN_NODE, OUTCOME_SKIPPED,
                    trigger_detail=trigger_detail, diagnosis=diagnosis,
                    reason="breaker-open", now=now,
                )
                work += 1
                continue
            proven = True
            afters = []
            for vns, vname in victims:
                report = self.explain.whatif(
                    {
                        "gang": {"namespace": vns, "name": vname},
                        "actions": [
                            {"action": "drain-node", "node": node}
                        ],
                    }
                )
                afters.append(
                    {
                        "gang": f"{vns}/{vname}",
                        "fits_after": bool(
                            report["after"].get("fits_now")
                        ),
                        "after": report["after"].get(
                            "binding_constraint"
                        ),
                    }
                )
                if not report["after"].get("fits_now"):
                    proven = False
                    break
            self._cool("failslow", node, now)
            simulation = {"flipped": proven, "victims": afters}
            if not proven:
                LEDGER.record(
                    TRIGGER_FAILSLOW, ACTION_DRAIN_NODE, OUTCOME_SKIPPED,
                    trigger_detail=trigger_detail, diagnosis=diagnosis,
                    simulation=simulation,
                    reason="not-flipped", now=now,
                )
                work += 1
                continue
            denied = False
            for vns, vname in victims:
                gang = self.store.get("PodGang", vns, vname, readonly=True)
                if gang is not None and not self.broker.would_allow(
                    gang, now
                ):
                    LEDGER.record(
                        TRIGGER_FAILSLOW, ACTION_DRAIN_NODE,
                        OUTCOME_SKIPPED,
                        trigger_detail=trigger_detail, diagnosis=diagnosis,
                        simulation=simulation,
                        action={"target": node},
                        reason=f"budget-denied for {vns}/{vname}", now=now,
                    )
                    denied = True
                    break
            if denied:
                work += 1
                continue
            self.drainer.request_drain(node)
            entry = LEDGER.record(
                TRIGGER_FAILSLOW, ACTION_DRAIN_NODE, OUTCOME_EXECUTED,
                trigger_detail=trigger_detail, diagnosis=diagnosis,
                simulation=simulation,
                action={
                    "target": node,
                    "mechanism": "drain",
                    "victims": [
                        f"{vns}/{vname}" for vns, vname in victims
                    ],
                },
                now=now,
            )
            self._schedule_effect(entry, self.effect_slo, now)
            return work + 1
        return work

    def _on_forecast(self, now: float) -> int:
        """Forecast peaks: preemptive scale-up ahead of the predicted
        diurnal peak (scoring feeds forecast_skill/<series> per round)."""
        work = 0
        for policy in self._scale_policies:
            fc = FORECASTER.forecast(policy["series"], feed=True, now=now)
            peak = fc.get("peak")
            if peak is None or peak["mean"] < policy["threshold"]:
                continue
            work += self._scale_up(policy, fc, now)
        return work

    # -- actions (every act call logs its ledger entry here) -------------

    def _defrag(
        self,
        trigger: str,
        trigger_detail: str,
        ns: str,
        name: str,
        diagnosis: dict,
        slo_name: Optional[str],
        now: float,
    ) -> int:
        """Budget-gated defrag: trial filler-node drains through what-if;
        execute the first PROVEN flip via the drain controller (whose own
        eviction path runs every gang through a broker grant)."""
        node = None  # the chosen candidate (set on flip)
        action_kind = ACTION_MIGRATE_GANG
        # cooldown keyed on the diagnosed gang, not the action kind the
        # attempt ends up with (drain-node vs migrate-gang is decided by
        # the winning candidate's health, below)
        if self._cooling("defrag", f"{ns}/{name}", now):
            return 0
        if self.broker.active() and self.broker.breaker_open:
            self._cool("defrag", f"{ns}/{name}", now)
            LEDGER.record(
                trigger, action_kind, OUTCOME_SKIPPED,
                trigger_detail=trigger_detail, diagnosis=diagnosis,
                reason="breaker-open", now=now,
            )
            return 1
        tried = []
        simulation = None
        for candidate, health in self._drain_candidates():
            report = self.explain.whatif(
                {
                    "gang": {"namespace": ns, "name": name},
                    "actions": [
                        {"action": "drain-node", "node": candidate}
                    ],
                }
            )
            tried.append(candidate)
            if not report["flipped"]:
                continue
            node = candidate
            simulation = {
                "flipped": True,
                "actions": report["actions"],
                "after": report["after"].get("binding_constraint"),
            }
            # a flapping/unhealthy filler is a drain-node remediation;
            # a healthy one is a pure defrag migration
            if not health:
                action_kind = ACTION_DRAIN_NODE
            break
        self._cool("defrag", f"{ns}/{name}", now)
        if node is None:
            LEDGER.record(
                trigger, action_kind, OUTCOME_SKIPPED,
                trigger_detail=trigger_detail, diagnosis=diagnosis,
                simulation={"flipped": False, "tried": tried},
                reason="no-flipping-candidate", now=now,
            )
            return 1
        # budget gate BEFORE the cordon: every gang the drain would evict
        # must clear the broker's pure check (the drain's own grant() still
        # decides for real, per gang, at eviction time)
        victims = self._bound_gangs(node)
        for vns, vname in victims:
            gang = self.store.get("PodGang", vns, vname, readonly=True)
            if gang is not None and not self.broker.would_allow(gang, now):
                LEDGER.record(
                    trigger, action_kind, OUTCOME_SKIPPED,
                    trigger_detail=trigger_detail, diagnosis=diagnosis,
                    simulation=simulation,
                    action={"target": node},
                    reason=f"budget-denied for {vns}/{vname}", now=now,
                )
                return 1
        self.drainer.request_drain(node)
        entry = LEDGER.record(
            trigger, action_kind, OUTCOME_EXECUTED,
            trigger_detail=trigger_detail, diagnosis=diagnosis,
            simulation=simulation,
            action={
                "target": node,
                "mechanism": "drain",
                "victims": [f"{vns}/{vname}" for vns, vname in victims],
            },
            now=now,
        )
        self._schedule_effect(entry, slo_name, now)
        return 1

    def _scale_up(self, policy: dict, fc: dict, now: float) -> int:
        """Forecast-gated preemptive scale-up through the autoscaler's
        decision log (ONE unified hpa_* stream)."""
        kind, ns, name = policy["kind"], policy["namespace"], policy["name"]
        key = f"{kind}/{ns}/{name}"
        if self._cooling(ACTION_SCALE_UP, key, now):
            return 0
        self._cool(ACTION_SCALE_UP, key, now)
        peak = fc["peak"]
        trigger_detail = (
            f"{policy['series']} forecast peak {peak['mean']:.3f} >="
            f" {policy['threshold']:.3f} at t={peak['at_s']:.0f}s"
        )
        simulation = {
            "flipped": None,
            "forecast": {
                "peak": peak,
                "model": fc.get("model"),
                "skill": fc.get("skill"),
            },
        }
        target = self.store.get(kind, ns, name, readonly=True)
        if target is None:
            LEDGER.record(
                TRIGGER_FORECAST_PEAK, ACTION_SCALE_UP, OUTCOME_SKIPPED,
                trigger_detail=trigger_detail, simulation=simulation,
                action={"target": key}, reason="target-absent", now=now,
            )
            return 1
        current = int(target.spec.replicas)
        desired = min(policy["max_replicas"], current + policy["step"])
        if desired <= current:
            LEDGER.record(
                TRIGGER_FORECAST_PEAK, ACTION_SCALE_UP, OUTCOME_SKIPPED,
                trigger_detail=trigger_detail, simulation=simulation,
                action={"target": key, "from": current},
                reason="at-max-replicas", now=now,
            )
            return 1
        scaled = self.autoscaler.scale_target(kind, ns, name, desired)
        entry = LEDGER.record(
            TRIGGER_FORECAST_PEAK, ACTION_SCALE_UP,
            OUTCOME_EXECUTED if scaled else OUTCOME_SKIPPED,
            trigger_detail=trigger_detail, simulation=simulation,
            action={"target": key, "from": current, "to": desired},
            reason="" if scaled else "scale-rejected", now=now,
        )
        if scaled:
            self._schedule_effect(entry, self.effect_slo, now)
        return 1

    # -- effects ---------------------------------------------------------

    def _schedule_effect(
        self, entry_id: Optional[int], slo_name: Optional[str], now: float
    ) -> None:
        if entry_id is None:
            return
        budget = (
            SLO.budget_remaining(slo_name) if slo_name is not None else None
        )
        self._pending_effects.append(
            (now + self.effect_window, entry_id, slo_name, budget)
        )

    def _measure_effects(self, now: float) -> int:
        due = [e for e in self._pending_effects if e[0] <= now]
        if not due:
            return 0
        self._pending_effects = [
            e for e in self._pending_effects if e[0] > now
        ]
        for _, entry_id, slo_name, before in due:
            after = (
                SLO.budget_remaining(slo_name)
                if slo_name is not None
                else None
            )
            LEDGER.effect(
                entry_id, self.effect_window, before, after, now=now
            )
        return len(due)

    # -- cluster reads ---------------------------------------------------

    @staticmethod
    def _defraggable(doc: dict) -> bool:
        """A verdict a drain/migration could plausibly flip: blocked on
        topology or raw capacity (fragmentation family), not on quota /
        disruption holds / solve ordering."""
        constraint = doc.get("binding_constraint") or ""
        detail = doc.get("detail") or ""
        return constraint in ("topology", "capacity") or "fragmentation" in detail

    def _pending_gangs(self) -> List[Tuple[str, str]]:
        """Unscheduled PodGangs in deterministic order, bounded — explain
        verdicts are cheap but not free."""
        out = []
        for gang in self.store.scan("PodGang"):
            cond = get_condition(
                gang.status.conditions, COND_PODGANG_SCHEDULED
            )
            if cond is not None and cond.is_true():
                continue
            out.append((gang.metadata.namespace, gang.metadata.name))
        out.sort()
        return out[:MAX_PENDING_WALK]

    def _drain_candidates(self) -> List[Tuple[str, bool]]:
        """Filler-node candidates for a defrag drain: schedulable nodes
        carrying the FEWEST bound pods first (least relocation for the
        most contiguity), as ``(name, healthy)`` pairs."""
        load: Dict[str, int] = {}
        for (_ns, _pod), bound in self.cluster.bindings.items():
            load[bound] = load.get(bound, 0) + 1
        candidates = [
            (load.get(n.name, 0), n.name, not n.crashed)
            for n in self.cluster.nodes
            if n.schedulable and load.get(n.name, 0) > 0
        ]
        candidates.sort()
        return [
            (name, healthy)
            for _count, name, healthy in candidates[:MAX_DRAIN_CANDIDATES]
        ]

    def _bound_gangs(self, node_name: str) -> List[Tuple[str, str]]:
        """Gangs with >= 1 pod bound to the node (the drain's victim set),
        deterministic order."""
        out = set()
        for (ns, pod_name), bound in list(self.cluster.bindings.items()):
            if bound != node_name:
                continue
            pod = self.store.get("Pod", ns, pod_name, readonly=True)
            if pod is None:
                continue
            gang_name = pod.metadata.labels.get(namegen.LABEL_PODGANG)
            if gang_name:
                out.add((ns, gang_name))
        return sorted(out)

    # -- cooldowns -------------------------------------------------------

    def _cooling(self, kind: str, target: str, now: float) -> bool:
        until = self._cooldowns.get((kind, target))
        return until is not None and now < until

    def _cool(self, kind: str, target: str, now: float) -> None:
        self._cooldowns[(kind, target)] = now + self.cooldown
