"""Causal decision-to-effect ledger of the remediation loop.

Counterpart of ``grove_tpu/observability/ledger.py``: ``LEDGER`` is a
bounded, virtual-clock-stamped ring of causal chains, one per considered
remediation: the trigger, the diagnosis (the explain verdict it cites),
the simulation (the what-if trial), the action and its outcome, and later
(``effect``) the measured change of the SLO error budget. Each ``record``
also emits a ``RemediationExecuted`` / ``RemediationSkipped`` event and
bumps ``remediation_actions_total/<kind>/<outcome>``. ``status()`` is the
``/debug/ledger`` document. Off by default (``GROVE_TPU_LEDGER=1`` or
``LEDGER.enable()``).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import List, Optional

from grove_tpu_torch.observability.events import (
    EVENTS,
    REASON_REMEDIATION_EXECUTED,
    REASON_REMEDIATION_SKIPPED,
    TYPE_NORMAL,
    TYPE_WARNING,
)
from grove_tpu_torch.observability.metrics import METRICS

# The closed vocabulary of causal-chain heads and tails.
TRIGGER_SLO_BURN = "slo-burn"  # SloBurnRateHigh from the observatory
TRIGGER_FORECAST_PEAK = "forecast-peak"  # forecast band crosses threshold
TRIGGER_FRAG_THRESHOLD = "frag-threshold"  # fragmentation score too high
TRIGGER_FAILSLOW = "fail-slow"  # node Degraded by the suspicion EWMA

TRIGGER_KINDS = (
    TRIGGER_SLO_BURN,
    TRIGGER_FORECAST_PEAK,
    TRIGGER_FRAG_THRESHOLD,
    TRIGGER_FAILSLOW,
)

ACTION_DRAIN_NODE = "drain-node"  # drain a flapping/filler node
ACTION_MIGRATE_GANG = "migrate-gang"  # budget-gated defrag migration
ACTION_SCALE_UP = "scale-up"  # preemptive HPA raise ahead of the peak

ACTION_KINDS = (
    ACTION_DRAIN_NODE,
    ACTION_MIGRATE_GANG,
    ACTION_SCALE_UP,
)

OUTCOME_EXECUTED = "executed"
OUTCOME_SKIPPED = "skipped"

DEFAULT_CAPACITY = 256


class DecisionLedger:
    """Process-global (``LEDGER``), thread-safe, bounded ring of causal
    decision→effect entries."""

    def __init__(self) -> None:
        self.enabled = os.environ.get("GROVE_TPU_LEDGER", "") not in (
            "",
            "0",
            "false",
        )
        self.clock = None
        self._lock = threading.Lock()
        self._entries: deque = deque(maxlen=DEFAULT_CAPACITY)
        self._seq = 0

    # -- lifecycle -------------------------------------------------------

    def enable(
        self, capacity: int = DEFAULT_CAPACITY, clock=None
    ) -> "DecisionLedger":
        with self._lock:
            self._entries = deque(self._entries, maxlen=max(8, capacity))
            if clock is not None:
                self.clock = clock
            self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._seq = 0
            self.clock = None

    def _vt(self, now: Optional[float]) -> float:
        if now is not None:
            return now
        return self.clock.now() if self.clock is not None else 0.0

    # -- writes (the remediation controller only) ------------------------

    def record(
        self,
        trigger_kind: str,
        action_kind: str,
        outcome: str,
        trigger_detail: str = "",
        diagnosis: Optional[dict] = None,
        simulation: Optional[dict] = None,
        action: Optional[dict] = None,
        reason: str = "",
        now: Optional[float] = None,
    ) -> Optional[int]:
        """Append one causal chain; returns the entry id (None when the
        ledger is off). ``diagnosis`` cites the explain verdict by gang
        (``{"gang", "binding_constraint", "detail"}``), ``simulation`` the
        what-if trial (``{"flipped", "actions"}``), ``action`` the
        executed mechanics (``{"target", "grant", ...}``); ``reason``
        says why a skipped entry was skipped."""
        if not self.enabled:
            return None
        vt = self._vt(now)
        with self._lock:
            self._seq += 1
            entry = {
                "id": self._seq,
                "vt": vt,
                "trigger": {"kind": trigger_kind, "detail": trigger_detail},
                "diagnosis": diagnosis or {},
                "simulation": simulation or {},
                "action": dict({"kind": action_kind}, **(action or {})),
                "outcome": outcome,
                "reason": reason,
                "effect": None,
            }
            self._entries.append(entry)
        METRICS.inc(f"remediation_actions_total/{action_kind}/{outcome}")
        executed = outcome == OUTCOME_EXECUTED
        target = (action or {}).get("target", "") or (diagnosis or {}).get(
            "gang", ""
        )
        if executed:
            event_type, event_reason = (
                TYPE_NORMAL, REASON_REMEDIATION_EXECUTED,
            )
        else:
            event_type, event_reason = (
                TYPE_WARNING, REASON_REMEDIATION_SKIPPED,
            )
        EVENTS.record(
            ("Remediation", "", target or "cluster"),
            event_type,
            event_reason,
            f"{trigger_kind} -> {action_kind}"
            + (f" on {target}" if target else "")
            + (f": {reason}" if reason else ""),
        )
        return entry["id"]

    def effect(
        self,
        entry_id: int,
        window_s: float,
        budget_before: Optional[float],
        budget_after: Optional[float],
        now: Optional[float] = None,
    ) -> bool:
        """Close the chain: the measured SLO error-budget delta over the
        effect window. Returns False for unknown/evicted entries."""
        if not self.enabled:
            return False
        vt = self._vt(now)
        with self._lock:
            for entry in self._entries:
                if entry["id"] != entry_id:
                    continue
                delta = (
                    budget_after - budget_before
                    if budget_after is not None and budget_before is not None
                    else None
                )
                entry["effect"] = {
                    "vt": vt,
                    "window_s": window_s,
                    "budget_before": budget_before,
                    "budget_after": budget_after,
                    "budget_delta": delta,
                }
                return True
        return False

    # -- reads -----------------------------------------------------------

    def entries(
        self,
        outcome: Optional[str] = None,
        action_kind: Optional[str] = None,
    ) -> List[dict]:
        with self._lock:
            rows = [dict(e) for e in self._entries]
        return [
            e
            for e in rows
            if (outcome is None or e["outcome"] == outcome)
            and (action_kind is None or e["action"]["kind"] == action_kind)
        ]

    def status(self) -> dict:
        """The ``GET /debug/ledger`` document: the ring plus per-kind /
        per-outcome tallies and the flip-confirmed rate."""
        with self._lock:
            rows = [dict(e) for e in self._entries]
            total = self._seq
        by_kind: dict = {}
        executed = skipped = flipped = simulated = 0
        measured = []
        for e in rows:
            kind = e["action"]["kind"]
            out = e["outcome"]
            by_kind.setdefault(kind, {}).setdefault(out, 0)
            by_kind[kind][out] += 1
            if out == OUTCOME_EXECUTED:
                executed += 1
                # flip confirmation only applies to structural actions
                # that ran a what-if trial (scale-ups carry flipped=None)
                if e["simulation"].get("flipped") is not None:
                    simulated += 1
                    if e["simulation"]["flipped"]:
                        flipped += 1
            else:
                skipped += 1
            eff = e.get("effect")
            if eff and eff.get("budget_delta") is not None:
                measured.append(eff["budget_delta"])
        return {
            "enabled": self.enabled,
            "recorded_total": total,
            "retained": len(rows),
            "executed": executed,
            "skipped": skipped,
            "flip_confirmed_rate": (
                (flipped / simulated) if simulated else None
            ),
            "mean_budget_delta": (
                sum(measured) / len(measured) if measured else None
            ),
            "by_kind": by_kind,
            "entries": rows,
        }


LEDGER = DecisionLedger()
