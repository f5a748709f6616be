"""DisruptionBroker: the single gate every voluntary disruptor consults.

Counterpart of ``grove_tpu/disruption/broker.py``. The disruptors that
evict a scheduled gang on purpose (node drain, ``disruption/drain.py``;
priority preemption and quota reclaim, ``solver/scheduler.py``; rolling
update, once the controllers are ported) would otherwise act
independently: they could stack evictions on one workload and storm the
cluster with evictions faster than the solver re-admits them.

Two mechanisms, one ``grant()`` call:

- **Per-PodCliqueSet budget** (``spec.template.disruptionBudget``): at most
  ``maxUnavailableGangs`` of a set's gangs may be unavailable when a
  voluntary disruption is granted (involuntary failures count toward the
  tally — a set already degraded by a node loss doesn't also get drained),
  plus an optional ``quietWindow`` pacing consecutive grants per set.
- **Cluster-wide storm circuit breaker**: a token bucket on granted
  voluntary evictions per virtual-time window. Exhausting it — or repeated
  post-disruption placement failures reported via ``note_failure()`` —
  OPENS the breaker: every voluntary disruption is denied
  (``DisruptionThrottled``) until a quiet window with no disruption
  pressure passes, then it closes (``BreakerClosed``).

Inertness guard rail (same contract as the quota subsystem): with no
``disruptionBudget`` configured anywhere and no drain ever requested, the
broker is INERT — ``grant()`` returns True without consuming tokens,
recording state, or emitting anything, so admissions and solve order stay
byte-identical to a broker-less control plane.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import get_condition
from grove_tpu_torch.api.types import (
    COND_PODGANG_DISRUPTION_TARGET,
    COND_PODGANG_SCHEDULED,
)
from grove_tpu_torch.observability.events import (
    EVENTS,
    REASON_BREAKER_CLOSED,
    REASON_BREAKER_OPEN,
    REASON_DISRUPTION_THROTTLED,
    TYPE_NORMAL,
    TYPE_WARNING,
)
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.tracing import TRACER

# DisruptionTarget reasons that mark a VOLUNTARY disruption (the budget
# invariant counts these; involuntary NodeFailure counts toward the
# unavailable tally but never against the voluntary ledger)
VOLUNTARY_REASONS = (
    "Drained",
    "PreemptedByHigherPriority",
    "QuotaReclaimed",
    "RollingUpdate",
)

PCSKey = Tuple[str, str]  # (namespace, PodCliqueSet name)


class DisruptionBroker:
    """Budget + breaker arbiter over one store/cluster pair.

    All state is in-memory except what the store already carries (gang
    conditions); after a leader failover the budget check is immediately
    exact again (it recounts from conditions) while breaker tokens restart
    full — a fresh leader should not inherit a storm verdict it cannot
    re-derive.
    """

    def __init__(
        self,
        store,
        *,
        bucket_capacity: float = 12.0,
        refill_per_second: float = 0.5,
        close_after: float = 30.0,
    ) -> None:
        self.store = store
        # token bucket (virtual time): capacity evictions of burst, then
        # refill_per_second sustained; exhaustion opens the breaker
        self.bucket_capacity = float(bucket_capacity)
        self.refill_per_second = float(refill_per_second)
        self.close_after = float(close_after)
        self._tokens = self.bucket_capacity
        self._last_refill: Optional[float] = None
        self._open_since: Optional[float] = None
        # per-PCS quiet-window ledger
        self._last_grant: Dict[PCSKey, float] = {}
        # armed the first time a drain is requested; budgets arm implicitly
        self._armed = False

    # -- activation (the inertness guard rail) ---------------------------

    def arm(self) -> None:
        """Engage the breaker machinery explicitly — the drain controller
        arms on the first drain request; budgets arm via active()."""
        self._armed = True

    def active(self) -> bool:
        """True once any disruptionBudget exists or a drain was requested.
        While False every check short-circuits to 'allow' with zero state
        touched (byte-identical admissions, the A/B contract)."""
        if self._armed:
            return True
        for pcs in self.store.scan("PodCliqueSet"):
            if pcs.spec.template.disruption_budget is not None:
                self._armed = True  # sticky: budgets may come and go
                return True
        return False

    # -- budget bookkeeping ----------------------------------------------

    def _owner_pcs_key(self, gang) -> Optional[PCSKey]:
        name = gang.metadata.labels.get(namegen.LABEL_PART_OF)
        if not name:
            return None
        return (gang.metadata.namespace, name)

    def _budget_of(self, pcs_key: PCSKey):
        pcs = self.store.get(
            "PodCliqueSet", pcs_key[0], pcs_key[1], readonly=True
        )
        if pcs is None:
            return None
        return pcs.spec.template.disruption_budget

    def unavailable_gangs(
        self, pcs_key: PCSKey, excluding: Optional[set] = None
    ) -> int:
        """Gangs of the set currently NOT Scheduled=True — any cause. This
        is the tally a voluntary request is budget-checked against: a set
        degraded by a node loss must not also lose gangs to a drain.
        ``excluding`` drops the request's own victims from the count — a
        victim that is ALREADY unavailable (rolling update picking a downed
        replica first) doesn't reduce availability twice."""
        ns, name = pcs_key
        n = 0
        for gang in self.store.scan(
            "PodGang", ns, {namegen.LABEL_PART_OF: name}
        ):
            if excluding and (ns, gang.metadata.name) in excluding:
                continue
            cond = get_condition(
                gang.status.conditions, COND_PODGANG_SCHEDULED
            )
            if cond is None or not cond.is_true():
                n += 1
        return n

    def voluntarily_disrupted_gangs(self, pcs_key: PCSKey) -> int:
        """Gangs of the set unavailable due to a VOLUNTARY disruption —
        the per-tick invariant the chaos harness and drain smoke assert
        never exceeds maxUnavailableGangs."""
        ns, name = pcs_key
        n = 0
        for gang in self.store.scan(
            "PodGang", ns, {namegen.LABEL_PART_OF: name}
        ):
            sched = get_condition(
                gang.status.conditions, COND_PODGANG_SCHEDULED
            )
            if sched is not None and sched.is_true():
                continue
            dt = get_condition(
                gang.status.conditions, COND_PODGANG_DISRUPTION_TARGET
            )
            if dt is not None and dt.is_true() and dt.reason in VOLUNTARY_REASONS:
                n += 1
        return n

    # -- breaker ----------------------------------------------------------

    @property
    def breaker_open(self) -> bool:
        return self._open_since is not None

    def _refill(self, now: float) -> None:
        if self._last_refill is None:
            self._last_refill = now
            return
        dt = max(0.0, now - self._last_refill)
        self._tokens = min(
            self.bucket_capacity, self._tokens + dt * self.refill_per_second
        )
        self._last_refill = now

    def _open(self, now: float, why: str) -> None:
        if self._open_since is not None:
            return
        self._open_since = now
        EVENTS.record(
            ("DisruptionBroker", "", "cluster"),
            TYPE_WARNING,
            REASON_BREAKER_OPEN,
            f"disruption-storm circuit breaker opened: {why}; all voluntary"
            f" disruptions denied until {self.close_after:g}s of quiet",
        )
        METRICS.inc("disruption_breaker_opens_total")
        from grove_tpu_torch.observability.flightrec import FLIGHTREC

        if FLIGHTREC.enabled:
            # a breaker open IS an incident: ship the telemetry that led
            # to it (the eviction storm's commits/events/spans), not just
            # the event saying it happened
            FLIGHTREC.trigger("breaker-open", why)

    def _maybe_close(self, now: float) -> None:
        # fixed cooldown from OPENING, deliberately not from the last
        # denied request: a patiently retrying drain polls every tick, and
        # counting those denials as "pressure" would hold the breaker open
        # forever. A storm that persists past the cooldown just re-opens it
        # on the next exhaustion — a bounded duty cycle, not a latch.
        if self._open_since is None:
            return
        if now - self._open_since < self.close_after:
            return
        self._open_since = None
        self._tokens = self.bucket_capacity  # fresh window after the storm
        EVENTS.record(
            ("DisruptionBroker", "", "cluster"),
            TYPE_NORMAL,
            REASON_BREAKER_CLOSED,
            f"quiet window ({self.close_after:g}s) elapsed; breaker closed",
        )

    def note_failure(self, weight: float = 2.0, reason: str = "") -> None:
        """Report a post-disruption failure (a drained gang with no
        placement, a rescue that fell through): drains the bucket faster
        than a clean eviction, so repeated failures open the breaker even
        at a low eviction rate."""
        if not self.active():
            return
        now = self.store.clock.now()
        self._refill(now)
        self._tokens -= weight
        if self._tokens <= 0.0:
            self._tokens = 0.0
            self._open(now, reason or "repeated placement failures")
        METRICS.set("disruption_tokens", self._tokens)

    # -- the gate ----------------------------------------------------------

    def would_allow(self, gang, now: Optional[float] = None) -> bool:
        """Pure check (no state touched): used by disruptors to FILTER
        candidate victims before running expensive trial solves. A later
        grant() may still deny if the world moved."""
        if not self.active():
            return True
        now = self.store.clock.now() if now is None else now
        if self.breaker_open:
            # closing is grant()'s job; a pure check must not mutate
            if now - self._open_since < self.close_after:
                return False
        pcs_key = self._owner_pcs_key(gang)
        if pcs_key is None:
            return True
        budget = self._budget_of(pcs_key)
        if budget is None:
            return True
        cap = budget.max_unavailable_gangs or 0
        me = {(gang.metadata.namespace, gang.metadata.name)}
        if self.unavailable_gangs(pcs_key, excluding=me) + 1 > cap:
            return False
        if budget.quiet_window is not None:
            last = self._last_grant.get(pcs_key)
            if last is not None and now - last < budget.quiet_window:
                return False
        return True

    def grant(self, gangs: List, source: str) -> bool:
        """All-or-nothing grant for one disruptor's victim set: every gang
        must clear the breaker, its set's budget (counting the OTHER gangs
        of this very request against the same budget), and its set's quiet
        window — or nothing is granted. On success the tokens/ledgers are
        committed; the caller must actually evict."""
        if not self.active():
            return True
        now = self.store.clock.now()
        with TRACER.span(
            "disruption.grant", source=source, victims=len(gangs)
        ) as span:
            ok = self._grant(gangs, source, now)
            span.set("granted", ok)
            return ok

    def _grant(self, gangs: List, source: str, now: float) -> bool:
        self._maybe_close(now)
        if self.breaker_open:
            for gang in gangs:
                EVENTS.record(
                    (
                        "PodGang",
                        gang.metadata.namespace,
                        gang.metadata.name,
                    ),
                    TYPE_WARNING,
                    REASON_DISRUPTION_THROTTLED,
                    f"{source} denied: disruption-storm breaker is open",
                )
            METRICS.inc("disruption_throttled_total", len(gangs))
            return False
        self._refill(now)
        if self._tokens < len(gangs):
            self._open(
                now,
                f"voluntary-eviction budget exhausted ({source} asked for"
                f" {len(gangs)} eviction(s), {self._tokens:.1f} token(s)"
                " left)",
            )
            for gang in gangs:
                EVENTS.record(
                    (
                        "PodGang",
                        gang.metadata.namespace,
                        gang.metadata.name,
                    ),
                    TYPE_WARNING,
                    REASON_DISRUPTION_THROTTLED,
                    f"{source} denied: eviction storm (breaker opened)",
                )
            METRICS.inc("disruption_throttled_total", len(gangs))
            METRICS.set("disruption_tokens", self._tokens)
            return False
        # budget check with the REQUEST's own victims counted: two gangs of
        # one budget-1 set in a single victim set must be denied together —
        # while victims already unavailable on their own (downed replica
        # being rolled) are excluded from the base tally, not counted twice
        victim_keys = {
            (g.metadata.namespace, g.metadata.name) for g in gangs
        }
        extra: Dict[PCSKey, int] = {}
        for gang in gangs:
            pcs_key = self._owner_pcs_key(gang)
            if pcs_key is None:
                continue
            budget = self._budget_of(pcs_key)
            if budget is None:
                continue
            cap = budget.max_unavailable_gangs or 0
            pending = extra.get(pcs_key, 0)
            if (
                self.unavailable_gangs(pcs_key, excluding=victim_keys)
                + pending
                + 1
                > cap
            ):
                self._deny_budget(gang, pcs_key, source, cap)
                return False
            if budget.quiet_window is not None:
                last = self._last_grant.get(pcs_key)
                if last is not None and now - last < budget.quiet_window:
                    EVENTS.record(
                        (
                            "PodGang",
                            gang.metadata.namespace,
                            gang.metadata.name,
                        ),
                        TYPE_WARNING,
                        REASON_DISRUPTION_THROTTLED,
                        f"{source} denied: quiet window"
                        f" ({budget.quiet_window:g}s) of"
                        f" {pcs_key[0]}/{pcs_key[1]} still running",
                    )
                    METRICS.inc("disruption_throttled_total")
                    return False
            extra[pcs_key] = pending + 1
        # commit
        self._tokens -= len(gangs)
        for pcs_key in extra:
            self._last_grant[pcs_key] = now
        METRICS.inc(f"voluntary_disruptions_total/{source}", len(gangs))
        METRICS.set("disruption_tokens", self._tokens)
        return True

    def _deny_budget(
        self, gang, pcs_key: PCSKey, source: str, cap: int
    ) -> None:
        EVENTS.record(
            ("PodGang", gang.metadata.namespace, gang.metadata.name),
            TYPE_WARNING,
            REASON_DISRUPTION_THROTTLED,
            f"{source} denied: disruptionBudget of {pcs_key[0]}/{pcs_key[1]}"
            f" (maxUnavailableGangs={cap}) would be exceeded",
        )
        METRICS.inc("disruption_throttled_total")

    # -- observability -----------------------------------------------------

    def export_gauges(self) -> None:
        """Per-tick gauges (only once armed — an inert broker exports
        nothing): breaker state, tokens, and per-budgeted-PCS disruption
        counts."""
        if not self._armed:
            return
        now = self.store.clock.now()
        self._maybe_close(now)
        self._refill(now)
        METRICS.set("disruption_breaker_open", 1.0 if self.breaker_open else 0.0)
        METRICS.set("disruption_tokens", self._tokens)
        for pcs in self.store.scan("PodCliqueSet"):
            if pcs.spec.template.disruption_budget is None:
                continue
            key = (pcs.metadata.namespace, pcs.metadata.name)
            METRICS.set(
                f"pcs_disrupted_gangs/{key[0]}/{key[1]}",
                self.voluntarily_disrupted_gangs(key),
            )
