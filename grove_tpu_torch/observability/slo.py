"""Declarative SLO layer: objectives, error budgets, burn-rate alerts.

Counterpart of ``grove_tpu/observability/slo.py``. An :class:`SloSpec`
names an objective over one time series, in the grammar

    <series> [:reducer] <op> <threshold>[unit] over <window> \
        [target <pct>] [budget <window>] [burn <factor>x <fast>/<slow>]

Each ``SLO.evaluate(now)`` (a round boundary) reduces the series over
``window`` into one good/bad verdict a tick, recorded back as the series
``slo:<name>:good``; attainment is its mean over ``budget``, the error
budget ``1 - target`` of it, and the burn rate over a window is its bad
fraction over ``1 - target``. ``SloBurnRateHigh`` fires when the fast and
the slow window both burn past the factor; ``SloBreach`` (edge-triggered,
with a flight-recorder bundle) when attainment drops below target, and
``SloRecovered`` when it comes back. ``status()`` is the ``/debug/slo``
document; the gauges ``slo_attainment/<name>``, ``slo_burn_rate/<name>``
and ``slo_budget_remaining/<name>`` reach the Prometheus text. Off by
default (``GROVE_TPU_SLO=1`` or ``SLO.enable()``).
"""

from __future__ import annotations

import os
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.timeseries import TIMESERIES

_OPS = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
}

_REDUCERS = ("p50", "p99", "mean", "max", "min", "rate", "last")

_DUR_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h|d)?$")
_DUR_UNITS = {"ms": 1e-3, None: 1.0, "s": 1.0, "m": 60.0, "h": 3600.0,
              "d": 86400.0}

_SPEC_RE = re.compile(
    r"^\s*(?P<series>[A-Za-z0-9_:/.@-]+?)"
    r"(?::(?P<reducer>p50|p99|mean|max|min|rate|last))?"
    r"\s*(?P<op><=|>=|<|>)\s*"
    r"(?P<threshold>\d+(?:\.\d+)?)(?P<unit>ms|s|m|h|d)?"
    r"\s+over\s+(?P<window>\S+)"
    r"(?:\s+target\s+(?P<target>\d+(?:\.\d+)?)%)?"
    r"(?:\s+budget\s+(?P<budget>\S+))?"
    r"(?:\s+burn\s+(?P<burn>\d+(?:\.\d+)?)x\s+"
    r"(?P<fast>\S+)/(?P<slow>\S+))?\s*$"
)


def parse_duration(text: str) -> float:
    m = _DUR_RE.match(text.strip())
    if m is None:
        raise ValueError(f"unparseable duration {text!r} (want e.g. 30s, 5m)")
    return float(m.group(1)) * _DUR_UNITS[m.group(2)]


@dataclass
class SloSpec:
    """One objective. ``series``/``reducer``/``op``/``threshold`` define
    the per-tick indicator; ``window`` the indicator's reduction window;
    ``target`` the attainment objective over the ``budget`` compliance
    window; the burn windows/factor drive the multi-window alert."""

    name: str
    series: str
    op: str
    threshold: float
    window: float  # indicator reduction window, seconds
    reducer: Optional[str] = None  # None -> 'last' for gauges, 'p99' dists
    target: float = 0.99
    budget: Optional[float] = None  # compliance window; default 6x window
    burn_factor: float = 6.0
    fast_window: Optional[float] = None  # default: window
    slow_window: Optional[float] = None  # default: budget

    def __post_init__(self) -> None:
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")
        if self.budget is None:
            self.budget = 6.0 * self.window
        if self.fast_window is None:
            self.fast_window = self.window
        if self.slow_window is None:
            self.slow_window = self.budget
        if self.reducer is not None and self.reducer not in _REDUCERS:
            raise ValueError(f"unknown reducer {self.reducer!r}")

    @classmethod
    def parse(cls, text: str, name: Optional[str] = None) -> "SloSpec":
        m = _SPEC_RE.match(text)
        if m is None:
            raise ValueError(
                f"unparseable SLO spec {text!r} — grammar: '<series>"
                "[:reducer] <op> <threshold>[unit] over <window>"
                " [target <pct>] [budget <window>]"
                " [burn <factor>x <fast>/<slow>]'"
            )
        g = m.groupdict()
        threshold = float(g["threshold"]) * _DUR_UNITS[g["unit"]]
        kwargs = dict(
            name=name or g["series"].replace("/", "_").replace(":", "_"),
            series=g["series"],
            reducer=g["reducer"],
            op=g["op"],
            threshold=threshold,
            window=parse_duration(g["window"]),
        )
        if g["target"]:
            kwargs["target"] = float(g["target"]) / 100.0
        if g["budget"]:
            kwargs["budget"] = parse_duration(g["budget"])
        if g["burn"]:
            kwargs["burn_factor"] = float(g["burn"])
            kwargs["fast_window"] = parse_duration(g["fast"])
            kwargs["slow_window"] = parse_duration(g["slow"])
        return cls(**kwargs)

    def render(self) -> str:
        red = f":{self.reducer}" if self.reducer else ""
        return (
            f"{self.series}{red} {self.op} {self.threshold:g} over"
            f" {self.window:g}s target {self.target * 100:g}% budget"
            f" {self.budget:g}s burn {self.burn_factor:g}x"
            f" {self.fast_window:g}s/{self.slow_window:g}s"
        )


class _ObjectiveState:
    __slots__ = ("spec", "breached", "burning", "evaluations", "good",
                 "bad", "last_value", "last_attainment", "last_burn_fast",
                 "last_burn_slow", "breaches", "recoveries", "last_tick",
                 "config_error")

    def __init__(self, spec: SloSpec) -> None:
        self.spec = spec
        self.breached = False
        self.burning = False
        self.evaluations = 0
        self.good = 0
        self.bad = 0
        self.last_value: Optional[float] = None
        self.last_attainment: Optional[float] = None
        self.last_burn_fast = 0.0
        self.last_burn_slow = 0.0
        self.breaches = 0
        self.recoveries = 0
        self.last_tick = -1  # one verdict per virtual tick (idempotent)
        self.config_error = False  # reducer/series-kind mismatch


class SloEngine:
    """Process-global (``SLO``), thread-safe. Evaluation runs at tick
    boundaries behind one boolean check; nothing here is on a hot path."""

    def __init__(self) -> None:
        self.enabled = os.environ.get("GROVE_TPU_SLO", "") not in (
            "",
            "0",
            "false",
        )
        self._lock = threading.Lock()
        self._state: Dict[str, _ObjectiveState] = {}

    # -- lifecycle -------------------------------------------------------

    def enable(self) -> "SloEngine":
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._state = {}

    # -- spec management -------------------------------------------------

    def add(self, spec) -> SloSpec:
        """Register an objective (an :class:`SloSpec`, or grammar text)."""
        if isinstance(spec, str):
            spec = SloSpec.parse(spec)
        with self._lock:
            if spec.name in self._state:
                raise ValueError(f"objective {spec.name!r} already defined")
            self._state[spec.name] = _ObjectiveState(spec)
        return spec

    def specs(self) -> List[SloSpec]:
        with self._lock:
            return [st.spec for st in self._state.values()]

    # -- evaluation ------------------------------------------------------

    def _indicator(self, st: _ObjectiveState, now: float) -> Optional[float]:
        """The objective's current indicator value, or None when the
        window holds no data. A window WITH data but without the spec'd
        reducer (``rate`` on a gauge, ``min``/``last`` on a distribution)
        is a spec/series-kind mismatch — flagged as ``config_error`` so
        the status surface distinguishes it from genuinely absent data
        (a silently never-evaluating objective alerts no one)."""
        spec = st.spec
        doc = TIMESERIES.window(spec.series, spec.window, now=now)
        if doc.get("n", 0) == 0 and doc.get("count", 0) == 0:
            return None
        reducer = spec.reducer
        if reducer is None:
            reducer = "p99" if doc.get("kind") == "dist" else "last"
        value = doc.get(reducer)
        st.config_error = value is None
        return value

    def _good_fraction(
        self, name: str, seconds: float, now: float
    ) -> Optional[float]:
        doc = TIMESERIES.window(f"slo:{name}:good", seconds, now=now)
        if doc.get("n", 0) == 0:
            return None
        return doc["mean"]

    def evaluate(self, now: float) -> None:
        """One evaluation round over every objective (tick boundary)."""
        if not self.enabled:
            return
        tick = TIMESERIES.tick_of(now)
        with self._lock:
            states = list(self._state.values())
        for st in states:
            spec = st.spec
            # one verdict per virtual tick: a second evaluation in the
            # same tick (the scenario's guaranteed post-converge round
            # landing on a tick the converge loop already judged) must
            # not double-count good/bad
            if st.last_tick == tick:
                continue
            value = self._indicator(st, now)
            if value is None:
                continue  # no data in the window: not counted either way
            st.last_tick = tick
            good = _OPS[spec.op](value, spec.threshold)
            st.last_value = value
            st.evaluations += 1
            if good:
                st.good += 1
            else:
                st.bad += 1
            TIMESERIES.gauge(
                f"slo:{spec.name}:good", 1.0 if good else 0.0, vt=now
            )
            budget_frac = 1.0 - spec.target
            att = self._good_fraction(spec.name, spec.budget, now)
            if att is None:
                continue
            st.last_attainment = att
            good_fast = self._good_fraction(spec.name, spec.fast_window, now)
            good_slow = self._good_fraction(spec.name, spec.slow_window, now)
            st.last_burn_fast = (
                (1.0 - good_fast) / budget_frac
                if good_fast is not None
                else 0.0
            )
            st.last_burn_slow = (
                (1.0 - good_slow) / budget_frac
                if good_slow is not None
                else 0.0
            )
            remaining = max(0.0, 1.0 - (1.0 - att) / budget_frac)
            METRICS.set(f"slo_attainment/{spec.name}", att)
            METRICS.set(f"slo_burn_rate/{spec.name}", st.last_burn_fast)
            METRICS.set(f"slo_budget_remaining/{spec.name}", remaining)
            self._alert(st, att, now)

    def _alert(self, st: _ObjectiveState, attainment: float, now: float) -> None:
        """Edge-triggered state machine: breach/recovery on the
        compliance-window attainment, burn-rate page on the fast AND slow
        windows both burning above the factor."""
        from grove_tpu_torch.observability.events import (
            EVENTS,
            REASON_SLO_BREACH,
            REASON_SLO_BURN_RATE_HIGH,
            REASON_SLO_RECOVERED,
            TYPE_NORMAL,
            TYPE_WARNING,
        )
        from grove_tpu_torch.observability.flightrec import FLIGHTREC

        spec = st.spec
        ref = ("SloObjective", "", spec.name)
        burning = (
            st.last_burn_fast >= spec.burn_factor
            and st.last_burn_slow >= spec.burn_factor
        )
        if burning and not st.burning:
            EVENTS.record(
                ref,
                TYPE_WARNING,
                REASON_SLO_BURN_RATE_HIGH,
                f"{spec.name}: burn {st.last_burn_fast:.1f}x over"
                f" {spec.fast_window:g}s and {st.last_burn_slow:.1f}x over"
                f" {spec.slow_window:g}s (threshold {spec.burn_factor:g}x)",
            )
            METRICS.inc("slo_burn_alerts_total")
        st.burning = burning
        if attainment < spec.target and not st.breached:
            st.breached = True
            st.breaches += 1
            METRICS.inc("slo_breaches_total")
            detail = (
                f"objective={spec.name} window={spec.budget:g}s"
                f" attainment={attainment:.4f} target={spec.target:g}"
                f" indicator={spec.render()}"
            )
            EVENTS.record(
                ref,
                TYPE_WARNING,
                REASON_SLO_BREACH,
                f"{spec.name}: attainment {attainment:.4f} <"
                f" target {spec.target:g} over {spec.budget:g}s",
            )
            if FLIGHTREC.enabled:
                # the postmortem bundle, stamped with the breaching
                # objective + window
                FLIGHTREC.trigger("SloBreach", detail)
        elif st.breached and attainment >= spec.target:
            st.breached = False
            st.recoveries += 1
            METRICS.inc("slo_recoveries_total")
            EVENTS.record(
                ref,
                TYPE_NORMAL,
                REASON_SLO_RECOVERED,
                f"{spec.name}: attainment {attainment:.4f} back above"
                f" target {spec.target:g}",
            )

    # -- read side -------------------------------------------------------

    def burning(self) -> List[dict]:
        """Objectives currently in a burn-rate alert or breached — the
        remediation controller's trigger read (engine state stays private
        to this module). Each row carries what a remediator needs
        to decide and to account: the objective name, its series, the
        alert state, and the error budget remaining."""
        with self._lock:
            states = list(self._state.values())
        out = []
        for st in states:
            if not (st.burning or st.breached):
                continue
            spec = st.spec
            att = st.last_attainment
            out.append(
                {
                    "name": spec.name,
                    "series": spec.series,
                    "breached": st.breached,
                    "burning": st.burning,
                    "burn_rate_fast": st.last_burn_fast,
                    "burn_rate_slow": st.last_burn_slow,
                    "budget_remaining": (
                        max(0.0, 1.0 - (1.0 - att) / (1.0 - spec.target))
                        if att is not None
                        else None
                    ),
                }
            )
        return out

    def budget_remaining(self, name: str) -> Optional[float]:
        """Error budget remaining for one objective (None before its
        first attainment round) — the ledger's effect-measurement read."""
        with self._lock:
            st = self._state.get(name)
            if st is None or st.last_attainment is None:
                return None
            return max(
                0.0,
                1.0 - (1.0 - st.last_attainment) / (1.0 - st.spec.target),
            )

    def status(self, series_window: float = 300.0) -> dict:
        """The ``GET /debug/slo`` document: one row per objective plus the
        series appendix (every live series reduced over one window)."""
        with self._lock:
            states = list(self._state.values())
        objectives = []
        for st in states:
            spec = st.spec
            budget_frac = 1.0 - spec.target
            att = st.last_attainment
            objectives.append(
                {
                    "name": spec.name,
                    "spec": spec.render(),
                    "series": spec.series,
                    "state": "config-error" if st.config_error else (
                        "breached" if st.breached else (
                            "burning" if st.burning else "ok"
                        )
                    ),
                    "value": st.last_value,
                    "attainment": att,
                    "budget_remaining": (
                        max(0.0, 1.0 - (1.0 - att) / budget_frac)
                        if att is not None
                        else None
                    ),
                    "burn_rate_fast": round(st.last_burn_fast, 4),
                    "burn_rate_slow": round(st.last_burn_slow, 4),
                    "evaluations": st.evaluations,
                    "good": st.good,
                    "bad": st.bad,
                    "breaches": st.breaches,
                    "recoveries": st.recoveries,
                }
            )
        return {
            "enabled": self.enabled,
            "objectives": objectives,
            "series": TIMESERIES.snapshot(series_window),
        }


SLO = SloEngine()
