"""GL017 timeseries-state (docs/observability.md "SLO observatory").

The SLO observatory's honesty claims are invariants over private state,
exactly like the glass-box layer's (GL015):

- the windowed reducers are pinned bit-equal to a NumPy oracle — but
  only while ring cells are written through ``TIMESERIES.gauge()`` /
  ``.observe()`` and the sampling round; a foreign writer poking
  ``_series``/``_stamps``/``_values``/``_buckets`` can fabricate history
  the oracle never saw;
- an objective's attainment/budget/burn arithmetic and its edge-triggered
  breach state live in ``SLO._state`` — out-of-band writes could silence
  a breach (or fabricate a recovery) without any ``SloBreach`` event or
  flight bundle ever firing.

Flagged outside ``observability/timeseries.py`` + ``observability/
slo.py``: any WRITE (assignment, augmented assignment, delete, or
mutating call) to observatory private state reached through an
observatory-named binding (``TIMESERIES``, ``SLO``, anything
timeseries/sloengine-named), plus direct ``enabled`` writes (arming goes
through ``enable()``/``disable()``).

Second tooth: **Slo*-family event reasons must be registered.** The SLO
engine's alert surface is only auditable if every ``Slo``-prefixed
reason literal anywhere in the tree is a member of
``observability/events.py``'s ``REGISTERED_REASONS`` — GL006 catches
unregistered reasons at ``record()`` call sites; this closes the gap for
reason strings built or compared AWAY from the call site (breach
classifiers, dashboards, the flight-recorder trigger tag).
"""

from __future__ import annotations

import ast
from typing import Iterable, Set

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk

# private ring/window/objective state across timeseries.py / slo.py
_OBS_PRIVATE = {
    "_series",
    "_collectors",
    "_tracked",
    "_stamps",
    "_values",
    "_counts",
    "_totals",
    "_maxes",
    "_buckets",
    "_state",
    "_now",
}
_OBS_FLAGS = {"enabled"}

# binding names that identify the observatory singletons/instances
_OBS_NAMES = ("timeseries", "sloengine", "slo_engine")

_MUTATORS = {"append", "add", "clear", "pop", "popitem", "update",
             "setdefault", "extend", "remove", "discard"}


def _obs_chain(base: str) -> bool:
    """The access chain runs through an observatory-named binding
    (``TIMESERIES._series``, ``self.slo._state``, ``eng.timeseries._now``).
    ``slo`` must match as a whole segment — substring matching would drag
    in every ``slot``-named local."""
    if not base:
        return False
    for seg in base.split("."):
        low = seg.lower()
        if low == "slo" or any(n in low for n in _OBS_NAMES):
            return True
    return False


class TimeSeriesStateRule(Rule):
    id = "GL017"
    name = "timeseries-state"
    description = (
        "SLO-observatory ring/window/objective state is private to"
        " observability/timeseries.py + slo.py — feed through gauge()/"
        "observe()/sample(), judge through SloEngine.add()/evaluate(),"
        " arm through enable()/disable(); Slo*-family event reasons must"
        " be registered in observability/events.py"
    )
    paths = ("grove_tpu_torch/",)
    exclude = (
        "grove_tpu_torch/observability/timeseries.py",
        "grove_tpu_torch/observability/slo.py",
    )

    @staticmethod
    def _registered_reasons() -> Set[str]:
        """Registered reason values, lazily imported (the GL006 pattern —
        observability/events.py is torch-free and cheap)."""
        from grove_tpu_torch.observability import events

        return {
            v
            for k, v in vars(events).items()
            if k.startswith("REASON_") and isinstance(v, str)
        }

    @staticmethod
    def _is_slo_reason_literal(node) -> bool:
        return (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and node.value.startswith("Slo")
            and node.value[3:4].isupper()
            and node.value.isalnum()
        )

    def _reason_literals(self, node):
        """Slo*-shaped literals in REASON POSITIONS: arguments of
        record()/trigger()-named calls, and operands compared against a
        ``reason``-named binding (``ev.reason == "SloBreach"``). Class
        names, wire kinds, and prose stay out of scope."""
        if isinstance(node, ast.Call) and isinstance(
            node.func, (ast.Attribute, ast.Name)
        ):
            fname = (
                node.func.attr
                if isinstance(node.func, ast.Attribute)
                else node.func.id
            ).lower()
            if "record" in fname or "trigger" in fname:
                for arg in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    if self._is_slo_reason_literal(arg):
                        yield arg
        elif isinstance(node, ast.Compare):
            operands = [node.left] + list(node.comparators)
            if any(
                isinstance(op, (ast.Attribute, ast.Name))
                and dotted(op).split(".")[-1].lower() == "reason"
                for op in operands
            ):
                for op in operands:
                    if self._is_slo_reason_literal(op):
                        yield op

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        registered = self._registered_reasons()
        for node in walk(ctx.tree):
            # tooth 2: Slo*-family reason literals must be registered
            for lit in self._reason_literals(node):
                if lit.value in registered:
                    continue
                yield Violation(
                    rule=self.id,
                    path=ctx.rel,
                    line=lit.lineno,
                    col=lit.col_offset,
                    message=(
                        f"Slo-family reason literal {lit.value!r} is not"
                        " registered in observability/events.py"
                        " (REASON_* / REGISTERED_REASONS) — the SLO alert"
                        " surface must stay auditable end to end (GL017)"
                    ),
                )
            for name, base, lineno, col in self._written_attrs(node):
                if not _obs_chain(base):
                    continue
                if name in _OBS_PRIVATE:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=lineno,
                        col=col,
                        message=(
                            f"observatory private state `{base}.{name}`"
                            " mutated outside observability/"
                            "{timeseries,slo}.py — the NumPy-oracle"
                            " reducer pin and the breach state machine"
                            " assume only the owning modules write it;"
                            " use gauge()/observe()/sample()/add()/"
                            "evaluate() (GL017)"
                        ),
                    )
                elif name in _OBS_FLAGS:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=lineno,
                        col=col,
                        message=(
                            f"`{base}.{name}` assigned directly — arm the"
                            " SLO observatory via enable()/disable() so"
                            " clock/capacity wiring stays consistent"
                            " (GL017)"
                        ),
                    )

    @staticmethod
    def _written_attrs(node):
        """Every (attr, base, line, col) that `node` WRITES — the GL015
        extraction: assignment / augmented assignment / delete targets
        (tuple unpacking and subscripts included), or a mutating method
        call on the attribute (``TIMESERIES._series.clear()``)."""
        targets = ()
        if isinstance(node, (ast.Assign, ast.Delete)):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = (node.target,)
        for t in targets:
            elts = (
                t.elts if isinstance(t, (ast.Tuple, ast.List)) else (t,)
            )
            for elt in elts:
                inner = elt
                while isinstance(inner, ast.Subscript):
                    inner = inner.value
                if isinstance(inner, ast.Attribute):
                    yield (
                        inner.attr, dotted(inner.value), inner.lineno,
                        inner.col_offset,
                    )
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _MUTATORS
            and isinstance(node.func.value, ast.Attribute)
        ):
            owner = node.func.value
            yield (
                owner.attr, dotted(owner.value), owner.lineno,
                owner.col_offset,
            )
