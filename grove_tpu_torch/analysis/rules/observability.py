"""GL006 registered event reasons + GL007 span leak prevention.

- **GL006**: every reason string handed to the event recorder
  (`EVENTS.record(ref, type, reason, msg)` / `ctx.record_event(kind,
  reason, msg, ...)`) must be registered in `observability/events.py`
  (a `REASON_*` constant or a literal in `REGISTERED_REASONS`). The
  registry is what keeps `GET /events` filterable, dedup identity
  stable, and docs/observability.md's catalog honest (the drift test in
  tests/test_docs_drift.py pins registry ⊆ docs).

- **GL007**: a span opened via `TRACER.span(...)` must be closed — used
  as a `with` context manager, or assigned to a name whose `.end()` is
  called in the same function (the `span = TRACER.span(...) if
  TRACER.enabled else None` + `finally: span.end()` idiom). A leaked
  span corrupts the per-thread nesting stack for every span after it.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional, Set

from grove_tpu_torch.analysis.engine import (
    FileContext,
    Rule,
    Violation,
    dotted,
    event_record_reason,
    walk,
)


def _registry() -> Set[str]:
    """Registered reason values, lazily imported (a torch-free module)."""
    from grove_tpu_torch.observability import events

    values = {
        v
        for k, v in vars(events).items()
        if k.startswith("REASON_") and isinstance(v, str)
    }
    values |= set(getattr(events, "REGISTERED_REASONS", ()))
    return values


def _registered_names() -> Set[str]:
    from grove_tpu_torch.observability import events

    return {k for k in vars(events) if k.startswith("REASON_")}


class EventReasonRule(Rule):
    id = "GL006"
    name = "event-reason"
    description = (
        "every EventRecorder reason must be registered in"
        " observability/events.py (REASON_* constant or REGISTERED_REASONS)"
    )
    paths = ("grove_tpu_torch/",)
    exclude = ("grove_tpu_torch/observability/events.py",)

    def __init__(self) -> None:
        self._values = _registry()
        self._names = _registered_names()

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            reason = event_record_reason(node)
            if reason is None:
                continue  # not an event-recorder call / unrecognized shape
            msg = self._classify(reason)
            if msg is not None:
                yield Violation(
                    rule=self.id,
                    path=ctx.rel,
                    line=reason.lineno,
                    col=reason.col_offset,
                    message=msg,
                )

    def _classify(self, reason: ast.AST) -> Optional[str]:
        if isinstance(reason, ast.Constant) and isinstance(reason.value, str):
            if reason.value in self._values:
                return None
            return (
                f"event reason {reason.value!r} is not registered in"
                " observability/events.py — add a REASON_ constant or"
                " REGISTERED_REASONS entry (and the docs catalog row)"
            )
        name = (
            reason.id
            if isinstance(reason, ast.Name)
            else reason.attr
            if isinstance(reason, ast.Attribute)
            else None
        )
        if name is not None and name.startswith("REASON_"):
            if name in self._names:
                return None
            return (
                f"`{name}` is not defined in observability/events.py —"
                " register the reason before emitting it"
            )
        if name is not None:
            # a local variable holding a registered constant (e.g.
            # `event_reason` chosen between two REASON_ values) — allowed;
            # the registry is enforced where the constant is born
            return None
        return (
            "dynamic event reason expression — reasons must be registered"
            " constants (dedup identity and docs catalog depend on it)"
        )


class SpanLeakRule(Rule):
    id = "GL007"
    name = "span-leak"
    description = (
        "spans must be context-managed (`with TRACER.span(...)`) or"
        " explicitly `.end()`ed in the same function"
    )
    paths = ("grove_tpu_torch/",)
    exclude = ("grove_tpu_torch/observability/tracing.py",)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        for fn in ctx.functions():
            with_calls, assigned, ended = set(), {}, set()
            span_calls = []
            for node in walk(fn):
                if isinstance(node, ast.With):
                    for item in node.items:
                        expr = item.context_expr
                        for c in walk(expr):
                            if self._is_span_call(c):
                                with_calls.add(id(c))
                elif isinstance(node, ast.Assign):
                    for c in walk(node.value):
                        if self._is_span_call(c):
                            for tgt in node.targets:
                                if isinstance(tgt, ast.Name):
                                    assigned[id(c)] = tgt.id
                elif isinstance(node, ast.Call):
                    if self._is_span_call(node):
                        span_calls.append(node)
                    elif (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr == "end"
                        and isinstance(node.func.value, ast.Name)
                    ):
                        ended.add(node.func.value.id)
            for call in span_calls:
                if id(call) in with_calls:
                    continue
                name = assigned.get(id(call))
                if name is not None and name in ended:
                    continue
                yield Violation(
                    rule=self.id,
                    path=ctx.rel,
                    line=call.lineno,
                    col=call.col_offset,
                    message=(
                        f"span opened in `{fn.name}()` is neither"
                        " context-managed nor `.end()`ed — a leaked span"
                        " corrupts the tracer's per-thread nesting stack"
                    ),
                )

    @staticmethod
    def _is_span_call(node: ast.AST) -> bool:
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "span"
        ):
            return False
        base = dotted(node.func.value)
        return base == "TRACER" or base.lower().endswith("tracer")
