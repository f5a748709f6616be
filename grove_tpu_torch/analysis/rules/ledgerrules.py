"""GL019 act-must-log (docs/observability.md "Remediation & ledger").

The remediation controller's auditability claim is structural: EVERY call
that changes the cluster — a broker ``grant``, a ``request_drain``, an
autoscaler ``scale_target`` — must be accounted for in the causal
decision→effect ledger, in the SAME function that makes the call. A
remediation path that acts without an in-function ``LEDGER.record(...)``
is a silent actuator: the ledger would show a clean run while the broker
log shows grants, and the decision→effect chain breaks exactly where it
matters (what did the controller believe when it acted?).

First tooth — **act-must-log**, scoped to ``controller/remediate.py``:
any function body containing an act call (attribute call named ``grant``
/ ``request_drain`` / ``scale_target``) must also contain a ``record``
call through a ledger-named binding. Same-function, not same-module: a
helper that acts while its caller logs can drift apart under refactors.

Second tooth — **ledger/forecast internals are private to their owning
modules** (the GL015/GL017 state-privacy pattern): outside
``observability/ledger.py`` + ``observability/forecast.py``, any WRITE
(assignment, augmented assignment, delete, or mutating call) to private
state reached through a ledger/forecast-named binding (``LEDGER._seq``,
``FORECASTER._watched``), plus direct ``enabled`` writes — arming goes
through ``enable()``/``disable()``, and the entry ring's bounded/
vt-ordered invariants assume only ``record()``/``effect()`` write it.
"""

from __future__ import annotations

import ast
from typing import Iterable

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk

# the module the act-must-log tooth polices (the only module allowed to
# originate remediation actions; everything it does must hit the ledger)
_ACT_MODULE = "grove_tpu_torch/controller/remediate.py"

# attribute-call names that change the cluster: broker budget grants,
# voluntary drains, autoscaler scale writes
_ACT_ATTRS = {"grant", "request_drain", "scale_target"}

# private ring/model state across ledger.py / forecast.py
_LEDGER_PRIVATE = {
    "_entries",
    "_seq",
    "_lock",
    "_watched",
    "_vt",
    "_now",
}
_LEDGER_FLAGS = {"enabled"}

_MUTATORS = {"append", "add", "clear", "pop", "popitem", "update",
             "setdefault", "extend", "remove", "discard"}


def _ledger_chain(base: str) -> bool:
    """The access chain runs through a ledger/forecast-named binding
    (``LEDGER._seq``, ``self.forecaster._watched``)."""
    if not base:
        return False
    for seg in base.split("."):
        low = seg.lower()
        if "ledger" in low or "forecast" in low:
            return True
    return False


class ActMustLogRule(Rule):
    id = "GL019"
    name = "act-must-log"
    description = (
        "remediation act calls (broker grant / request_drain /"
        " scale_target) in controller/remediate.py must write their"
        " causal chain via LEDGER.record() in the same function;"
        " ledger/forecast internals are private to observability/"
        "{ledger,forecast}.py"
    )
    paths = ("grove_tpu_torch/",)
    exclude = (
        "grove_tpu_torch/observability/ledger.py",
        "grove_tpu_torch/observability/forecast.py",
    )

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        if ctx.rel == _ACT_MODULE:
            yield from self._check_act_must_log(ctx)
        for node in walk(ctx.tree):
            for name, base, lineno, col in self._written_attrs(node):
                if not _ledger_chain(base):
                    continue
                if name in _LEDGER_PRIVATE:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=lineno,
                        col=col,
                        message=(
                            f"ledger/forecast private state `{base}.{name}`"
                            " mutated outside observability/"
                            "{ledger,forecast}.py — the bounded vt-ordered"
                            " entry ring and the fitted-model state assume"
                            " only the owning modules write them; use"
                            " record()/effect()/forecast() (GL019)"
                        ),
                    )
                elif name in _LEDGER_FLAGS:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=lineno,
                        col=col,
                        message=(
                            f"`{base}.{name}` assigned directly — arm the"
                            " ledger/forecaster via enable()/disable() so"
                            " clock/capacity wiring stays consistent"
                            " (GL019)"
                        ),
                    )

    # -- tooth 1: act calls must log, per function -----------------------

    def _check_act_must_log(self, ctx: FileContext) -> Iterable[Violation]:
        for fn in walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            acts = []
            logs = False
            for node in walk(fn):
                # nested defs belong to themselves (ast.walk visits them
                # as their own FunctionDef nodes)
                if node is not fn and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                ):
                    continue
                if node.func.attr in _ACT_ATTRS:
                    acts.append(node)
                elif node.func.attr == "record" and _ledger_chain(
                    dotted(node.func.value)
                ):
                    logs = True
            if not logs:
                for call in acts:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=call.lineno,
                        col=call.col_offset,
                        message=(
                            f"remediation act `{dotted(call.func)}()` in"
                            f" `{fn.name}` has no in-function ledger write"
                            " — every act call must record its causal"
                            " chain via LEDGER.record() in the same"
                            " function (GL019 act-must-log)"
                        ),
                    )

    # -- write extraction (the GL015/GL017 pattern) ----------------------

    @staticmethod
    def _written_attrs(node):
        """Every (attr, base, line, col) that `node` WRITES: assignment /
        augmented assignment / delete targets (tuple unpacking and
        subscripts included), or a mutating method call on the attribute
        (``LEDGER._entries.clear()``)."""
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
