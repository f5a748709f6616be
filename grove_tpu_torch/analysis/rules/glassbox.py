"""GL015 glass-box state encapsulation (docs/observability.md).

The glass-box layer's honesty claims are invariants over PRIVATE state:

- the profiler's coverage arithmetic (self-times sum to outer wall)
  holds only if phases are opened/closed through ``PROFILER.phase()`` /
  ``.reconcile()`` — a call site that pokes ``PROFILER._hist`` or the
  per-thread ``_tls`` stack can make "coverage ≥ 95%" a lie;
- a journey's gap-free causal chain holds only if marks flow through the
  ``JOURNEYS.note_*`` API — writing ``_active``/``_done``/``_round``
  directly can fabricate or corrupt admission decompositions;
- the flight recorder's rings are evidence; out-of-band writes to
  ``_rings``/``_events``/``_errors`` would tamper with postmortems.

Flagged outside ``grove_tpu_torch/observability/``: any WRITE (assignment,
augmented assignment, delete, or mutating call) to glass-box private
state reached through a glass-box-named binding (``PROFILER``,
``JOURNEYS``, ``FLIGHTREC``, or anything profiler/journey/flightrec-
named), plus direct writes to their ``enabled`` flags — arming goes
through ``enable()``/``disable()`` so sinks/hooks are installed and
removed consistently.
"""

from __future__ import annotations

import ast
from typing import Iterable

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk

# private recording state across profile.py / journey.py / flightrec.py
_GLASS_PRIVATE = {
    "_hist",
    "_tls",
    "_toplevel_s",
    "_active",
    "_done",
    "_round",
    "_rings",
    "_events",
    "_errors",
    "_dump_seq",
    "_origin",
}
# arming must go through enable()/disable() (they install/remove the
# tracer FLIGHT_SINK and event-recorder sink atomically with the flag)
_GLASS_FLAGS = {"enabled"}

_GLASS_NAMES = ("profiler", "journey", "flightrec")

_MUTATORS = {"append", "add", "clear", "pop", "popitem", "update",
             "setdefault", "extend", "remove", "discard"}


def _glass_chain(base: str) -> bool:
    """The access chain runs through a glass-box-named binding
    (`PROFILER._hist`, `self.journeys._active`, `rec.flightrec._rings`)."""
    if not base:
        return False
    return any(
        any(g in seg.lower() for g in _GLASS_NAMES)
        for seg in base.split(".")
    )


class GlassBoxStateRule(Rule):
    id = "GL015"
    name = "glassbox-state"
    description = (
        "profiler/journey/flight-recorder recording state is private to"
        " grove_tpu_torch/observability/ — instrument through phase()/note_*()/"
        "trigger(), arm through enable()/disable()"
    )
    paths = ("grove_tpu_torch/",)
    exclude = (
        "grove_tpu_torch/observability/profile.py",
        "grove_tpu_torch/observability/journey.py",
        "grove_tpu_torch/observability/flightrec.py",
    )

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        for node in walk(ctx.tree):
            for name, base, lineno, col in self._written_attrs(node):
                if not _glass_chain(base):
                    continue
                if name in _GLASS_PRIVATE:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=lineno,
                        col=col,
                        message=(
                            f"glass-box private state `{base}.{name}`"
                            " mutated outside grove_tpu_torch/observability/ —"
                            " the coverage/journey/postmortem invariants"
                            " assume only the owning module writes it;"
                            " use the phase()/note_*()/trigger() API"
                            " (GL015)"
                        ),
                    )
                elif name in _GLASS_FLAGS:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=lineno,
                        col=col,
                        message=(
                            f"`{base}.{name}` assigned directly — arm the"
                            " glass-box layer via enable()/disable() so"
                            " its tracer/event sinks install and remove"
                            " with the flag (GL015)"
                        ),
                    )

    @staticmethod
    def _written_attrs(node):
        """Every (attr, base, line, col) that `node` WRITES: assignment /
        augmented assignment / delete targets (tuple unpacking included),
        or a mutating method call on the attribute
        (`PROFILER._hist.clear()`)."""
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
