"""GL021 federation-state encapsulation (docs/federation.md
"Router state").

The FederationRouter (federation/router.py) owns every cross-cluster
fact: the region registry, the placement map, the pristine PCS/Queue
templates, and the vt-stamped decision ledger. The correctness story —
placements always point at a Ready cluster that actually holds the
objects, the ledger replays every move, spillover is PCS-whole, the
level-3 quota fold sums exactly the Ready clusters — assumes only the
router mutates that state. A controller (or test helper) that pokes
``router._placements`` or ``router._clusters`` directly can record a
placement no store backs (a gang "placed" in a dead region), or strand
a template so a crash re-route has nothing to re-apply: the chaos
invariants would catch it ticks later with the causing write long gone.

Flagged outside ``grove_tpu_torch/federation/``: any WRITE (assignment,
augmented assignment, delete, or mutating call) to router-private state
reached through a federation-named binding — ``router._clusters``,
``fed._placements``, ``federation._decisions`` …

The sanctioned mutations are the router's own verbs: ``apply`` /
``delete`` / ``crash_cluster`` / ``rejoin_cluster`` (each records its
decision), and the read side is ``placements()`` / ``decisions()`` /
``status()`` — copies, safe to hold.
"""

from __future__ import annotations

import ast
from typing import Iterable

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk

# FederationRouter private fields (federation/router.py)
_ROUTER_PRIVATE = {
    "_clusters",
    "_specs",
    "_placements",
    "_queues",
    "_decisions",
}
# lifetime counters: readable anywhere (the bench "federation" block /
# GET /federation), writable only by the owning package
_ROUTER_COUNTERS = {
    "spillovers",
    "reroutes",
}

_MUTATORS = {"append", "add", "clear", "pop", "popitem", "update",
             "setdefault", "extend", "remove", "discard"}


def _federation_chain(base: str) -> bool:
    """The access chain runs through a federation-named binding (so
    `sim.router._placements[k] = x` is caught via a `router` or
    `fed`/`federation` segment, not just the bare `router` name)."""
    if not base:
        return False
    return any(
        "feder" in seg.lower() or seg.lower() == "router"
        for seg in base.split(".")
    )


class FederationStateRule(Rule):
    id = "GL021"
    name = "federation-state"
    description = (
        "the FederationRouter's registry/placement/ledger state is"
        " private to grove_tpu_torch/federation/ — placements move only"
        " through the router's verbs (apply/delete/crash/rejoin), which"
        " record their decision"
    )
    paths = ("grove_tpu_torch/",)
    exclude = ("grove_tpu_torch/federation/",)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        for node in walk(ctx.tree):
            for name, base, lineno, col in self._written_attrs(node):
                if not _federation_chain(base):
                    continue
                if name in _ROUTER_PRIVATE:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=lineno,
                        col=col,
                        message=(
                            f"federation router state `{base}.{name}`"
                            " mutated outside grove_tpu_torch/federation/ —"
                            " placements and the decision ledger must"
                            " stay coherent with the per-cluster stores;"
                            " go through the router's verbs (GL021)"
                        ),
                    )
                elif name in _ROUTER_COUNTERS:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=lineno,
                        col=col,
                        message=(
                            f"federation counter `{base}.{name}` written"
                            " outside grove_tpu_torch/federation/ — the"
                            " counters are the bench's ledger (read via"
                            " FederationRouter.status()) (GL021)"
                        ),
                    )

    @staticmethod
    def _written_attrs(node):
        """Every (attr, base, line, col) that `node` WRITES: assignment /
        augmented assignment / delete targets (tuple unpacking included),
        or a mutating method call on the attribute
        (`router._placements.clear()`)."""
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
