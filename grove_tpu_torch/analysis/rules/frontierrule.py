"""GL014 frontier-partition-state encapsulation (docs/solver.md
"Partitioned frontier").

The partitioned solver frontier (solver/frontier.py) keys everything on
its partition plan: the frontier level, the super-domain slab table, the
per-slab sub-encoding cache, and the per-solve assignment scratch. The
correctness story — subproblems are node-DISJOINT, the composite equals
the sequential per-subproblem reference bit-for-bit, degenerate ticks
bypass byte-identically — assumes only frontier.py derives and mutates
that state from the delta state's NodeEncoding. A controller (or test
helper) that pokes ``frontier._plan`` or the sub-encoding cache directly
can leave the plan describing a node set the encoding no longer matches:
the next solve would compose allocations onto the WRONG global node
columns, which binds pods to nodes the solver never chose.

Flagged outside ``grove_tpu_torch/solver/frontier.py``: any WRITE (assignment,
augmented assignment, delete, or mutating call) to frontier-private state
reached through a frontier-named binding — ``frontier._plan``,
``frontier._plan_enc``, ``plan._sub_encodings`` — plus writes to the
public counters (they are the bench's ledger, owned by the module).

The sanctioned out-of-band hook is :meth:`FrontierState.invalidate`
(mirrors GL012's registration API for the delta state).
"""

from __future__ import annotations

import ast
from typing import Iterable

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk

# FrontierState / FrontierPlan private fields (solver/frontier.py)
_FRONTIER_PRIVATE = {
    "_plan",
    "_plan_enc",
    "_sub_encodings",
}
# FrontierPlan's own fields: writable only by the owning module, even
# when reached through the chain (`frontier._plan.starts = ...`)
_PLAN_FIELDS = {
    "level",
    "starts",
    "ends",
    "num_partitions",
}
# lifetime counters: readable anywhere (the bench ledger), writable only
# by the owning module
_FRONTIER_COUNTERS = {
    "solves",
    "degenerate",
    "subproblems_total",
    "assigned_total",
    "residual_total",
    "dispatches_total",
    "last_subproblems",
    "last_residual_fraction",
    "last_overlap_occupancy",
    "selfcheck_seconds",
}

_MUTATORS = {"append", "add", "clear", "pop", "popitem", "update",
             "setdefault", "extend", "remove", "discard"}


def _frontier_chain(base: str) -> bool:
    """The access chain runs through a frontier-named binding (so
    `sched.frontier._plan.starts = x` is caught, not just
    `frontier.starts = x`)."""
    if not base:
        return False
    return any("frontier" in seg.lower() for seg in base.split("."))


def _plan_binding(base: str) -> bool:
    """The binding itself is a plan object (`plan = frontier.plan_for(...)`
    idiom). Only the LEAF is consulted — a bare `plan` segment deeper in
    an unrelated chain must not drag foreign `.starts`/`.level` writes
    into this rule."""
    leaf = base.split(".")[-1].lower() if base else ""
    return leaf in ("plan", "_plan")


class FrontierStateRule(Rule):
    id = "GL014"
    name = "frontier-partition-state"
    description = (
        "the partitioned frontier's plan/sub-encoding/counter state is"
        " private to solver/frontier.py — out-of-band invalidation goes"
        " through FrontierState.invalidate()"
    )
    paths = ("grove_tpu_torch/",)
    exclude = ("grove_tpu_torch/solver/frontier.py",)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        for node in walk(ctx.tree):
            for name, base, lineno, col in self._written_attrs(node):
                # frontier-private names match through any frontier chain
                # or a plan-typed binding; the GENERIC plan-field names
                # (starts/ends/level) require the frontier chain — a bare
                # `plan` segment elsewhere must not drag foreign writes in
                if (
                    name in _FRONTIER_PRIVATE
                    and (_frontier_chain(base) or _plan_binding(base))
                ) or (name in _PLAN_FIELDS and _frontier_chain(base)):
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=lineno,
                        col=col,
                        message=(
                            f"frontier partition state `{base}.{name}`"
                            " mutated outside solver/frontier.py — the"
                            " plan must stay coherent with the delta"
                            " state's NodeEncoding; call"
                            " frontier.invalidate() instead (GL014)"
                        ),
                    )
                elif name in _FRONTIER_COUNTERS and _frontier_chain(base):
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=lineno,
                        col=col,
                        message=(
                            f"frontier counter `{base}.{name}` written"
                            " outside solver/frontier.py — the counters"
                            " are the bench's ledger (read via"
                            " FrontierState.stats()) (GL014)"
                        ),
                    )

    @staticmethod
    def _written_attrs(node):
        """Every (attr, base, line, col) that `node` WRITES: assignment /
        augmented assignment / delete targets (tuple unpacking included),
        or a mutating method call on the attribute
        (`x._sub_encodings.clear()`)."""
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
