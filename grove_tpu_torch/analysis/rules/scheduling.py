"""GL002 broker-gated eviction + GL003 schedulable-mask discipline.

The two scheduling invariants that the delta-solve and sharded-kernel
paths must not silently lose:

- **GL002**: every VOLUNTARY gang eviction flows through a
  DisruptionBroker grant. The eviction primitives (`_evict_victim`,
  `_evict_gang_whole`) may only be called from a function that also
  obtains a grant (`broker.grant(...)` / `_disruption_granted(...)`), or
  from the involuntary triage path (controller/nodehealth.py) and the
  disruption package itself.

- **GL003**: every node set fed to the solver (`_solve_batch` /
  `build_problem`) is masked through `Node.schedulable` (or its
  complement `unschedulable_names()`). A function that reads a raw
  `.nodes` list and solves must show the mask; functions receiving an
  already-masked node list (no raw `.nodes` read) pass — the mask is
  checked where the raw list is consumed.
"""

from __future__ import annotations

import ast
from typing import Iterable

from grove_tpu_torch.analysis.engine import (
    FileContext,
    Rule,
    Violation,
    call_name,
    dotted,
    walk,
)

_EVICTORS = {
    "_evict_victim",  # preemption / quota reclaim (solver/scheduler.py)
    "_evict_gang_whole",  # node drain (disruption/drain.py)
    "terminate_gang",  # generic gang teardown entry points
    "_push_template_to_replica",  # rolling update's replica disruptor
}
_GRANTS = {"grant", "_disruption_granted"}

_SOLVE_TRIGGERS = {"_solve_batch", "build_problem"}
_MASKS = {"schedulable", "unschedulable_names"}


class BrokerGrantRule(Rule):
    id = "GL002"
    name = "broker-grant"
    description = (
        "voluntary gang evictions must hold a DisruptionBroker grant:"
        " eviction primitives outside disruption/ require a grant in the"
        " same function"
    )
    paths = ("grove_tpu_torch/",)
    exclude = (
        "grove_tpu_torch/disruption/",  # the broker/drainer own the primitives
        "grove_tpu_torch/controller/nodehealth.py",  # involuntary triage path
    )

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        for fn in ctx.functions():
            if fn.name in _EVICTORS:
                continue  # the primitive's own definition is the boundary
            has_grant = any(
                isinstance(n, ast.Call) and call_name(n) in _GRANTS
                for n in walk(fn)
            )
            if has_grant:
                continue
            for node in walk(fn):
                if isinstance(node, ast.Call) and call_name(node) in _EVICTORS:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"`{call_name(node)}()` called in"
                            f" `{fn.name}()` without a DisruptionBroker"
                            " grant — voluntary evictions must clear"
                            " broker.grant(victims, source) first"
                        ),
                    )


class SchedulableMaskRule(Rule):
    id = "GL003"
    name = "schedulable-mask"
    description = (
        "node sets fed to the solver must be masked via Node.schedulable"
        " (cordoned/NotReady/Lost nodes may never enter the dense tensors)"
    )
    paths = ("grove_tpu_torch/",)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        for fn in ctx.functions():
            if fn.name in _SOLVE_TRIGGERS:
                continue  # the solver boundary itself takes a masked list
            trigger_calls = [
                n
                for n in walk(fn)
                if isinstance(n, ast.Call) and call_name(n) in _SOLVE_TRIGGERS
            ]
            if not trigger_calls:
                continue
            reads_raw_nodes = any(
                isinstance(n, ast.Attribute) and n.attr == "nodes"
                # `problem.nodes` etc. on solver outputs is not a raw read
                and not dotted(n).startswith(("problem", "result"))
                for n in walk(fn)
            )
            if not reads_raw_nodes:
                continue  # caller hands in a pre-masked node list
            masked = any(
                (isinstance(n, ast.Attribute) and n.attr in _MASKS)
                or (isinstance(n, ast.Name) and n.id in _MASKS)
                for n in walk(fn)
            )
            if masked:
                continue
            for call in trigger_calls:
                yield Violation(
                    rule=self.id,
                    path=ctx.rel,
                    line=call.lineno,
                    col=call.col_offset,
                    message=(
                        f"`{call_name(call)}()` in `{fn.name}()` consumes a"
                        " raw `.nodes` list without a `Node.schedulable`"
                        " mask (or `unschedulable_names()`) — unhealthy/"
                        "cordoned nodes would enter the solve"
                    ),
                )
