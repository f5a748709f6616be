"""Reconcile-flow DSL.

Counterpart of ``grove_tpu/runtime/flow.py``.

Re-host of reference operator/internal/controller/common/flow.go:33-116:
reconcile functions are pipelines of steps, each returning a
ReconcileStepResult that either continues the flow or short-circuits it with a
requeue decision.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from grove_tpu_torch.runtime.errors import GroveError


@dataclass
class ReconcileStepResult:
    result: str  # "continue" | "done" | "requeue" | "requeue_after"
    requeue_after: Optional[float] = None
    errors: List[GroveError] = field(default_factory=list)
    description: str = ""

    def has_errors(self) -> bool:
        return bool(self.errors)

    def short_circuits(self) -> bool:
        """ShortCircuitReconcileFlow (flow.go:96-102)."""
        return self.result != "continue"


def continue_reconcile() -> ReconcileStepResult:
    return ReconcileStepResult(result="continue")


def do_not_requeue() -> ReconcileStepResult:
    return ReconcileStepResult(result="done")


def reconcile_with_errors(description: str, *errors: GroveError) -> ReconcileStepResult:
    return ReconcileStepResult(
        result="requeue", errors=list(errors), description=description
    )


def reconcile_after(delay: float, description: str = "") -> ReconcileStepResult:
    return ReconcileStepResult(
        result="requeue_after", requeue_after=delay, description=description
    )


def run_steps(
    steps: Sequence[Callable[[], ReconcileStepResult]],
) -> ReconcileStepResult:
    """Run steps in order; the first short-circuiting result wins
    (reconciler.go:61-79 pattern)."""
    for step in steps:
        result = step()
        if result.short_circuits():
            return result
    return continue_reconcile()
