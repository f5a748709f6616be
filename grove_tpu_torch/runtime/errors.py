"""Typed error codes, GroveError, and the reconcile-flow error helpers.

Counterpart of ``grove_tpu/runtime/errors.py``. It is a class of its own: a
``GroveError`` of the JAX package is not one of these, so the two packages'
stores never mix.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

# Sentinel codes driving control flow (errors.go:40-47)
ERR_REQUEUE_AFTER = "ERR_REQUEUE_AFTER"
ERR_CONTINUE_RECONCILE_AND_REQUEUE = "ERR_CONTINUE_RECONCILE_AND_REQUEUE"

# Representative operational codes (the reference defines ~40 ERR_* constants
# across components, e.g. pod.go:46-65); new codes are free-form strings.
ERR_GET_RESOURCE = "ERR_GET_RESOURCE"
ERR_LIST_RESOURCE = "ERR_LIST_RESOURCE"
ERR_CREATE_RESOURCE = "ERR_CREATE_RESOURCE"
ERR_UPDATE_RESOURCE = "ERR_UPDATE_RESOURCE"
ERR_DELETE_RESOURCE = "ERR_DELETE_RESOURCE"
ERR_SYNC_PODS = "ERR_SYNC_PODS"
ERR_VALIDATION = "ERR_VALIDATION"
ERR_CONFLICT = "ERR_CONFLICT"
ERR_NOT_FOUND = "ERR_NOT_FOUND"
ERR_FORBIDDEN = "ERR_FORBIDDEN"
# wire client: connection-level failure (refused/reset/timeout) — the one
# code retry loops may classify as transient
ERR_TRANSPORT = "ERR_TRANSPORT"


class GroveError(Exception):
    def __init__(
        self,
        code: str,
        message: str = "",
        operation: str = "",
        cause: Optional[Exception] = None,
        requeue_after: Optional[float] = None,
    ) -> None:
        super().__init__(f"[{code}] {operation}: {message}")
        self.code = code
        self.message = message
        self.operation = operation
        self.cause = cause
        # used with ERR_REQUEUE_AFTER / ERR_CONTINUE_RECONCILE_AND_REQUEUE
        self.requeue_after = requeue_after


def requeue_after_error(delay: float, operation: str = "", message: str = "") -> GroveError:
    return GroveError(
        ERR_REQUEUE_AFTER, message or f"requeue after {delay}s", operation,
        requeue_after=delay,
    )


def continue_and_requeue_error(
    delay: float, operation: str = "", message: str = ""
) -> GroveError:
    return GroveError(
        ERR_CONTINUE_RECONCILE_AND_REQUEUE, message or f"continue; requeue after {delay}s",
        operation, requeue_after=delay,
    )


@dataclass
class LastError:
    """Status-persisted error (errors.go:88-103 mapping to LastErrors)."""

    code: str
    description: str
    observed_at: float

    @staticmethod
    def from_errors(errors: List[GroveError], now: float) -> List["LastError"]:
        return [
            LastError(code=e.code, description=str(e), observed_at=now)
            for e in errors
            if e.code not in (ERR_REQUEUE_AFTER, ERR_CONTINUE_RECONCILE_AND_REQUEUE)
        ]


@dataclass
class ErrorAggregate(Exception):
    errors: List[GroveError] = field(default_factory=list)
