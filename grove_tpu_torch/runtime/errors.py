"""Typed error codes + GroveError.

Counterpart of ``grove_tpu/runtime/errors.py``, cut to what the port's store
and scheduler raise and catch. It is a class of its own: a ``GroveError`` of
the JAX package is not one of these, so the two packages' stores never mix.
"""

from __future__ import annotations

from typing import Optional

ERR_CONFLICT = "ERR_CONFLICT"
ERR_NOT_FOUND = "ERR_NOT_FOUND"


class GroveError(Exception):
    def __init__(
        self,
        code: str,
        message: str = "",
        operation: str = "",
        cause: Optional[Exception] = None,
    ) -> None:
        super().__init__(f"[{code}] {operation}: {message}")
        self.code = code
        self.message = message
        self.operation = operation
        self.cause = cause
