"""Span tracing: named, timed, nested intervals.

Counterpart of ``grove_tpu/observability/tracing.py`` without the summary,
the Chrome export, the virtual-time stamp and the shard, worker and
flight-recorder hooks. Off by default
(``GROVE_TPU_TRACE=1`` or ``TRACER.enable()``); while off, ``span()``
returns a shared no-op span. A span records its parent's name, so a
caller can split a round's time by where each span ran.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import List


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, key: str, value) -> None:
        pass

    def end(self) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("name", "attrs", "parent", "dur_us", "_t0", "_tracer", "_done")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs
        self._tracer = tracer
        stack = tracer._stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self._done = False
        self._t0 = time.perf_counter()
        self.dur_us = 0

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        self.dur_us = int((time.perf_counter() - self._t0) * 1e6)
        tracer = self._tracer
        stack = tracer._stack()
        if self in stack:
            stack.remove(self)
        with tracer._lock:
            tracer._spans.append(self)
            tracer.recorded += 1

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class Tracer:
    """Bounded in-memory span collector (the oldest spans drop when full)."""

    def __init__(self, max_spans: int = 20_000) -> None:
        self.enabled = os.environ.get("GROVE_TPU_TRACE", "") not in ("", "0", "false")
        self.recorded = 0
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max_spans)
        self._tls = threading.local()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self.recorded = 0

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, attrs)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)


TRACER = Tracer()
