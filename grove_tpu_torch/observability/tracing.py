"""Span tracing: named, timed, nested intervals.

Counterpart of ``grove_tpu/observability/tracing.py``:

- ``Span``: a named interval with attributes and its parent's name (a
  per-thread span stack nests them, so ``scheduler.schedule`` parents the
  encode, solve and commit spans it opens);
- ``Tracer``: a thread-safe, bounded collector with two exports, a JSON
  summary (count and total/p50/p99/max seconds per span name) and Chrome
  ``trace_event`` complete events (``ph: "X"``) that chrome://tracing and
  Perfetto load; ``validate_chrome_trace`` checks such an array.

Off by default (``GROVE_TPU_TRACE=1`` or ``TRACER.enable()``); while off,
``span()`` returns a shared no-op span, so every call site costs one
boolean check. Durations come from ``time.perf_counter()``; with a virtual
clock attached (``TRACER.clock``) a span also carries the clock's reading
as its ``vt`` attribute. A span around device work closes after the host
read that waits for the device (``.cpu()``), never after a
``torch.cuda.synchronize`` of its own: a traced run takes the untraced
run's path.

Finished spans also go to ``FLIGHT_SINK`` when the flight recorder
(``observability/flightrec.py``) installs itself there. ``set_shard`` is the
per-thread shard context the engine sets around each reconcile of a
keyspace-sharded store: every span opened inside carries it as its
``shard`` attribute (the Chrome export's ``shard`` column; -1 when unset);
``set_worker`` is the parallel drain's per-thread worker stamp, carried as
the ``worker`` attribute. ``SPAN_HOOK`` is the runtime sanitizer's
(``analysis/sanitize.py``) leaked-span ledger, told of every span's open and
close while it is installed.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from grove_tpu_torch.observability.metrics import _quantile


class _NullSpan:
    """Shared no-op span returned while tracing is off."""

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

# Sanitizer hook (analysis/sanitize.py): an object with span_opened(span) /
# span_closed(span), installed only under GROVE_TPU_SANITIZE=1 for leaked-span
# detection. One global load a span while tracing is on.
SPAN_HOOK = None

# Flight-recorder sink (observability/flightrec.py): an object with
# note_span(span), installed by FLIGHTREC.enable() so finished spans land in
# its postmortem rings. One global load a span while tracing is on.
FLIGHT_SINK = None


class Span:
    __slots__ = ("name", "attrs", "parent", "tid", "ts_us", "dur_us", "_t0", "_tracer", "_done")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs
        self._tracer = tracer
        self.tid = threading.get_ident()
        stack = tracer._stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        if tracer.clock is not None:
            attrs["vt"] = round(tracer.clock.now(), 3)
        # the engine's shard context; an explicit attribute wins
        if "shard" not in attrs:
            shard = getattr(tracer._tls, "shard", None)
            if shard is not None:
                attrs["shard"] = shard
        # the parallel drain's worker stamp
        if "worker" not in attrs:
            worker = getattr(tracer._tls, "worker", None)
            if worker is not None:
                attrs["worker"] = worker
        self._done = False
        if SPAN_HOOK is not None:
            SPAN_HOOK.span_opened(self)
        self._t0 = time.perf_counter()
        self.ts_us = int((self._t0 - tracer._origin) * 1e6)
        self.dur_us = 0

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        if SPAN_HOOK is not None:
            SPAN_HOOK.span_closed(self)
        self.dur_us = int((time.perf_counter() - self._t0) * 1e6)
        if FLIGHT_SINK is not None:
            FLIGHT_SINK.note_span(self)
        tracer = self._tracer
        stack = tracer._stack()
        # tolerate out-of-order ends (a span ended from a finally after its
        # child leaked): drop this span from wherever it sits
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

    def __init__(self, max_spans: int = 20_000, clock=None) -> None:
        self.enabled = os.environ.get("GROVE_TPU_TRACE", "") not in ("", "0", "false")
        self.max_spans = max_spans
        # virtual clock (optional): spans carry its reading as a `vt` attr
        self.clock = clock
        self.recorded = 0
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max_spans)
        self._origin = time.perf_counter()
        self._tls = threading.local()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self.recorded = 0
        self._origin = time.perf_counter()

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, **attrs):
        """Open a span (a context manager, or call ``.end()``). While off:
        one attribute check and the shared no-op span."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, attrs)

    def current_span(self):
        stack = self._stack()
        return stack[-1] if stack else None

    def set_shard(self, shard: Optional[int]) -> None:
        """Per-thread shard context: spans opened after this carry
        ``shard`` as an attribute until it is cleared with None. The engine
        sets it around each reconcile of a sharded store, behind its
        enabled check."""
        self._tls.shard = shard

    def set_worker(self, worker: Optional[int]) -> None:
        """Per-thread worker context (the parallel drain's lanes): spans
        opened after this carry ``worker`` until it is cleared with None."""
        self._tls.worker = worker

    # -- export ----------------------------------------------------------

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span name: count, total/p50/p99/max seconds."""
        by_name: Dict[str, List[int]] = {}
        for sp in self.spans():
            by_name.setdefault(sp.name, []).append(sp.dur_us)
        out: Dict[str, Dict[str, float]] = {}
        for name, durs in sorted(by_name.items()):
            durs.sort()
            out[name] = {
                "count": len(durs),
                "total_s": round(sum(durs) / 1e6, 6),
                "p50_s": round(_quantile(durs, 0.5) / 1e6, 6),
                "p99_s": round(_quantile(durs, 0.99) / 1e6, 6),
                "max_s": round(durs[-1] / 1e6, 6),
            }
        return out

    def summary_json(self) -> dict:
        return {
            "enabled": self.enabled,
            "recorded": self.recorded,
            "retained": len(self._spans),
            "dropped": max(0, self.recorded - len(self._spans)),
            "spans": self.summary(),
        }

    def slowest(self, n: int = 10) -> List[Span]:
        return sorted(self.spans(), key=lambda s: -s.dur_us)[:n]

    def chrome_trace(self) -> List[dict]:
        """Chrome trace_event complete events (``"ph": "X"``), ts and dur in
        µs, sorted by start; nesting is by time containment within (pid,
        tid). Every event carries a ``shard`` column (-1: not shard-scoped)."""
        pid = os.getpid()
        events = []
        for sp in self.spans():
            shard = sp.attrs.get("shard")
            events.append(
                {
                    "name": sp.name,
                    "ph": "X",
                    "ts": sp.ts_us,
                    "dur": sp.dur_us,
                    "pid": pid,
                    "tid": sp.tid,
                    "shard": shard if isinstance(shard, int) else -1,
                    "args": dict(sp.attrs, parent=sp.parent),
                }
            )
        events.sort(key=lambda e: e["ts"])
        return events


def validate_chrome_trace(events) -> List[str]:
    """Well-formedness of a Chrome trace: an array of objects, each with
    ``ph``, an integer ``ts`` and ``name`` (and an integer ``dur`` for
    ``"X"`` events). Returns the problems found (empty: valid)."""
    problems: List[str] = []
    if not isinstance(events, list):
        return [f"top-level JSON must be an array, got {type(events).__name__}"]
    if not events:
        problems.append("trace is empty (tracing enabled?)")
    for i, ev in enumerate(events[:10_000]):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        for field in ("ph", "ts", "name"):
            if field not in ev:
                problems.append(f"event {i} missing {field!r}")
        if ev.get("ph") == "X" and not isinstance(ev.get("dur"), int):
            problems.append(f"event {i} ('X') missing integer 'dur'")
        if not isinstance(ev.get("ts"), int):
            problems.append(f"event {i} 'ts' must be an integer (µs)")
    return problems


TRACER = Tracer()
