"""Runtime sanitizer mode (``GROVE_TPU_SANITIZE=1``): dynamic twins of the
invariants a static analysis cannot prove.

Counterpart of ``grove_tpu/analysis/sanitize.py``. Four checks, all off
unless the env var is set (and most also need an explicit :func:`install`
so they can hook the process-global singletons):

- **Lock-order assertions**: :class:`TrackingLock` wraps the singleton
  locks (tracer, events, metrics, the hashing evictor); each acquisition
  while holding another lock records an ordered edge, and an acquisition
  that would invert an observed edge (a cycle) is recorded as a violation.
- **Store write-path byte-compare guard**: with sanitize on, every Store
  keeps canonical blobs on the copy-on-write path and
  ``verify_readonly_integrity()`` byte-compares committed objects at
  harness boundaries (:func:`store_guard_enabled`); the delta state also
  audits its free-capacity rows against a full recount every tick.
- **Accountant-vs-recount**: :func:`accountant_drift` compares the
  incremental quota accountant against a full ``usage_oracle`` recount
  (shared with the chaos harness's per-tick invariant 3a).
- **Leaked-span / stranded-hold detection at teardown**:
  :func:`harness_problems` reports spans opened but never ended (via the
  tracer's ``SPAN_HOOK``) and monitor-held gangs with no scheduled backoff
  release.

One seed of the chaos matrix runs under the sanitizer (``sim/chaos``'s
``sanitize=True``), so every check runs on every matrix run.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple


def enabled() -> bool:
    """True when the process runs in sanitizer mode."""
    return os.environ.get("GROVE_TPU_SANITIZE", "").lower() not in (
        "",
        "0",
        "false",
    )


def store_guard_enabled() -> bool:
    """The store's byte-compare write guard: its dedicated env var, OR
    sanitize mode (the sanitizer generalizes the guard)."""
    if os.environ.get("GROVE_TPU_STORE_GUARD", "").lower() not in (
        "",
        "0",
        "false",
    ):
        return True
    return enabled()


# ---------------------------------------------------------------------------
# lock-order tracking
# ---------------------------------------------------------------------------


class LockOrderTracker:
    """Observed lock-acquisition partial order + inversion detection.

    Thread-local held-lock stacks; a global edge set ``(outer, inner)``.
    Acquiring B while holding A adds A→B; if a path B→…→A was already
    observed, the acquisition inverts the established order and is
    recorded (not raised — raising mid-acquisition could wedge the very
    code being sanitized; the harness asserts at teardown)."""

    def __init__(self) -> None:
        self._tls = threading.local()
        self._meta = threading.Lock()
        self.edges: Dict[Tuple[str, str], int] = {}
        self.violations: List[str] = []
        self._reported: Set[Tuple[str, str]] = set()

    def _held(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _path_exists(self, src: str, dst: str) -> bool:
        seen = {src}
        frontier = [src]
        while frontier:
            node = frontier.pop()
            for (a, b) in self.edges:
                if a == node and b not in seen:
                    if b == dst:
                        return True
                    seen.add(b)
                    frontier.append(b)
        return False

    def note_acquire(self, name: str) -> None:
        held = self._held()
        if held:
            with self._meta:
                for outer in held:
                    if outer == name:
                        continue
                    key = (outer, name)
                    if key not in self.edges and self._path_exists(
                        name, outer
                    ):
                        pair = (name, outer)
                        if pair not in self._reported:
                            self._reported.add(pair)
                            self.violations.append(
                                f"lock-order inversion: acquired {name!r}"
                                f" while holding {outer!r}, but the order"
                                f" {name!r} -> ... -> {outer!r} was"
                                " already observed"
                            )
                    self.edges.setdefault(key, 0)
                    self.edges[key] += 1
        held.append(name)

    def note_release(self, name: str) -> None:
        held = self._held()
        if name in held:
            held.remove(name)

    def observed_order(self) -> List[str]:
        return sorted(f"{a} -> {b}" for (a, b) in self.edges)


class TrackingLock:
    """Drop-in wrapper over a real lock reporting to a LockOrderTracker.
    Supports the `with` protocol and acquire/release, which is everything
    the wrapped singletons use."""

    def __init__(self, inner, name: str, tracker: LockOrderTracker) -> None:
        self._inner = inner
        self.name = name
        self._tracker = tracker

    def acquire(self, *args, **kwargs) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._tracker.note_acquire(self.name)
        return got

    def release(self) -> None:
        self._tracker.note_release(self.name)
        self._inner.release()

    def __enter__(self) -> "TrackingLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


# ---------------------------------------------------------------------------
# span-leak tracking (hooks grove_tpu_torch.observability.tracing.SPAN_HOOK)
# ---------------------------------------------------------------------------


class SpanLeakTracker:
    """Open-span ledger fed by the tracing module's span hook."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._open: Dict[int, str] = {}

    def span_opened(self, span) -> None:
        with self._lock:
            self._open[id(span)] = span.name

    def span_closed(self, span) -> None:
        with self._lock:
            self._open.pop(id(span), None)

    def leaked(self) -> List[str]:
        with self._lock:
            return sorted(self._open.values())


# ---------------------------------------------------------------------------
# pure checks shared with the chaos harness
# ---------------------------------------------------------------------------


def accountant_drift(accountant, store) -> List[str]:
    """Incremental quota accountant vs. a full usage_oracle recount —
    the tick-boundary exactness check (chaos invariant 3a and the
    sanitizer teardown both call this)."""
    from grove_tpu_torch.quota.oracle import usage_oracle

    accountant.ensure_built(store)
    oracle = usage_oracle(store.scan("Pod"), accountant.default_queue)
    snap = accountant.snapshot()
    problems: List[str] = []
    for q in sorted(set(snap) | set(oracle)):
        a, b = snap.get(q, {}), oracle.get(q, {})
        for r in sorted(set(a) | set(b)):
            if abs(a.get(r, 0.0) - b.get(r, 0.0)) > 1e-6:
                problems.append(
                    f"queue {q} usage {r}: accountant {a.get(r, 0.0)}"
                    f" != recount {b.get(r, 0.0)}"
                )
    return problems


def stranded_holds(monitor) -> List[str]:
    """Monitor-held gangs with no scheduled backoff release — a hold that
    would wait forever (chaos invariant 5 and the teardown check)."""
    problems: List[str] = []
    for gang_key in sorted(monitor._held):
        wq_key = ("PodGang",) + gang_key
        if not monitor.requeue.has_delayed(wq_key):
            problems.append(
                f"held gang {gang_key[0]}/{gang_key[1]} has no scheduled"
                " backoff release (stranded)"
            )
    return problems


# ---------------------------------------------------------------------------
# install / teardown
# ---------------------------------------------------------------------------


class Sanitizer:
    def __init__(self) -> None:
        self.lock_order = LockOrderTracker()
        self.spans = SpanLeakTracker()
        self._restores: List = []

    # -- tracing SPAN_HOOK protocol --------------------------------------

    def span_opened(self, span) -> None:
        self.spans.span_opened(span)

    def span_closed(self, span) -> None:
        self.spans.span_closed(span)

    # -- wiring -----------------------------------------------------------

    def wrap_lock(self, holder, attr: str, name: str) -> None:
        inner = getattr(holder, attr)
        if isinstance(inner, TrackingLock):
            return
        setattr(holder, attr, TrackingLock(inner, name, self.lock_order))
        self._restores.append((holder, attr, inner))

    def unwrap_all(self) -> None:
        for holder, attr, inner in reversed(self._restores):
            setattr(holder, attr, inner)
        self._restores.clear()

    # -- teardown verdict -------------------------------------------------

    def problems(self) -> List[str]:
        out = list(self.lock_order.violations)
        out.extend(f"leaked span: {name}" for name in self.spans.leaked())
        return out


SANITIZER: Optional[Sanitizer] = None


def active() -> bool:
    return SANITIZER is not None


def install() -> Sanitizer:
    """Engage the sanitizer: set the env flag (so stores built from here
    on keep guard blobs), wrap the singleton locks, and hook span
    open/close. Idempotent; pair with :func:`uninstall`."""
    global SANITIZER
    if SANITIZER is not None:
        return SANITIZER
    san = Sanitizer()
    # save the caller's env value so uninstall() restores rather than
    # clobbers an externally-set GROVE_TPU_SANITIZE
    san._prior_env = os.environ.get("GROVE_TPU_SANITIZE")
    os.environ["GROVE_TPU_SANITIZE"] = "1"
    from grove_tpu_torch.api import hashing
    from grove_tpu_torch.observability import tracing
    from grove_tpu_torch.observability.events import EVENTS
    from grove_tpu_torch.observability.metrics import METRICS
    from grove_tpu_torch.observability.tracing import TRACER

    san.wrap_lock(TRACER, "_lock", "Tracer._lock")
    san.wrap_lock(EVENTS, "_lock", "EventRecorder._lock")
    san.wrap_lock(METRICS, "_lock", "Metrics._lock")
    san.wrap_lock(hashing, "_EVICT_LOCK", "api.hashing:_EVICT_LOCK")
    tracing.SPAN_HOOK = san
    san._tracer_was_enabled = TRACER.enabled
    TRACER.enable()  # leaked-span detection needs real spans
    SANITIZER = san
    return san


def uninstall() -> None:
    global SANITIZER
    san = SANITIZER
    if san is None:
        return
    from grove_tpu_torch.observability import tracing
    from grove_tpu_torch.observability.tracing import TRACER

    san.unwrap_all()
    tracing.SPAN_HOOK = None
    if not getattr(san, "_tracer_was_enabled", True):
        TRACER.disable()
    prior = getattr(san, "_prior_env", None)
    if prior is None:
        os.environ.pop("GROVE_TPU_SANITIZE", None)
    else:
        os.environ["GROVE_TPU_SANITIZE"] = prior
    SANITIZER = None


def harness_problems(harness) -> List[str]:
    """Teardown sweep over one SimHarness: lock order, leaked spans,
    stranded holds, accountant drift, store byte-compare integrity.
    Returns a flat problem list (empty = sanitized run stayed green)."""
    problems: List[str] = []
    if SANITIZER is not None:
        problems.extend(SANITIZER.problems())
    monitor = getattr(harness, "node_monitor", None)
    if monitor is not None:
        problems.extend(stranded_holds(monitor))
    scheduler = getattr(harness, "scheduler", None)
    quota = getattr(scheduler, "quota", None) if scheduler else None
    if quota is not None:
        problems.extend(
            f"accountant drift: {p}"
            for p in accountant_drift(quota.accountant, harness.store)
        )
    verify = getattr(harness.store, "verify_readonly_integrity", None)
    if verify is not None:
        try:
            verify()
        except AssertionError as e:
            problems.append(f"store guard: {e}")
    return problems
