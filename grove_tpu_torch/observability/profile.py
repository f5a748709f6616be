"""Wall-attribution profiler: where a control-plane second goes.

Counterpart of ``grove_tpu/observability/profile.py``. ``PROFILER.phase``
opens a phase, a timed interval attributed to a ``(controller, shard,
phase)`` key. Phases nest through a per-thread stack and account exclusive
(self) time: while a child phase is open its parent stops accumulating, so
the self-times sum to the wall of the outermost phases, and attributed
seconds over an independently measured wall is a coverage ratio by
arithmetic. A phase opened with ``controller`` or ``shard`` re-keys every
phase opened inside it (the scheduler's round is ``controller="scheduler"``,
so the store reads and commits inside it land there too).

Self-times fold into log-bucket histograms (power-of-two µs buckets, 64 of
them): O(1) memory a key, p50/p99 read back at a bucket's midpoint.

Off by default (``GROVE_TPU_PROFILE=1`` or ``PROFILER.enable()``); every
call site costs one boolean check while off
(``PROFILER.phase(...) if PROFILER.enabled else None``).
``disabled_check_cost_ns`` times that check over the tracer, the profiler
and the journeys; the flight recorder's flag joins it when the port has
one.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

PHASE_DRAIN = "drain"  # engine drain loop (self = pop/route glue)
PHASE_DEQUEUE = "dequeue"  # watch-event routing into workqueues
PHASE_RECONCILE = "reconcile"  # one reconcile (self = controller compute/diff)
PHASE_SNAPSHOT = "snapshot"  # store reads (get/list) under the open phase
PHASE_STORE_COMMIT = "store-commit"  # store writes (create/update/delete)
PHASE_STATUS_WRITE = "status-write"  # copy-on-write status commits
PHASE_SCHEDULE = "schedule"  # one scheduler round (self = ordering/quota/preemption glue)
PHASE_PENDING_SCAN = "pending-scan"  # phase/health upkeep + pending encode
PHASE_ENCODE = "encode"  # problem assembly (from scratch or delta)
PHASE_SOLVE = "solve"  # wave solve, device dispatch included
PHASE_COMMIT = "commit"  # binding admitted gangs' pods
PHASE_TICK = "tick"  # one component tick (autoscaler/monitor/drainer/kubelet)
PHASE_WAL_FLUSH = "wal-flush"  # one WAL group commit

PHASES = frozenset(
    v for k, v in list(globals().items()) if k.startswith("PHASE_") and isinstance(v, str)
)

NO_SHARD = -1  # not shard-scoped work

_NBUCKETS = 64


class _Hist:
    """One key's online histogram: power-of-two µs buckets and exact
    count, total and max."""

    __slots__ = ("counts", "count", "total_us", "max_us")

    def __init__(self) -> None:
        self.counts = [0] * _NBUCKETS
        self.count = 0
        self.total_us = 0
        self.max_us = 0

    def add(self, us: int) -> None:
        idx = min(us.bit_length(), _NBUCKETS - 1)
        self.counts[idx] += 1
        self.count += 1
        self.total_us += us
        if us > self.max_us:
            self.max_us = us

    def quantile_us(self, q: float) -> float:
        """The q-th sample's bucket midpoint (bucket b spans [2^(b-1), 2^b)
        µs): the error is bounded by the bucket's width."""
        if self.count == 0:
            return 0.0
        target = max(1, int(q * self.count + 0.5))
        seen = 0
        for b, n in enumerate(self.counts):
            seen += n
            if seen >= target:
                return 0.5 if b == 0 else 1.5 * (1 << (b - 1))
        return float(self.max_us)


class _NullPhase:
    """Shared no-op phase."""

    __slots__ = ()

    def __enter__(self) -> "_NullPhase":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def end(self) -> None:
        pass


_NULL_PHASE = _NullPhase()


class _Phase:
    __slots__ = ("_prof", "key", "_t0", "_child", "_prev_ctx", "_done")

    def __init__(self, prof: "WallProfiler", key: Tuple[str, int, str], prev_ctx) -> None:
        self._prof = prof
        self.key = key
        self._prev_ctx = prev_ctx  # restored at end() when this phase re-keyed
        self._child = 0.0
        self._done = False
        self._t0 = time.perf_counter()

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        dur = time.perf_counter() - self._t0
        prof = self._prof
        tls = prof._tls
        stack = tls.stack
        # tolerate out-of-order ends: drop self from wherever it sits
        if self in stack:
            stack.remove(self)
        if stack:
            stack[-1]._child += dur
        else:
            prof._note_toplevel(dur)
        if self._prev_ctx is not None:
            tls.ctx = self._prev_ctx
        prof._record(self.key, max(dur - self._child, 0.0))

    def __enter__(self) -> "_Phase":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class WallProfiler:
    """Process-global (``PROFILER``), thread-safe: histogram updates are
    locked; the phase stack and the attribution context are per thread."""

    def __init__(self) -> None:
        self.enabled = os.environ.get("GROVE_TPU_PROFILE", "") not in ("", "0", "false")
        self._lock = threading.Lock()
        self._hist: Dict[Tuple[str, int, str], _Hist] = {}
        self._toplevel_s = 0.0  # wall covered by outermost phases
        self._tls = threading.local()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._hist = {}
            self._toplevel_s = 0.0

    # -- recording -------------------------------------------------------

    def _state(self):
        tls = self._tls
        if getattr(tls, "stack", None) is None:
            tls.stack = []
            tls.ctx = ("-", NO_SHARD)
        return tls

    def phase(self, name: str, controller: Optional[str] = None, shard: Optional[int] = None):
        """Open a phase (a context manager, or call ``.end()``).
        ``controller`` / ``shard`` default to the enclosing phase's; passing
        either re-keys every phase opened inside this one."""
        if not self.enabled:
            return _NULL_PHASE
        tls = self._state()
        ctx = tls.ctx
        prev = None
        if controller is not None or shard is not None:
            new_ctx = (
                controller if controller is not None else ctx[0],
                shard if shard is not None else ctx[1],
            )
            prev, tls.ctx, ctx = ctx, new_ctx, new_ctx
        ph = _Phase(self, (ctx[0], ctx[1], name), prev)
        tls.stack.append(ph)
        return ph

    def reconcile(self, controller: str, shard: int = NO_SHARD):
        """A per-reconcile phase that re-keys everything inside it."""
        return self.phase(PHASE_RECONCILE, controller=controller, shard=shard)

    def _record(self, key: Tuple[str, int, str], self_s: float) -> None:
        us = int(self_s * 1e6)
        with self._lock:
            hist = self._hist.get(key)
            if hist is None:
                hist = self._hist[key] = _Hist()
            hist.add(us)

    def _note_toplevel(self, dur: float) -> None:
        with self._lock:
            self._toplevel_s += dur

    # -- report ----------------------------------------------------------

    def attributed_seconds(self) -> float:
        """Sum of every recorded self-time."""
        with self._lock:
            return sum(h.total_us for h in self._hist.values()) / 1e6

    def covered_wall_seconds(self) -> float:
        """Wall covered by outermost phases."""
        with self._lock:
            return self._toplevel_s

    def report(self, wall_seconds: Optional[float] = None, top: Optional[int] = None) -> dict:
        """Rows per (controller, shard, phase) by total self-time,
        per-controller totals, and with an independently measured wall the
        coverage ratio (attributed seconds / wall)."""
        with self._lock:
            items = [
                (key, h.count, h.total_us, h.quantile_us(0.5), h.quantile_us(0.99), h.max_us)
                for key, h in self._hist.items()
            ]
            toplevel = self._toplevel_s
        items.sort(key=lambda row: -row[2])
        phases: List[dict] = []
        by_controller: Dict[str, float] = {}
        attributed_us = 0
        for (controller, shard, name), count, total_us, p50, p99, mx in items:
            attributed_us += total_us
            by_controller[controller] = by_controller.get(controller, 0.0) + total_us / 1e6
            phases.append(
                {
                    "controller": controller,
                    "shard": shard,
                    "phase": name,
                    "count": count,
                    "total_s": round(total_us / 1e6, 6),
                    "p50_s": round(p50 / 1e6, 9),
                    "p99_s": round(p99 / 1e6, 9),
                    "max_s": round(mx / 1e6, 6),
                }
            )
        if top is not None:
            phases = phases[:top]
        doc = {
            "enabled": self.enabled,
            "attributed_seconds": round(attributed_us / 1e6, 6),
            "covered_wall_seconds": round(toplevel, 6),
            "by_controller": {c: round(s, 6) for c, s in sorted(by_controller.items())},
            "phases": phases,
        }
        if wall_seconds is not None:
            doc["wall_seconds"] = round(wall_seconds, 6)
            doc["coverage"] = (
                round(attributed_us / 1e6 / wall_seconds, 4) if wall_seconds > 0 else 0.0
            )
        return doc


def disabled_check_cost_ns(iters: int = 200_000) -> float:
    """The measured cost of one all-off check, the boolean every guarded
    site pays while tracing, profiling, journeys and the flight recorder
    are off."""
    from grove_tpu_torch.observability.flightrec import FLIGHTREC
    from grove_tpu_torch.observability.journey import JOURNEYS
    from grove_tpu_torch.observability.tracing import TRACER

    t0 = time.perf_counter()
    for _ in range(iters):
        if (
            TRACER.enabled or PROFILER.enabled or JOURNEYS.enabled or FLIGHTREC.enabled
        ):  # pragma: no cover
            pass
    return (time.perf_counter() - t0) / iters * 1e9


PROFILER = WallProfiler()
