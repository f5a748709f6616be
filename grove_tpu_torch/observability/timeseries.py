"""Bounded virtual-clock time series: the SLO observatory's memory.

Counterpart of ``grove_tpu/observability/timeseries.py``:

- ``TIMESERIES.gauge(name, v)`` / ``.observe(name, v)`` fold samples into
  a bounded ring of per-tick cells keyed by the virtual clock
  (``int(vt // resolution)``): a gauge keeps one value a tick (the last
  write wins), a distribution a ``(count, total, max, log buckets)`` row a
  tick (the profiler's power-of-two µs buckets);
- ``TIMESERIES.sample(now)`` runs at a round boundary: the registered
  collectors (``install_serving_collector``: the ready fraction from the
  store's pod aggregates, per-tenant queue wait from the pending journeys,
  per-queue usage from the quota accountant), then the per-tick deltas of
  the counters ``track_counter`` mirrors;
- ``TIMESERIES.window(name, seconds)`` reduces the ring over ``(now -
  seconds, now]``: n/mean/max/min/last/p50/p99 of a gauge (exact), and
  count/rate/mean/max/p50/p99 of a distribution (bucket-interpolated).

Plain Python and numpy on the host, the same arithmetic as the JAX module,
so fed the same samples both give the same bits. Off by default
(``GROVE_TPU_TIMESERIES=1`` or ``TIMESERIES.enable()``); every feed site
costs one boolean check while off.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from grove_tpu_torch.observability.metrics import METRICS

# power-of-two µ-unit buckets, shared with the wall profiler's histograms:
# bucket b spans [2^(b-1), 2^b) µ-units, quantiles interpolate at the
# geometric midpoint 1.5 * 2^(b-1) (b=0 -> 0.5µ)
N_BUCKETS = 64

# default ring capacity in ticks: at 1 s resolution this is ~68 minutes
# of history — enough for a 1 h slow-burn window with room to spare
DEFAULT_CAPACITY = 4096

# Serving-signal series the installed collector feeds: admission latency
# is pushed by the journey tracker on completion; the rest are pulled per
# sample() round.
SERIES_ADMISSION = "admission_latency"  # wall seconds, per completed gang
SERIES_ADMISSION_VT = "admission_latency_vt"  # virtual seconds, same gangs
SERIES_READY_FRACTION = "ready_fraction"  # ready/desired, cluster + per-PCS
SERIES_QUEUE_WAIT = "queue_wait_vt"  # oldest pending journey age, per tenant
SERIES_QUEUE_USAGE = "queue_usage"  # accountant cpu usage, per queue
SERIES_SCALEUP_LATENCY = "scaleup_latency_vt"  # HPA bump -> ready, virtual s

SERVING_SIGNALS = (
    SERIES_ADMISSION,
    SERIES_ADMISSION_VT,
    SERIES_READY_FRACTION,
    SERIES_QUEUE_WAIT,
    SERIES_QUEUE_USAGE,
    SERIES_SCALEUP_LATENCY,
)


def bucket_of(units: int) -> int:
    """Log bucket index of a non-negative integer µ-unit value (the
    profiler's ``us.bit_length()`` rule, one home for the SLO layer and
    the NumPy oracle to share)."""
    idx = units.bit_length()
    return idx if idx < N_BUCKETS else N_BUCKETS - 1


def bucket_value(b: int) -> float:
    """Representative µ-unit value of bucket ``b`` (geometric midpoint)."""
    return 0.5 if b == 0 else 1.5 * float(1 << (b - 1))


class _GaugeRing:
    """One gauge series: per-tick last-written value in a bounded ring.
    ``_stamps[i]`` records which tick owns slot ``i`` — a slot whose stamp
    is not the probed tick is stale (wrapped past) and reads as absent."""

    __slots__ = ("_stamps", "_values", "capacity")

    kind = "gauge"

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._stamps = [-1] * capacity
        self._values = [0.0] * capacity

    def put(self, tick: int, value: float) -> None:
        slot = tick % self.capacity
        self._stamps[slot] = tick
        self._values[slot] = float(value)

    def window_values(self, t0: int, t1: int) -> List[float]:
        """Samples with tick in (t0, t1], in tick order. Clamped to tick
        0: virtual time starts at zero, and a negative probe tick would
        alias the ring's -1 initial stamps into phantom samples."""
        lo = max(t0 + 1, t1 - self.capacity + 1, 0)
        out = []
        for tick in range(lo, t1 + 1):
            slot = tick % self.capacity
            if self._stamps[slot] == tick:
                out.append(self._values[slot])
        return out

    def window_samples(self, t0: int, t1: int) -> List[Tuple[int, float]]:
        """Like window_values, but keeping each sample's tick — the
        forecaster fits trend/seasonality against tick positions, so
        sparse rings must not collapse into a dense sequence."""
        lo = max(t0 + 1, t1 - self.capacity + 1, 0)
        out = []
        for tick in range(lo, t1 + 1):
            slot = tick % self.capacity
            if self._stamps[slot] == tick:
                out.append((tick, self._values[slot]))
        return out


class _DistRing:
    """One distribution series: per-tick (count, total, max, buckets)
    aggregation rows. Values are folded as integer µ-units so the bucket
    math is exact and the window merge is pure integer arithmetic."""

    __slots__ = ("_stamps", "_counts", "_totals", "_maxes", "_buckets",
                 "capacity")

    kind = "dist"

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._stamps = [-1] * capacity
        self._counts = [0] * capacity
        self._totals = [0] * capacity  # integer µ-units
        self._maxes = [0] * capacity
        self._buckets: List[Optional[List[int]]] = [None] * capacity

    def put(self, tick: int, value: float) -> None:
        slot = tick % self.capacity
        if self._stamps[slot] != tick:
            self._stamps[slot] = tick
            self._counts[slot] = 0
            self._totals[slot] = 0
            self._maxes[slot] = 0
            self._buckets[slot] = [0] * N_BUCKETS
        units = int(value * 1e6)
        if units < 0:
            units = 0
        row = self._buckets[slot]
        row[bucket_of(units)] += 1
        self._counts[slot] += 1
        self._totals[slot] += units
        if units > self._maxes[slot]:
            self._maxes[slot] = units

    def window_rows(
        self, t0: int, t1: int
    ) -> List[Tuple[int, int, int, List[int]]]:
        """(count, total, max, buckets) rows for ticks in (t0, t1],
        clamped to tick 0 (see window_values). Bucket rows are COPIED:
        the caller merges them outside the store lock, and a concurrent
        ``put`` into the same tick must not mutate a row mid-merge."""
        lo = max(t0 + 1, t1 - self.capacity + 1, 0)
        out = []
        for tick in range(lo, t1 + 1):
            slot = tick % self.capacity
            if self._stamps[slot] == tick and self._counts[slot]:
                out.append(
                    (
                        self._counts[slot],
                        self._totals[slot],
                        self._maxes[slot],
                        list(self._buckets[slot]),
                    )
                )
        return out


def dist_quantile_units(merged_buckets: np.ndarray, count: int, q: float) -> float:
    """Bucket-interpolated quantile over a merged bucket row, in µ-units —
    the profiler's ``_Hist.quantile_us`` rule applied to a window merge. One
    home: the SLO layer, the journey window summary, and the NumPy oracle
    all call (or reproduce) exactly this."""
    if count == 0:
        return 0.0
    target = max(1, int(q * count + 0.5))
    cum = np.cumsum(merged_buckets)
    b = int(np.searchsorted(cum, target))
    return bucket_value(b)


class TimeSeriesStore:
    """Process-global (``TIMESERIES``), thread-safe, bounded: one ring per
    series name, O(capacity) memory per series regardless of sample
    volume. The virtual clock is authoritative — wall time never enters a
    ring, so seeded storms replay bit-identically."""

    def __init__(
        self, capacity: int = DEFAULT_CAPACITY, resolution: float = 1.0
    ) -> None:
        self.enabled = os.environ.get("GROVE_TPU_TIMESERIES", "") not in (
            "",
            "0",
            "false",
        )
        self.clock = None  # optional virtual clock (newest harness wins)
        self.capacity = capacity
        self.resolution = resolution
        self.tap: Optional[Callable[[str, int, float], None]] = None
        self._lock = threading.Lock()
        self._series: Dict[str, object] = {}
        self._collectors: List[Callable[[float], None]] = []
        self._tracked: Dict[str, float] = {}  # counter name -> last seen
        self._now = 0.0  # last sample() timestamp (vt)

    # -- lifecycle -------------------------------------------------------

    def enable(
        self,
        clock=None,
        capacity: Optional[int] = None,
        resolution: Optional[float] = None,
    ) -> "TimeSeriesStore":
        with self._lock:
            if clock is not None:
                self.clock = clock
            if capacity is not None:
                self.capacity = capacity
            if resolution is not None:
                self.resolution = resolution
            self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._series = {}
            self._collectors = []
            self._tracked = {}
            self._now = 0.0

    # -- time ------------------------------------------------------------

    def _vt(self) -> float:
        return self.clock.now() if self.clock is not None else self._now

    def tick_of(self, vt: float) -> int:
        return int(vt // self.resolution)

    # -- feeds (one boolean check each when disabled) --------------------

    def _ring(self, name: str, cls):
        ring = self._series.get(name)
        if ring is None:
            ring = self._series[name] = cls(self.capacity)
        return ring

    def gauge(self, name: str, value: float, vt: Optional[float] = None) -> None:
        """Record a gauge sample at the current virtual tick (last write
        in a tick wins — the sampling cadence is the resolution)."""
        if not self.enabled:
            return
        tick = self.tick_of(vt if vt is not None else self._vt())
        with self._lock:
            self._ring(name, _GaugeRing).put(tick, value)
        if self.tap is not None:
            self.tap(name, tick, float(value))

    def observe(self, name: str, value: float, vt: Optional[float] = None) -> None:
        """Fold one observation into the tick's distribution row."""
        if not self.enabled:
            return
        tick = self.tick_of(vt if vt is not None else self._vt())
        with self._lock:
            self._ring(name, _DistRing).put(tick, value)
        if self.tap is not None:
            self.tap(name, tick, float(value))

    # -- sampling round (tick boundary) ----------------------------------

    def add_collector(self, fn: Callable[[float], None]) -> None:
        """Register a per-sample collector (called with the vt)."""
        with self._lock:
            self._collectors.append(fn)

    def remove_collector(self, fn: Callable[[float], None]) -> None:
        """Unregister a collector (scenario teardown: a collector's
        closure pins its harness, and a stale one firing on a later
        re-enable would feed gauges from a dead store)."""
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def track_counter(self, name: str) -> None:
        """Mirror a metrics-registry counter as a per-tick delta gauge
        series named ``rate:<counter>`` (the registry is cumulative; a
        window rate needs the per-tick increments)."""
        with self._lock:
            self._tracked.setdefault(name, METRICS.counters.get(name, 0.0))

    def sample(self, now: float) -> None:
        """One sampling round at a tick boundary: run every collector,
        then fold tracked counter deltas. The harness calls this per
        converge tick behind the one-boolean check."""
        if not self.enabled:
            return
        self._now = now
        for fn in list(self._collectors):
            fn(now)
        if self._tracked:
            for name in list(self._tracked):
                cur = METRICS.counters.get(name, 0.0)
                self.gauge(f"rate:{name}", cur - self._tracked[name], vt=now)
                self._tracked[name] = cur
        METRICS.inc("timeseries_samples_total")

    # -- windowed reducers -----------------------------------------------

    def window(
        self, name: str, seconds: float, now: Optional[float] = None
    ) -> dict:
        """Reduce ``name`` over the ticks in ``(now - seconds, now]``.

        Gauge series: ``n/mean/max/min/last/p50/p99`` (exact quantiles
        over the per-tick samples, the metrics.py index rule). Dist
        series: ``count/rate/mean/max/p50/p99`` (bucket-interpolated).
        Empty windows return ``{"n": 0}`` / ``{"count": 0}`` shells — the
        SLO layer treats them as "no data", never as zero latency.
        ``seconds`` is clamped to one resolution tick: the minimum
        meaningful window (and the rate divisor) is one tick, so a
        zero/negative request cannot divide by zero.
        """
        seconds = max(float(seconds), self.resolution)
        vt = now if now is not None else self._vt()
        t1 = self.tick_of(vt)
        t0 = t1 - max(1, int(round(seconds / self.resolution)))
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                return {"kind": "absent", "n": 0, "count": 0}
            if ring.kind == "gauge":
                values = ring.window_values(t0, t1)
            else:
                rows = ring.window_rows(t0, t1)
        if ring.kind == "gauge":
            if not values:
                return {"kind": "gauge", "n": 0}
            arr = np.asarray(values, dtype=np.float64)
            srt = np.sort(arr)
            return {
                "kind": "gauge",
                "n": int(arr.size),
                "mean": float(arr.sum() / arr.size),
                "max": float(srt[-1]),
                "min": float(srt[0]),
                "last": float(arr[-1]),
                "p50": float(srt[_q_idx(arr.size, 0.5)]),
                "p99": float(srt[_q_idx(arr.size, 0.99)]),
            }
        if not rows:
            return {"kind": "dist", "count": 0}
        count = sum(r[0] for r in rows)
        total = sum(r[1] for r in rows)
        mx = max(r[2] for r in rows)
        merged = np.sum(
            np.asarray([r[3] for r in rows], dtype=np.int64), axis=0
        )
        return {
            "kind": "dist",
            "count": int(count),
            "rate": float(count) / float(seconds),
            "mean": float(total) / float(count) / 1e6,
            "max": float(mx) / 1e6,
            "p50": dist_quantile_units(merged, count, 0.5) / 1e6,
            "p99": dist_quantile_units(merged, count, 0.99) / 1e6,
        }

    def reduce(
        self,
        name: str,
        reducer: str,
        seconds: float,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """One reducer value, or None when the window holds no data —
        the SLO layer's read primitive."""
        doc = self.window(name, seconds, now=now)
        if doc.get("n", 0) == 0 and doc.get("count", 0) == 0:
            return None
        return doc.get(reducer)

    def gauge_samples(
        self, name: str, seconds: float, now: Optional[float] = None
    ) -> List[Tuple[int, float]]:
        """Raw per-tick ``(tick, value)`` gauge samples over the ticks in
        ``(now - seconds, now]`` — the forecaster's read primitive (ring
        internals stay private to this module). Returns ``[]`` for
        absent series and for distribution series (forecasting reduces
        gauges only; dist windows go through ``window()``)."""
        seconds = max(float(seconds), self.resolution)
        vt = now if now is not None else self._vt()
        t1 = self.tick_of(vt)
        t0 = t1 - max(1, int(round(seconds / self.resolution)))
        with self._lock:
            ring = self._series.get(name)
            if ring is None or ring.kind != "gauge":
                return []
            return ring.window_samples(t0, t1)

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def snapshot(self, seconds: float = 300.0) -> dict:
        """Every series reduced over one window (the /debug/slo report's
        series appendix)."""
        return {
            name: self.window(name, seconds) for name in self.series_names()
        }


def _q_idx(n: int, q: float) -> int:
    """The exact-quantile index rule (metrics.py::_quantile, restated for
    array indexing so the gauge reducers and the oracle agree bit-wise)."""
    return min(n - 1, max(0, math.ceil(q * n) - 1))


def install_serving_collector(
    store, scheduler=None, clock=None
) -> Callable[[float], None]:
    """Register the serving-signals collector: per sample round it feeds

    - ``ready_fraction`` (cluster-wide, from the level-2 pod aggregates'
      ``Store.pod_summary``) and ``ready_fraction/<ns>/<pcs>`` per
      PodCliqueSet (ready ÷ desired over its cliques' counter rows);
    - ``queue_wait_vt/<tenant>`` — the oldest pending journey age per
      namespace (virtual seconds), from the journey tracker;
    - ``queue_usage/<queue>`` — the quota accountant's cpu usage row.

    Returns the collector so scenarios can call it out-of-band."""
    from grove_tpu_torch.api import names as namegen
    from grove_tpu_torch.observability.journey import JOURNEYS

    def collect(now: float) -> None:
        total, ready = store.pod_summary()
        if total:
            TIMESERIES.gauge(
                SERIES_READY_FRACTION, ready / total, vt=now
            )
        # per-PCS ready fraction: desired from the PodClique specs, ready
        # from the same aggregate rows the PCLQ status controller reads
        for pcs in store.scan("PodCliqueSet"):
            ns = pcs.metadata.namespace
            desired = 0
            got = 0
            for pclq in store.scan("PodClique", ns):
                owner = pclq.metadata.labels.get(namegen.LABEL_PART_OF)
                if owner != pcs.metadata.name:
                    continue
                desired += int(pclq.spec.replicas or 0)
                got += store.pod_counters(ns, pclq.metadata.name).ready
            if desired:
                TIMESERIES.gauge(
                    f"{SERIES_READY_FRACTION}/{ns}/{pcs.metadata.name}",
                    got / desired,
                    vt=now,
                )
        for ns, age in JOURNEYS.pending_ages():
            TIMESERIES.gauge(f"{SERIES_QUEUE_WAIT}/{ns}", age, vt=now)
        if scheduler is not None and scheduler.quota.active():
            for queue, row in scheduler.quota.accountant.snapshot().items():
                TIMESERIES.gauge(
                    f"{SERIES_QUEUE_USAGE}/{queue}",
                    float(row.get("cpu", 0.0)),
                    vt=now,
                )

    if clock is not None:
        TIMESERIES.clock = clock
    TIMESERIES.add_collector(collect)
    return collect


TIMESERIES = TimeSeriesStore()
