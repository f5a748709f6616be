"""Minimal metrics registry (counters, gauges, histograms).

Counterpart of ``grove_tpu/observability/metrics.py``: the same registry,
percentiles over each histogram's recent window, and the Prometheus text
exposition, byte for byte the JAX package's for the same sequence of
``inc`` / ``set`` / ``observe`` calls. Registry names map to Prometheus
series by one grammar (``_prom_parts``): ``base``, ``base/label``
(``name="label"``), ``base@K`` (``shard="K"``) and ``base/label@K``.
"""

from __future__ import annotations

import math
import threading
from collections import defaultdict
from typing import Dict, List


class Metrics:
    """Thread-safe: worker threads and the scheduler observe concurrently,
    and an unsynchronized ``+=`` would lose increments."""

    MAX_SAMPLES = 4096  # recent window kept per histogram

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, List[float]] = defaultdict(list)
        # cumulative across window trims: the exported _count/_sum series
        # stay monotonic, or a scraper reads every trim as a counter reset
        self.hist_count: Dict[str, float] = defaultdict(float)
        self.hist_sum: Dict[str, float] = defaultdict(float)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            values = self.histograms[name]
            values.append(value)
            self.hist_count[name] += 1
            self.hist_sum[name] += value
            if len(values) > self.MAX_SAMPLES:
                del values[: self.MAX_SAMPLES // 2]

    def percentile(self, name: str, q: float) -> float:
        with self._lock:
            values = sorted(self.histograms.get(name, []))
        return _quantile(values, q)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self.hist_count.clear()
            self.hist_sum.clear()

    def prometheus_text(self) -> str:
        # snapshot under the lock: a scrape during concurrent writes must not
        # iterate a dict that changes size
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            hists = {k: list(v) for k, v in self.histograms.items()}
            hist_count = dict(self.hist_count)
            hist_sum = dict(self.hist_sum)
        lines = []
        for name, v in sorted(counters.items()):
            lines.append(f"{_promname(name)} {v}")
        for name, v in sorted(gauges.items()):
            lines.append(f"{_promname(name)} {v}")
        for name, values in sorted(hists.items()):
            base, label = _prom_parts(name)
            braced = label and "{" + label + "}"
            lines.append(f"{base}_count{braced} {hist_count.get(name, 0.0)}")
            lines.append(f"{base}_sum{braced} {hist_sum.get(name, 0.0)}")
            # an empty window would print `nan` quantiles, which many
            # scrapers reject; _count/_sum above keep the cumulative series
            window = sorted(values)
            if not window:
                continue
            for q in (0.5, 0.9, 0.99):
                qlabel = f'quantile="{q}"' + (f",{label}" if label else "")
                lines.append(f"{base}{{{qlabel}}} {_quantile(window, q)}")
        return "\n".join(lines) + "\n"


def _quantile(sorted_values: List[float], q: float) -> float:
    """The one quantile rule of ``percentile``, the exposition, the tracer's
    summary and the journeys' decomposition."""
    if not sorted_values:
        return math.nan
    idx = min(len(sorted_values) - 1, max(0, math.ceil(q * len(sorted_values)) - 1))
    return sorted_values[idx]


def _prom_parts(name: str):
    """Registry name -> (Prometheus name, label string): ``base/label``
    gives ``name="label"`` and ``base@K`` gives ``shard="K"``."""
    shard = None
    if "@" in name:
        name, _, shard = name.rpartition("@")
    labels = []
    if "/" in name:
        name, _, label = name.partition("/")
        labels.append(f'name="{label}"')
    if shard is not None:
        labels.append(f'shard="{shard}"')
    return f"grove_tpu_{name}", ",".join(labels)


def _promname(name: str) -> str:
    base, label = _prom_parts(name)
    return f"{base}{{{label}}}" if label else base


METRICS = Metrics()
