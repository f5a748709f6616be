"""Minimal metrics registry (counters, gauges, histograms).

Counterpart of ``grove_tpu/observability/metrics.py`` without the
percentiles and the Prometheus exposition.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List


class Metrics:
    MAX_SAMPLES = 4096  # recent window kept per histogram

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, List[float]] = defaultdict(list)

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
            if len(values) > self.MAX_SAMPLES:
                del values[: self.MAX_SAMPLES // 2]


METRICS = Metrics()
