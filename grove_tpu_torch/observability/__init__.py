"""Observability of the port, as in ``grove_tpu/observability``: the
metrics registry, the span tracer and the event recorder, the glass-box
layer (wall profiler, gang journeys, flight recorder) and the SLO
observatory (time series and objectives).

Process-global singletons: ``METRICS``, ``TRACER``, ``EVENTS``,
``PROFILER``, ``JOURNEYS``, ``FLIGHTREC``, ``TIMESERIES``, ``SLO``. Every
layer but the metrics and the events is off by default, and each of its
sites costs one boolean check while off.
"""

from grove_tpu_torch.observability.events import EVENTS, EventRecorder
from grove_tpu_torch.observability.flightrec import FLIGHTREC, FlightRecorder
from grove_tpu_torch.observability.journey import JOURNEYS, JourneyTracker
from grove_tpu_torch.observability.metrics import METRICS, Metrics
from grove_tpu_torch.observability.profile import PROFILER, WallProfiler
from grove_tpu_torch.observability.slo import SLO, SloEngine, SloSpec
from grove_tpu_torch.observability.timeseries import TIMESERIES, TimeSeriesStore
from grove_tpu_torch.observability.tracing import TRACER, Tracer

__all__ = [
    "EVENTS",
    "EventRecorder",
    "FLIGHTREC",
    "FlightRecorder",
    "JOURNEYS",
    "JourneyTracker",
    "METRICS",
    "Metrics",
    "PROFILER",
    "WallProfiler",
    "SLO",
    "SloEngine",
    "SloSpec",
    "TIMESERIES",
    "TimeSeriesStore",
    "TRACER",
    "Tracer",
]
