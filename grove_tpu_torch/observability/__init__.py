"""Observability of the port: the metrics registry, the span tracer and the
event recorder (process-global ``METRICS``, ``TRACER``, ``EVENTS``), as in
``grove_tpu/observability``."""
