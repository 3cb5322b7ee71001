"""Telemetry of the PyTorch port: the structured tracer the engine, the
pool and the scheduler emit into (``trace``), and the metrics registry the
scheduler's per-request histograms live on (``metrics``)."""

from repro_torch.obs.metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, STEP_BUCKETS,
)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, TraceEvent, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "STEP_BUCKETS", "TraceEvent", "Tracer", "NullTracer",
           "NULL_TRACER"]
