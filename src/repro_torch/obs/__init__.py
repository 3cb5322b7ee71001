"""Telemetry of the PyTorch port: the structured tracer the engine, the
pool and the scheduler emit into (``trace``), the metrics registry the
scheduler's per-request histograms live on (``metrics``), the overlap
analyzer that splits transfer time into hidden and exposed (``overlap``),
and the trace-file checker (``check``, ``python -m repro_torch.obs.check``).
"""

from repro_torch.obs.metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, STEP_BUCKETS,
)
from repro_torch.obs.overlap import OverlapAnalyzer
from repro_torch.obs.trace import NULL_TRACER, NullTracer, TraceEvent, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "STEP_BUCKETS", "OverlapAnalyzer", "TraceEvent", "Tracer",
           "NullTracer", "NULL_TRACER"]
