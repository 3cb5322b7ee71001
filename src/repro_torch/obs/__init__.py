"""Telemetry of the PyTorch port: the structured tracer the engine and the
pool emit into."""

from repro_torch.obs.trace import NULL_TRACER, NullTracer, TraceEvent, Tracer

__all__ = ["TraceEvent", "Tracer", "NullTracer", "NULL_TRACER"]
