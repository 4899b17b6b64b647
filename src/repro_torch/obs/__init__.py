"""Telemetry plane of the port: so far only the request span tracer
(:mod:`repro_torch.obs.trace`), which the serving engine needs."""

from .trace import NULL_TRACER, NullTracer, SpanTracer

__all__ = ["NULL_TRACER", "NullTracer", "SpanTracer"]
