"""Observability plane of the port, the twin of `repro.obs`: span tracing,
metrics registry, Perfetto export.

The one cross-cutting subsystem that sees all five data planes at once.
``Tracer`` records nested virtual (priced) spans and wall-clock stage
timings; ``MetricsRegistry`` replaces the scattered ``last_*`` telemetry
attributes; ``validate_trace`` is the CI schema gate.  Everything
defaults to :data:`NULL_TRACER`, which is bit- and price-invisible.
"""
from repro_torch.obs.metrics import (NULL_METRICS, Counter, Gauge,
                                     Histogram, MetricsRegistry, NullMetrics,
                                     Series)
from repro_torch.obs.trace import (HOT_PATH, NULL_SPAN, NULL_TRACER,
                                   NullTracer, Span, Tracer,
                                   attach_burst_spans)
from repro_torch.obs.validate import (validate_events, validate_trace,
                                      validate_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_METRICS",
    "NullMetrics", "Series",
    "HOT_PATH", "NULL_SPAN", "NULL_TRACER", "NullTracer", "Span", "Tracer",
    "attach_burst_spans",
    "validate_events", "validate_trace", "validate_tracer",
]
