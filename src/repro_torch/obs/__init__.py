"""Observability for the serving stack: tracing, metrics, flight recorder.

One :class:`Observability` bundle (tracer + metrics registry + flight
recorder) is shared across every layer of a serving deployment.  The
engine creates one by default and pushes it into every component it
constructs (farm, host pools, encoder stage, admission, router), so a
single export call sees the whole request path::

    eng = SummarizationEngine(cfg, n_chips=4)
    ... serve traffic ...
    from repro_torch.obs import chrome_trace, prometheus_text
    doc = chrome_trace(eng.obs.tracer)          # Perfetto-loadable JSON
    text = prometheus_text(eng.obs.registry)    # metrics snapshot

See ``docs/observability.md`` for the span taxonomy and metric families.
"""

from __future__ import annotations

from repro_torch.obs.export import (
    chrome_trace,
    prometheus_text,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.metrics import MetricsRegistry, log_buckets
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import NULL_SPAN, Span, TraceContext, Tracer

__all__ = [
    "Observability",
    "Tracer",
    "Span",
    "TraceContext",
    "NULL_SPAN",
    "MetricsRegistry",
    "log_buckets",
    "FlightRecorder",
    "chrome_trace",
    "write_chrome_trace",
    "validate_chrome_trace",
    "prometheus_text",
]


class Observability:
    """Shared bundle of tracer + metrics registry + flight recorder.

    ``tracing=False`` disables span/event recording entirely (the tracer
    returns inert spans; zero ring appends) while the metrics registry
    stays live -- ``stats()`` views are registry-backed and always on.
    Traced and untraced runs are bit-identical: instrumentation never
    touches keys, instances, or scheduling order.
    """

    def __init__(self, *, tracing: bool = True, capacity: int = 65536,
                 registry: "MetricsRegistry | None" = None,
                 last_n: int = 64):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = Tracer(enabled=tracing, capacity=capacity)
        self.recorder = FlightRecorder(self.tracer, last_n=last_n)

    @classmethod
    def disabled(cls) -> "Observability":
        """Bundle with tracing off (metrics registry still live)."""
        return cls(tracing=False)
