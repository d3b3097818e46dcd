"""Observability: span tracer and metrics registry (copies of
``repro.obs.trace`` / ``repro.obs.metrics``; the kernel profiler is a
later slice)."""

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import Tracer, req_tid, validate_chrome

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Tracer",
           "req_tid", "validate_chrome"]
