"""Observability: span tracer, metrics registry and kernel profiler
(copies of ``repro.obs.trace`` / ``repro.obs.metrics``; ports of
``repro.obs.profile`` / ``repro.obs.kernel_costs``, timed by CUDA events on
a card). ``python -m repro_torch.obs <trace.json>`` summarizes an exported
trace."""

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.profile import Profiler
from repro_torch.obs.trace import Tracer, req_tid, validate_chrome

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Profiler",
           "Tracer", "req_tid", "validate_chrome"]
