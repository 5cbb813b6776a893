"""repro_torch.obs - the port's metrics registry (a copy of
``repro/obs/registry.py``) and its spans (``spans.py``).

The process registry (``get_registry()``) holds the feed's ``feed_*`` series
(every ``DeviceFeeder``'s ``FeedMetrics``) and, once the profiler has
recorded train steps and ``flush()`` has run, the train step's
``train_phase_seconds``: one ``snapshot()`` shows both.
The benchmark's per-layer metrics read the phases (``portbench/metrics``).
"""
from .registry import Counter, Gauge, Histogram, MetricsRegistry, get_registry
from .spans import PhaseClock, flush, span, tracing

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "PhaseClock", "flush",
           "get_registry", "span", "tracing"]
