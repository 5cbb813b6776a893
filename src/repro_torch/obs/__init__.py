"""repro_torch.obs - the port's copy of the metrics registry
(``repro/obs/registry.py``), which the feed's ``FeedMetrics`` publishes to."""
from .registry import Counter, Gauge, Histogram, MetricsRegistry, get_registry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry"]
