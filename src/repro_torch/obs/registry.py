"""Typed metrics registry (a copy of the JAX package's ``repro/obs/registry.py``,
which is plain Python: the port imports nothing of ``repro``).  The feed's
``FeedMetrics`` publishes its ``feed_*`` series through it, under the same
names as the JAX feeder's.

Design constraints, in order:

1. **Writer exactness.**  Counters may be written from several threads (the
   feeder's transfer thread and its consumer); a bare ``+=`` is a
   read-modify-write that loses updates under thread switches.  Every
   mutation holds the series' own lock.
2. **Lock-free reads.**  ``snapshot()`` never takes a lock: series values
   are single floats/ints whose loads are atomic under the GIL, so a
   snapshot is at worst one increment stale per series - it can never
   block a hot writer, and a stuck writer can never block a reader.
   (Histogram snapshots copy the bucket list; a torn read there is one
   observation short in one bucket.)
3. **Labels are cheap after the first use.**  ``labels(...)`` interns the
   child series; hot paths hold the returned handle instead of re-keying
   per event.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
]

# Default histogram bucket upper bounds (seconds-ish scale: the service's
# latencies live between 10µs RPCs and multi-second stalls).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class _Series:
    """One labeled time series of a Counter/Gauge: a locked float cell.

    ``value`` is read WITHOUT the lock by snapshots (GIL-atomic float
    load); the lock only serializes read-modify-writes.
    """

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value: float = 0.0
        self._lock = threading.Lock()

    def add(self, delta: float = 1.0) -> None:
        with self._lock:
            self.value += delta

    def inc(self, delta: float = 1.0) -> None:
        self.add(delta)

    def set(self, value: float) -> None:
        # plain store is atomic; the lock keeps set/add linearized
        with self._lock:
            self.value = value


class _HistogramSeries:
    """One labeled histogram series: bucket counts + sum + count."""

    __slots__ = ("bounds", "bucket_counts", "sum", "count", "_lock")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)  # +inf overflow bucket
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.bucket_counts[i] += 1
            self.sum += value
            self.count += 1

    def snapshot(self) -> Dict[str, Any]:
        # lock-free: list() copies under the GIL; a concurrent observe can
        # make the copy one observation short in one cell, never corrupt it
        return {
            "buckets": list(zip(self.bounds, self.bucket_counts)),
            "overflow": self.bucket_counts[-1],
            "sum": self.sum,
            "count": self.count,
            "mean": self.sum / self.count if self.count else 0.0,
        }


_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Family:
    """A named metric family: unlabeled series + labeled children."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._children: Dict[_LabelKey, Any] = {}
        self._lock = threading.Lock()  # guards child creation only
        self._default = self._new_series()

    def _new_series(self) -> Any:
        return _Series()

    # -- unlabeled convenience (the common case) -------------------------
    @property
    def value(self) -> float:
        return self._default.value

    def labels(self, **labels: Any) -> Any:
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_series())
        return child

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "kind": self.kind,
            "value": self._series_value(self._default),
        }
        if self._children:
            out["series"] = {
                ",".join(f"{k}={v}" for k, v in key): self._series_value(s)
                for key, s in list(self._children.items())
            }
        return out

    @staticmethod
    def _series_value(s: Any) -> Any:
        return s.value


class Counter(_Family):
    """Monotonically increasing family.  ``add``/``inc`` on the default
    series; ``labels(...)`` for children."""

    kind = "counter"

    def add(self, delta: float = 1.0) -> None:
        self._default.add(delta)

    def inc(self, delta: float = 1.0) -> None:
        self._default.add(delta)


class Gauge(_Family):
    """Set-to-current-value family (pool sizes, occupancies, EMAs)."""

    kind = "gauge"

    def set(self, value: float) -> None:
        self._default.set(value)

    def add(self, delta: float = 1.0) -> None:
        self._default.add(delta)


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets: Optional[Iterable[float]] = None):
        self._bounds = tuple(buckets) if buckets is not None else DEFAULT_BUCKETS
        super().__init__(name, help)

    def _new_series(self) -> Any:
        return _HistogramSeries(self._bounds)

    def observe(self, value: float) -> None:
        self._default.observe(value)

    @staticmethod
    def _series_value(s: Any) -> Any:
        return s.snapshot()


class MetricsRegistry:
    """Process- or component-scoped collection of metric families.

    ``counter``/``gauge``/``histogram`` are get-or-create by name (so two
    components can share a family without coordination), with a kind check:
    re-registering a name as a different type is a bug, not a merge.
    """

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls: type, name: str, help: str, **kw: Any) -> Any:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = self._families[name] = cls(name, help, **kw)
        if not isinstance(fam, cls):
            raise TypeError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"not {cls.__name__.lower()}"
            )
        return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets: Optional[Iterable[float]] = None
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Point-in-time view of every family — read lock-free (see module
        docstring); safe to call from any thread at any rate."""
        return {name: fam.snapshot() for name, fam in list(self._families.items())}

    def values(self) -> Dict[str, float]:
        """Flat {name: default-series value} view (counters/gauges only) —
        what most tests and the dashboard's top-line numbers want."""
        return {
            name: fam.value
            for name, fam in list(self._families.items())
            if fam.kind != "histogram"
        }


# Per-process default registry: background singletons (autoscaler, autotuner,
# orchestrator) report here so one metrics_dump surfaces them all.
_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _DEFAULT
