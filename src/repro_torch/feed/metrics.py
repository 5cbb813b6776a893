"""Feed-side stall accounting (twin of the JAX package's
``repro/feed/metrics.py``: the same fields and the same ``feed_*`` series).

The paper's diagnosis ("input-bound fraction", §2) is measured at the
CLIENT; this module measures one hop later, where it actually hurts: how
long the accelerator sat idle because the next batch was not already on
device.  The feeder splits every consumed step into three exclusive
buckets —

  fetch     time its transfer thread spent blocked on the host iterator
            (the data service could not keep up),
  transfer  time spent staging a batch in pinned memory and copying it
            to the device (host→device bandwidth),
  compute   time the consumer spent between ``next()`` calls (the train
            step itself),

— plus the headline number, ``idle_s``: wall time the consumer blocked in
``next()`` waiting for a device-resident batch.  ``idle_s`` is what the
double buffer exists to drive to zero; its per-step value and the
fetch/transfer split are also what the feeder reports upstream as the
autoscaler's client-latency signal (Cachew-style: scale the worker pool on
what the *consumer* observes, not on worker-local buffer occupancy).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..obs.registry import MetricsRegistry


@dataclass
class FeedMetrics:
    """Cumulative counters for one ``DeviceFeeder`` session.

    Updated from two threads (transfer thread: ``fetch_s``/``transfer_s``/
    ``batches_fetched``/``bytes_to_device``; consumer thread: the rest), so
    mutation goes through the ``add_*`` helpers which hold ``_lock``.

    The dataclass fields stay the source of truth — ``StallWindow`` and the
    feeder tests read them directly under ``_lock`` — but every write is
    mirrored into ``registry`` (``feed_*`` families) so the feeder shows up
    in metrics dumps alongside the client/worker registries.
    """

    steps: int = 0  # batches handed to the consumer
    batches_fetched: int = 0  # batches pulled from the service
    idle_s: float = 0.0  # consumer blocked in next(): accelerator idle
    fetch_s: float = 0.0  # transfer thread blocked on the host iterator
    transfer_s: float = 0.0  # host->device placement time
    compute_s: float = 0.0  # consumer time between next() calls
    bytes_to_device: int = 0
    queue_depth_ema: float = 0.0  # device-queue fill observed at next()
    registry: Optional[MetricsRegistry] = field(default=None, repr=False, compare=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def __post_init__(self) -> None:
        if self.registry is None:
            self.registry = MetricsRegistry()
        self._series = {
            "steps": self.registry.counter("feed_steps", "batches handed to the consumer"),
            "batches_fetched": self.registry.counter(
                "feed_batches_fetched", "batches pulled from the data service"
            ),
            "idle_s": self.registry.counter(
                "feed_idle_time", "consumer wall time blocked in next()"
            ),
            "fetch_s": self.registry.counter(
                "feed_fetch_time", "transfer thread blocked on the host iterator"
            ),
            "transfer_s": self.registry.counter(
                "feed_transfer_time", "host->device placement time"
            ),
            "compute_s": self.registry.counter(
                "feed_compute_time", "consumer time between next() calls"
            ),
            "bytes_to_device": self.registry.counter(
                "feed_bytes_to_device", "bytes placed on device"
            ),
            "queue_depth_ema": self.registry.gauge(
                "feed_queue_depth", "device-queue fill EMA observed at next()"
            ),
        }

    # -- writers (thread-safe) -------------------------------------------
    def add_fetch(self, seconds: float) -> None:
        with self._lock:
            self.fetch_s += seconds
            self.batches_fetched += 1
        self._series["fetch_s"].add(seconds)
        self._series["batches_fetched"].inc()

    def add_transfer(self, seconds: float, nbytes: int) -> None:
        with self._lock:
            self.transfer_s += seconds
            self.bytes_to_device += nbytes
        self._series["transfer_s"].add(seconds)
        self._series["bytes_to_device"].add(nbytes)

    def add_step(self, idle: float, compute: Optional[float], depth_frac: float) -> None:
        with self._lock:
            self.steps += 1
            self.idle_s += idle
            if compute is not None:
                self.compute_s += compute
            self.queue_depth_ema = 0.8 * self.queue_depth_ema + 0.2 * depth_frac
            depth_ema = self.queue_depth_ema
        self._series["steps"].inc()
        self._series["idle_s"].add(idle)
        if compute is not None:
            self._series["compute_s"].add(compute)
        self._series["queue_depth_ema"].set(depth_ema)

    # -- derived ----------------------------------------------------------
    @property
    def idle_s_per_step(self) -> float:
        return self.idle_s / self.steps if self.steps else 0.0

    @property
    def stall_fraction(self) -> float:
        """Fraction of the consumer's wall time spent waiting for data —
        the feed-side twin of the paper's input-bound fraction."""
        wall = self.idle_s + self.compute_s
        return self.idle_s / wall if wall > 0 else 0.0

    def breakdown(self) -> Dict[str, float]:
        """fetch / transfer / compute shares of total accounted time."""
        total = self.fetch_s + self.transfer_s + self.compute_s
        if total <= 0:
            return {"fetch": 0.0, "transfer": 0.0, "compute": 0.0}
        return {
            "fetch": self.fetch_s / total,
            "transfer": self.transfer_s / total,
            "compute": self.compute_s / total,
        }

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "steps": self.steps,
                "batches_fetched": self.batches_fetched,
                "idle_s": self.idle_s,
                "idle_s_per_step": self.idle_s_per_step,
                "stall_frac": self.stall_fraction,
                "fetch_s": self.fetch_s,
                "transfer_s": self.transfer_s,
                "compute_s": self.compute_s,
                "bytes_to_device": self.bytes_to_device,
                "queue_depth_ema": self.queue_depth_ema,
            }
        out["breakdown"] = self.breakdown()
        return out


class StallWindow:
    """Rolling delta over ``FeedMetrics`` for periodic upstream reports.

    The autoscaler wants the *recent* stall fraction, not the session
    cumulative (a long healthy run would mask a fresh stall, and a slow
    warmup would read as a permanent one).  ``report()`` returns the stats
    for the window since the previous call, or ``None`` when no step
    completed in the window.
    """

    def __init__(self, metrics: FeedMetrics):
        self._m = metrics
        self._steps = 0
        self._idle = 0.0
        self._compute = 0.0
        self._fetch = 0.0
        self._transfer = 0.0

    def report(self) -> Optional[Dict[str, float]]:
        m = self._m
        with m._lock:
            d_steps = m.steps - self._steps
            if d_steps <= 0:
                return None
            d_idle = m.idle_s - self._idle
            d_compute = m.compute_s - self._compute
            d_fetch = m.fetch_s - self._fetch
            d_transfer = m.transfer_s - self._transfer
            depth = m.queue_depth_ema
            self._steps, self._idle = m.steps, m.idle_s
            self._compute, self._fetch = m.compute_s, m.fetch_s
            self._transfer = m.transfer_s
        wall = d_idle + d_compute
        return {
            "stall_frac": d_idle / wall if wall > 0 else 0.0,
            "idle_s_per_step": d_idle / d_steps,
            "fetch_s_per_step": d_fetch / d_steps,
            "transfer_s_per_step": d_transfer / d_steps,
            "queue_depth": depth,
            "steps": float(d_steps),
        }
