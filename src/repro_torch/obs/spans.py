"""Spans and phase counters of the port, on the profiler's clock.

``span(name)`` marks a stretch of host work.  While ``torch.profiler`` is
recording it opens ``torch.profiler.record_function(name)``, so the span
lies in the profiler's trace on the thread that opened it, beside the
device operations it launched.  Otherwise it returns one shared null
context: the cost of the off path is one check of the profiler's flag.
Tracing is on exactly while the profiler records; there is no setting.

A ``PhaseClock`` times the phases of a loop, each on its device's clock, into
a histogram of a registry that its owner names (``train/step.py``'s
``train_phase_seconds``).  ``clock.span(name, phase, device)`` is ``span(name)``
plus a mark at the phase's start and end: a CUDA event on the device's
current stream, or the host clock for a CPU device.  Phases that run one
after another on one stream split its time between them, idle inside a
phase included.  Nothing waits for the events while the loop runs: they are
held in memory until ``flush()`` resolves them, so read the histogram after
a ``flush()``.

Spans are placed at the boundaries of phases only (four a train step and
its batch, more with microbatches), never per layer or per op.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from typing import Any, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

from .registry import MetricsRegistry, get_registry

__all__ = ["PhaseClock", "flush", "span", "tracing"]

_NULL = contextlib.nullcontext()
_CLOCKS: "weakref.WeakSet[PhaseClock]" = weakref.WeakSet()


def tracing() -> bool:
    """True while ``torch.profiler`` records."""
    return _profiler._is_profiler_enabled


def span(name: str) -> Any:
    """A profiler span ``name`` while the profiler records, else a shared
    null context."""
    return _profiler.record_function(name) if tracing() else _NULL


class PhaseClock:
    """Times phases between marks into ``registry``'s histogram ``series``,
    labelled ``phase=<phase>``, in seconds."""

    def __init__(self, series: str, help: str, registry: Optional[MetricsRegistry] = None):
        self.series, self.help = series, help
        self.registry = registry if registry is not None else get_registry()
        self._pending: List[Tuple[str, Any, Any]] = []
        _CLOCKS.add(self)

    def span(self, name: str, phase: str, device: Any) -> Any:
        """``span(name)`` that also times ``phase`` on ``device`` while the
        profiler records, else the shared null context."""
        if not tracing():
            return _NULL
        return _PhaseSpan(self, name, phase, torch.device(device))

    @staticmethod
    def mark(device: torch.device) -> Any:
        """A CUDA event on ``device``'s current stream, or the host clock."""
        if device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def add(self, phase: str, start: Any, end: Any) -> None:
        """One phase between two marks: host marks at once, a pair of events
        in memory until ``flush()``."""
        if isinstance(end, float):
            self._observe(phase, end - start)
        else:
            self._pending.append((phase, start, end))

    def flush(self) -> None:
        """Resolves every pending interval, waiting for their events."""
        pending, self._pending = self._pending, []
        for phase, start, end in pending:
            end.synchronize()
            self._observe(phase, start.elapsed_time(end) * 1e-3)

    def _observe(self, phase: str, seconds: float) -> None:
        self.registry.histogram(self.series, self.help).labels(phase=phase).observe(seconds)


class _PhaseSpan:
    __slots__ = ("_clock", "_rf", "_phase", "_device", "_start")

    def __init__(self, clock: PhaseClock, name: str, phase: str, device: torch.device):
        self._clock, self._phase, self._device = clock, phase, device
        self._rf = _profiler.record_function(name)

    def __enter__(self) -> "_PhaseSpan":
        self._rf.__enter__()
        self._start = self._clock.mark(self._device)
        return self

    def __exit__(self, *exc: Any) -> None:
        self._clock.add(self._phase, self._start, self._clock.mark(self._device))
        self._rf.__exit__(*exc)


def flush() -> None:
    """Resolves the pending intervals of every phase clock of the process."""
    for clock in list(_CLOCKS):
        clock.flush()
