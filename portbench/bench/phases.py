"""The train step's phases as the program counts them: the process
registry's ``train_phase_seconds`` histogram (``repro_torch.train.step``'s
phase clock, ``repro_torch.obs``), one series a phase (``forward``,
``backward``, ``optimizer``), each the device seconds between CUDA events
the step records at the phase's start and end while the profiler records,
resolved by ``repro_torch.obs.flush()``.  Only the traced steps (the warm
one and the profiled ones) add to it."""
from __future__ import annotations

from typing import Any, Dict, Optional

SERIES = "train_phase_seconds"


def per_step_ms(run: Dict[str, Any], phase: str) -> Optional[float]:
    """ms a traced step of ``phase``: its sum over the ``optimizer`` count
    (one a step, whatever the microbatches); None without a trace or where
    the program keeps no such series."""
    if run["trace"] is None:
        return None
    import repro_torch.obs as obs

    flush = getattr(obs, "flush", None)
    if flush is None:
        return None
    flush()
    series = obs.get_registry().snapshot().get(SERIES, {}).get("series", {})
    steps = series.get("phase=optimizer", {}).get("count", 0)
    mine = series.get(f"phase={phase}")
    if not steps or not mine:
        return None
    return mine["sum"] / steps * 1e3
