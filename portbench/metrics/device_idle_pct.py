"""device_idle_pct: the device: the share of the traced window in which no
operation ran on the card (the union of the device ops' intervals)."""
from portbench.bench.trace import busy_s


def read(run):
    trace = run["trace"]
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    return (1.0 - busy_s(trace) / trace.window_s) * 100.0
