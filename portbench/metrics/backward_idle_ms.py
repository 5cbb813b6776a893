"""backward_idle_ms: the train step (``repro_torch.train``): ms a traced
step in which the device ran no operation while the main thread was inside
the program's ``train.backward`` span (its idle gaps intersected with those
spans, from the trace).  None without device operations in the trace (a
run on the CPU) and where the program has no such span."""
from portbench.bench.trace import idle_gaps, merged


def read(run):
    trace = run["trace"]
    if trace is None or not trace.device or not trace.steps:
        return None
    spans = merged([(ts, ts + dur) for name, ts, dur in trace.host if name == "train.backward"])
    if not spans:
        return None
    us = sum(max(0.0, min(b, d) - max(a, c)) for a, b in idle_gaps(trace) for c, d in spans)
    return us / trace.steps * 1e-3
