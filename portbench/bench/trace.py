"""The traced steps and their reduction: ``torch.profiler`` over a few
steps, read back from its Chrome trace into device intervals and the main
thread's host ops, then kernel families, busy time and idle gaps.

The traced window is the benchmark's annotation ``portbench.traced`` on the
main thread, which opens and closes on a device synchronisation, so every
device operation of its steps lies inside it.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

WINDOW = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


@dataclass
class Trace:
    window: Tuple[float, float]  # us, host clock of the trace
    steps: int
    device: List[Tuple[str, float, float]] = field(default_factory=list)  # name, ts, dur (us)
    host: List[Tuple[str, float, float]] = field(default_factory=list)  # main thread's ops

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6


def record(run_steps: Callable[[int], None], steps: int, cuda: bool, sync: Callable[[], None]
           ) -> Trace:
    """Profiles one warm step and then ``steps`` steps inside the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        run_steps(1)
        sync()
        with record_function(WINDOW):
            run_steps(steps)
            sync()
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events, steps)


def parse(events: List[Dict[str, Any]], steps: int) -> Trace:
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError(f"the trace has no {WINDOW!r} annotation")
    mark = marks[0]
    t0, t1 = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
    tid = mark.get("tid")
    out = Trace(window=(t0, t1), steps=steps)
    for e in spans:
        ts, dur = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            a, b = max(ts, t0), min(ts + dur, t1)
            if b > a:
                out.device.append((e["name"], a, b - a))
        elif e.get("cat") in HOST_CATS and e.get("tid") == tid and e is not mark:
            if ts < t1 and ts + dur > t0:
                out.host.append((e["name"], ts, dur))
    return out


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
class Families:
    """Kernel-name patterns of each family and role (``kernels/``): a device
    op belongs to the first family, in name order, whose patterns match."""

    def __init__(self, tables: Dict[str, List[Dict[str, Any]]]):
        self.rules = [(fam, r["role"], [re.compile(p) for p in r["patterns"]],
                       [re.compile(p) for p in r["calls"]])
                      for fam, roles in sorted(tables.items()) for r in roles]

    def of(self, name: str) -> Optional[Tuple[str, str]]:
        for fam, role, pats, _ in self.rules:
            if any(p.search(name) for p in pats):
                return fam, role
        return None

    def time_us(self, trace: Trace, family: str) -> float:
        return sum(d for n, _, d in trace.device if (self.of(n) or ("",))[0] == family)

    def calls(self, trace: Trace, family: str, role: str) -> int:
        """Launches that mark one call of the role (its ``calls`` patterns)."""
        pats = [c for fam, r, _, cs in self.rules if fam == family and r == role for c in cs]
        return sum(1 for n, _, _ in trace.device if any(p.search(n) for p in pats))


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void\s+", "", name).split("(")[0].split("<")[0]
    return name.rsplit("::", 1)[-1][:64] or name[:64]


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which some operation ran on the device."""
    return sum(b - a for a, b in merged([(t, t + d) for _, t, d in trace.device])) * 1e-6


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """(start, end) in us of every stretch of the window with no device op."""
    gaps, t = [], trace.window[0]
    for a, b in merged([(t0, t0 + d) for _, t0, d in trace.device]):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if trace.window[1] > t:
        gaps.append((t, trace.window[1]))
    return gaps


def host_activity(trace: Trace, at: float) -> str:
    """What the main thread ran at ``at``: its outermost benchmark
    annotation and its innermost op there."""
    around = [(dur, name) for name, ts, dur in trace.host if ts <= at <= ts + dur]
    if not around:
        return "host: no op"
    marks = [n for _, n in sorted(around, reverse=True) if n.startswith("portbench.")]
    inner = min(around)[1]
    return f"{marks[0]} > {inner}" if marks and marks[0] != inner else inner


def breakdown(trace: Trace, families: Families) -> Dict[str, List[List[Any]]]:
    """The device ops that took most time (by kernel family, else by short
    name) and the longest idle gaps by what the host was running, each in
    seconds over the traced window."""
    ops: Dict[str, float] = {}
    for name, _, dur in trace.device:
        fam = families.of(name)
        key = f"{fam[0]}.{fam[1]}" if fam else short_name(name)
        ops[key] = ops.get(key, 0.0) + dur * 1e-6
    gaps: Dict[str, float] = {}
    for a, b in idle_gaps(trace):
        key = host_activity(trace, 0.5 * (a + b))
        gaps[key] = gaps.get(key, 0.0) + (b - a) * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    longest = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in longest]}
