"""The port's spans and phase counters (``repro_torch.obs.spans``) and their
placement in the train step, the optimizer and the feeder, on the CPU: the
spans lie in the profiler's trace on the threads that opened them; the
phases go to the process registry, beside the feed's series; with the
profiler off nothing is entered and nothing is recorded."""
import json
import time

import numpy as np
import pytest

pytest.importorskip("torch")
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config
from repro_torch.feed import DeviceFeeder, FeedMetrics
from repro_torch.models import build_model
from repro_torch.obs import MetricsRegistry, PhaseClock, flush, get_registry, span, tracing
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.step import PHASES as TRAIN_PHASES

PHASES = ("forward", "backward", "optimizer")
MAIN = "test.main_thread"
FEED_SERIES = ("feed_steps", "feed_batches_fetched", "feed_idle_time", "feed_fetch_time",
               "feed_transfer_time", "feed_compute_time", "feed_bytes_to_device",
               "feed_queue_depth")


class _Root:
    span_id = "root"

    def child(self):
        return "child"


class _Tracer:
    """The session tracer's interface as the feeder uses it."""

    def __init__(self):
        self.names = []

    def should_sample(self):
        return True

    def record(self, name, ctx, start, dur, parent_id=None, **attrs):
        self.names.append(name)


class _Session:
    def __init__(self, batches, tracer):
        self.batches, self.tracer = batches, tracer
        self.trace_root = _Root() if tracer is not None else None

    def __iter__(self):
        return iter(self.batches)

    def close(self):
        pass


class _Source:
    """A distributed dataset's stand-in: ``session()`` yields ``batches``."""

    def __init__(self, batches, tracer=None):
        self.batches, self.tracer = batches, tracer

    def session(self, **overrides):
        return _Session(self.batches, self.tracer)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("mamba2-2.7b").scaled_down()
    model = build_model(cfg)
    state = init_train_state(model, 0, AdamWConfig(), device="cpu")
    rng = np.random.default_rng(0)
    batches = [{k: rng.integers(1, cfg.vocab_size, (2, 32)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(16)]
    return model, state, batches


def _phases(registry=None, series=TRAIN_PHASES.series):
    """{phase: (count, sum)} of the phase histogram now."""
    fam = (registry or get_registry()).snapshot().get(series, {})
    series = fam.get("series", {})
    return {p: (series.get(f"phase={p}", {}).get("count", 0),
                series.get(f"phase={p}", {}).get("sum", 0.0)) for p in PHASES}


def _steps(tiny, n, microbatches=1, tracer=None, traced=True, host_s=None):
    """``n`` steps fed by a ``DeviceFeeder`` (after one untraced), under the
    profiler when ``traced``; returns the Chrome trace's events (or None)."""
    model, state, batches = tiny
    step = make_train_step(model, AdamWConfig(), microbatches=microbatches)
    with DeviceFeeder(_Source(batches, tracer), device="cpu") as feeder:
        step(state, feeder.next())
        if not traced:
            for _ in range(n):
                step(state, feeder.next())
            return None
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(MAIN):  # marks the main thread in the trace
                for _ in range(n):
                    batch = feeder.next()
                    t0 = time.perf_counter()
                    step(state, batch)
                    if host_s is not None:
                        host_s.append(time.perf_counter() - t0)
    return _events(prof)


def _events(prof):
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _annotations(events):
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_tracing_follows_the_profiler():
    assert not tracing()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing()
    assert not tracing()


def test_off_path_is_one_shared_null_context():
    a, b = TRAIN_PHASES.span("train.forward", "forward", "cpu"), span("feed.wait")
    assert a is b
    with a:
        pass


@pytest.mark.parametrize("microbatches", [1, 2])
def test_a_traced_step_holds_its_spans_nested_on_the_main_thread(tiny, microbatches):
    events = _steps(tiny, 1, microbatches)
    marks = _annotations(events)
    main_span = next(e for e in marks if e["name"] == MAIN)
    main = main_span["tid"]
    by = {n: [e for e in marks if e["name"] == n] for n in
          ("train.forward", "train.backward", "train.optimizer", "feed.wait")}
    assert len(by["train.forward"]) == len(by["train.backward"]) == microbatches
    assert len(by["train.optimizer"]) == len(by["feed.wait"]) == 1
    for name, es in by.items():
        assert all(e["tid"] == main for e in es), name  # the consumer is the main thread
        assert all(_inside(e, main_span) for e in es), name
    opt = by["train.optimizer"][0]
    order = sorted(by["train.forward"] + by["train.backward"] + [opt], key=lambda e: e["ts"])
    assert [e["name"] for e in order] == ["train.forward", "train.backward"] * microbatches + [
        "train.optimizer"]
    for a, b in zip(order, order[1:]):  # one after another, none overlapping
        assert a["ts"] + a["dur"] <= b["ts"]
    assert by["feed.wait"][0]["ts"] + by["feed.wait"][0]["dur"] <= order[0]["ts"]


def test_with_the_profiler_off_record_function_is_never_entered(tiny, monkeypatch):
    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(autograd_profiler, "record_function", Refused)
    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    before = _phases()
    _steps(tiny, 2, traced=False)
    _steps(tiny, 1, microbatches=2, traced=False)
    assert _phases() == before  # nothing recorded outside the profiler


def test_a_session_tracer_still_receives_the_feed_spans(tiny):
    tracer = _Tracer()
    _steps(tiny, 2, tracer=tracer, traced=False)
    assert tracer.names.count("feed.fetch") >= 3
    assert tracer.names.count("feed.device_put") >= 3


@pytest.mark.parametrize("microbatches", [1, 2])
def test_phase_counts_equal_the_traced_steps_and_sum_to_their_time(tiny, microbatches):
    before, host_s, n = _phases(), [], 3
    _steps(tiny, n, microbatches, host_s=host_s)
    flush()
    after = _phases()
    got = {p: (after[p][0] - before[p][0], after[p][1] - before[p][1]) for p in PHASES}
    assert got["optimizer"][0] == n
    assert got["forward"][0] == got["backward"][0] == n * microbatches
    total = sum(s for _, s in got.values())
    assert total == pytest.approx(sum(host_s), rel=0.05)
    assert all(s > 0 for _, s in got.values())


def test_one_snapshot_shows_the_feed_beside_the_train_phases(tiny):
    model, state, batches = tiny
    step = make_train_step(model, AdamWConfig())
    with DeviceFeeder(_Source(batches), device="cpu") as feeder:
        assert feeder.metrics.registry is get_registry()
        with profile(activities=[ProfilerActivity.CPU]):
            step(state, feeder.next())
    flush()
    snap = get_registry().snapshot()
    assert set(FEED_SERIES) <= set(snap) and TRAIN_PHASES.series in snap
    # every feeder of the process adds to the same series
    assert snap["feed_steps"]["value"] >= feeder.metrics.steps >= 1
    assert snap["feed_bytes_to_device"]["value"] >= feeder.metrics.bytes_to_device > 0
    assert FeedMetrics().registry is not get_registry()


def test_feed_metrics_mirror_every_field_in_their_registry():
    m = FeedMetrics(registry=MetricsRegistry())
    m.add_fetch(0.25)
    m.add_transfer(0.5, 2048)
    m.add_step(idle=0.125, compute=1.0, depth_frac=1.0)
    want = {"feed_steps": 1, "feed_batches_fetched": 1, "feed_idle_time": 0.125,
            "feed_fetch_time": 0.25, "feed_transfer_time": 0.5, "feed_compute_time": 1.0,
            "feed_bytes_to_device": 2048, "feed_queue_depth": 0.2}
    assert m.registry.values() == pytest.approx(want)


class _Event:
    """A CUDA event's interface: its time, the stream it was recorded on,
    whether it was waited for."""

    def __init__(self, t=0.0, enable_timing=False):
        self.t, self.stream, self.waited = t, None, 0

    def record(self, stream=None):
        self.stream = stream

    def synchronize(self):
        self.waited += 1

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_phase_clock_holds_events_until_flush_then_resolves_them_all():
    reg = MetricsRegistry()
    clock = PhaseClock("loop_phase_seconds", "a loop's phases", reg)
    events = [_Event(t) for t in (0.0, 1.0, 1.0, 3.5, 3.5, 4.0, 5.0, 5.5)]
    for phase, (a, b) in zip(PHASES + ("forward",), zip(events[::2], events[1::2])):
        clock.add(phase, a, b)
    assert reg.snapshot() == {}  # nothing waited for, nothing resolved
    assert not any(e.waited for e in events)
    clock.flush()
    assert _phases(reg, clock.series) == {"forward": (2, pytest.approx(1.5)),
                                          "backward": (1, pytest.approx(2.5)),
                                          "optimizer": (1, pytest.approx(0.5))}
    assert [e.waited for e in events[1::2]] == [1] * 4
    clock.flush()  # nothing left
    assert _phases(reg, clock.series)["optimizer"][0] == 1
    clock.add("optimizer", 10.0, 10.25)  # host marks resolve at once
    assert _phases(reg, clock.series)["optimizer"] == (2, pytest.approx(0.75))
    assert TRAIN_PHASES.series not in reg.snapshot()  # the owner names the series


def test_a_cuda_phase_is_marked_on_its_own_devices_current_stream(monkeypatch):
    streams = []

    def current_stream(device):
        streams.append(device)
        return ("stream", device)

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    clock = PhaseClock("loop_phase_seconds", "a loop's phases", MetricsRegistry())
    with profile(activities=[ProfilerActivity.CPU]):
        with clock.span("loop.step", "forward", "cuda:1"):
            pass
    [(phase, start, end)] = clock._pending
    assert phase == "forward" and streams == [torch.device("cuda", 1)] * 2
    assert start.stream == end.stream == ("stream", torch.device("cuda", 1))


def test_a_cpu_step_keeps_the_host_clock_where_cuda_has_started(tiny, monkeypatch):
    """The clock follows the step's device, not whether the process has
    initialised CUDA: a CPU step records no CUDA event."""
    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("a CUDA event for a CPU step")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Refused)
    before, host_s, n = _phases(), [], 2
    _steps(tiny, n, host_s=host_s)
    assert not TRAIN_PHASES._pending  # host marks resolve at once
    after = _phases()
    assert after["optimizer"][0] - before["optimizer"][0] == n
    total = sum(after[p][1] - before[p][1] for p in PHASES)
    assert total == pytest.approx(sum(host_s), rel=0.05)
