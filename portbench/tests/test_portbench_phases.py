"""The train step's phase metrics (``forward_ms``, ``backward_ms``,
``optimizer_ms``, ``backward_idle_ms``).  On the tiny SSM cell on the CPU a
``--trace 1`` run reports the three phases (on the host clock there), they
add up to the traced steps' mean interval, and a run that traced nothing
reads None, not what an earlier run of the process left in its registry;
the run is a fresh process, so its registry starts empty as the
benchmark's does.  ``backward_idle_ms`` reads device intervals, which a CPU
run has none of: it reads None there, and is checked on a trace made by
hand."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from portbench.bench import layout
from portbench.bench.trace import Trace, host_activity
from portbench.tests.tiny import add_tiny, copy_bench, write

ROOT = layout.ROOT
PHASES = ("forward_ms", "backward_ms", "optimizer_ms")
METRICS = PHASES + ("backward_idle_ms",)


def _run_code(code, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_traced_run_reports_the_phases_and_an_untraced_one_reads_none(tmp_path):
    base = copy_bench(tmp_path)
    cell = add_tiny(base, "ssm")
    # the phases count the warm step too, the interval only the profiled
    # ones: on a shared CPU one step can stray by tens of percent
    traffic = json.loads((base / "traffic" / "tiny-ssm.json").read_text())
    traffic["profiled_steps"] = 12
    write(base / "traffic" / "tiny-ssm.json", traffic)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append(cell)
    write(tmp_path / "BENCHMARK.json", spec)
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(tmp_path)!r}]
        import torch
        import portbench.run as run
        from portbench.bench.layout import load_cell, load_module
        base, cpu = run.Path({str(base)!r}), torch.device("cpu")
        traced = run.execute({cell!r}, 2 ** 31 + 5, 0.2, True, cpu, base=base,
                             root=run.Path({str(tmp_path)!r}))
        c = load_cell({cell!r}, base)
        res = c.driver.run(c, 2 ** 31 + 6, 0.2, False, cpu, time.perf_counter())
        later = {{m: load_module("metrics", m, base).read(res["layer_run"])
                 for m in {list(METRICS)!r}}}
        print(json.dumps({{"traced": traced, "later": later,
                          "steps": c.traffic["profiled_steps"]}}))
    """)
    out = _run_code(code, tmp_path)
    traced = out["traced"]
    # `correct` is not asserted: on the CPU the driver's copy of the SSD call
    # (`FirstCall`) shares D's storage, which the later steps update (PERF.md §7)
    assert traced["attempted"] > 12 and traced["failed"] == 0
    assert "backward_idle_ms" not in traced["metrics"]  # no device on the CPU
    got = {m: traced["metrics"][m]["value"] for m in PHASES}
    assert all(v > 0 for v in got.values())
    step_ms = traced["device"]["window_s"] / out["steps"] * 1e3
    assert sum(got.values()) == pytest.approx(step_ms, rel=0.05)
    assert out["later"] == {m: None for m in METRICS}


def test_backward_idle_is_the_device_idle_inside_the_backward_spans():
    """Two steps on a hand-made trace (us): the device idle 10-20, 50-70 and
    90-100; the backward spans 15-60 and 85-95; 5 + 10 + 5 us of their idle."""
    read = layout.load_module("metrics", "backward_idle_ms").read
    device = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 70.0, 20.0)]
    host = [("portbench.step", 0.0, 100.0), ("train.backward", 15.0, 45.0),
            ("train.backward", 85.0, 10.0), ("aten::mm", 20.0, 5.0)]
    trace = Trace(window=(0.0, 100.0), steps=2, device=device, host=host)
    assert read({"trace": trace}) == pytest.approx(20.0 / 2 * 1e-3)
    assert host_activity(trace, 55.0) == "portbench.step > train.backward"
    for empty in (Trace((0.0, 100.0), 2, device, host[:1]), Trace((0.0, 100.0), 2, [], host)):
        assert read({"trace": empty}) is None
    assert read({"trace": None}) is None
