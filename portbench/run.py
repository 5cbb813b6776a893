"""Runs one cell of the port's benchmark once and prints its result.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with a trace ``breakdown``, ``diagnostics`` (the
set-up's phases, every window step's ms, the check's seconds) and last
``checks``: each number that decides ``correct`` beside its limit (also the
last lines of standard error).  Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits 2; it never falls back to the CPU.
If a module of ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is
loaded once the window has closed, it prints no result and exits 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def cell_metrics(spec: dict, kind: str, cell: str) -> list:
    """The entries of ``spec[kind]`` that the cell reports: those without a
    ``workloads`` list, and those whose list names it."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device,
            chips: int = 1, base=None, root=None) -> dict:
    """The run behind the command line, on ``device`` (tests drive it on the
    CPU; the command line only on a card).  Returns the result object."""
    import torch

    from portbench.bench.layout import BENCH_DIR, benchmark_spec, load_cell, load_module

    base = base or BENCH_DIR
    spec = benchmark_spec(root or ROOT)
    cell = load_cell(cell_name, base)
    found = {}

    def window_closed():
        found["modules"] = forbidden_modules()

    res = cell.driver.run(cell, seed, seconds, trace, device, T_START, window_closed)
    bad = sorted(set(found.get("modules", [])) | set(forbidden_modules()))
    if bad:
        raise ForbiddenModules(bad)
    metrics = {}
    if trace:
        for m in cell_metrics(spec, "per_layer", cell_name):
            value = load_module("metrics", m["name"], base).read(res["layer_run"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(spec, "end_to_end", cell_name):
            if m["name"] in res["metrics"]:
                metrics[m["name"]] = {"value": res["metrics"][m["name"]], "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace:
        dev["busy_s"], dev["window_s"] = res["busy_s"], res["window_s"]
    from portbench.bench.compare import correct

    out = {"correct": correct(res["checks"]), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = res["breakdown"]
    out["diagnostics"] = res["diagnostics"]
    out["checks"] = res["checks"]
    return out


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.bench.layout import load_json

    chips = int(load_json("workloads", args.workload)["chips"])
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark measures the card and never the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), chips)
    except ForbiddenModules as e:
        print(f"portbench: modules of JAX or the JAX package loaded: {e.args[0]}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
