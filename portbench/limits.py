"""Readings that set the limits of ``correct`` for one cell, on the card.

    python portbench/limits.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 1,2,3 [--out limits.jsonl]

For each seed of ``--seeds``: the program's set-up steps (the harness's own
``Program.first_steps``: the same weights, feed and step as a run) against
the plain reference in f32 - the lower readings.  For each seed of
``--control-seeds`` (a subset): the controls - the reference in e4m3
(``precision="fp8"``), and with only the SSD's products in TF32 or bf16
(``"ssd_tf32"``, ``"ssd_bf16"``) - and the faults "half_batch" and
"unchanged" planted in the reference, each in the program's place against
the f32 reference - the upper readings.  Where the family names a kernel
call (``KERNEL_CALL``), its number for the program's call, and for the
reference's work on that call's inputs with the products in TF32 or bf16
(``control_ssd_*_call``).  One JSON line a reading, to standard output and
to ``--out``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench.bench import compare, reference
    from portbench.bench.layout import load_cell

    if not torch.cuda.is_available():
        print("limits: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    driver = cell.driver
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    m = cell.config["model"]
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        rec = {"workload": args.workload, "card": torch.cuda.get_device_name(device), **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    for seed in seeds:
        t = time.perf_counter()
        prog = driver.Program(cell, seed, device)
        readings = prog.first_steps()
        torch.cuda.synchronize()
        t_prog = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(device)
        prog.close()
        del prog
        free()
        torch.cuda.reset_peak_memory_stats(device)
        batches = cell.source.batches(cell.traffic, cell.token_ids, seed,
                                      cell.traffic["setup_steps"])
        t = time.perf_counter()
        ref = reference.train_steps(cell.family, m, cell.config["optimizer"],
                                    cell.traffic["schedule"], seed, batches, device)
        t_ref = time.perf_counter() - t
        emit({"seed": seed, "side": "reference", "pieces": pieces(ref)})
        kernel = {}
        number = getattr(cell.family, "KERNEL_NUMBER", None)
        if number is not None:
            call = readings.get("kernel_call")
            kernel = {number: driver.kernel_gap(cell, call, device)}
            if seed in controls:
                for lower in ("tf32", "bf16"):
                    emit({"seed": seed, "side": f"control_ssd_{lower}_call",
                          number: driver.kernel_gap(cell, call, device, lower)})
        emit({"seed": seed, "side": "program", **kernel,
              **compare.gaps(readings, ref), "pieces": pieces(readings),
              "losses": readings["losses"], "ref_losses": ref["losses"],
              "program_s": t_prog, "reference_s": t_ref, "program_peak_bytes": peak,
              "reference_peak_bytes": torch.cuda.max_memory_allocated(device),
              "worst": worst(readings, ref)})
        del readings
        free()
        if seed in controls:
            for side, kw in (("control_fp8", {"precision": "fp8"}),
                             ("control_ssd_tf32", {"precision": "ssd_tf32"}),
                             ("control_ssd_bf16", {"precision": "ssd_bf16"}),
                             ("fault_half_batch", {"fault": "half_batch"}),
                             ("fault_unchanged", {"fault": "unchanged"})):
                t = time.perf_counter()
                other = reference.train_steps(cell.family, m, cell.config["optimizer"],
                                              cell.traffic["schedule"], seed, batches, device,
                                              **kw)
                emit({"seed": seed, "side": side, **compare.gaps(other, ref),
                      "pieces": pieces(other),
                      "losses": other["losses"], "seconds": time.perf_counter() - t,
                      "worst": worst(other, ref)})
                del other
                free()
        del ref
        free()
    return 0


def pieces(readings):
    return {"grad1": readings["grad1"], "update": readings["update"]}


def worst(prog, ref):
    """The three pieces of largest gap, for each of the two piece numbers."""
    from portbench.bench import compare
    import statistics

    out = {}
    for key in ("grad1", "update"):
        floor = statistics.median(ref[key].values())
        names = compare.moved(ref["grad1"]) if key == "update" else list(ref[key])
        gaps = sorted(((abs(prog[key][n] - ref[key][n]) / max(ref[key][n], floor), n)
                       for n in names), reverse=True)[:3]
        out[key] = [[n, g, prog[key][n], ref[key][n]] for g, n in gaps]
    return out


if __name__ == "__main__":
    sys.exit(main())
