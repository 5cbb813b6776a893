"""The dry-run and roofline tables from the dry run's records (twin of the
JAX package's ``repro/launch/report.py``), as markdown on stdout.

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List

from .roofline import CARD, HBM_BW, IB_BW, NODE_CARDS, NVLINK_BW, PEAK

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")


def load(out_dir: str) -> List[Dict[str, Any]]:
    rows = []
    for fn in sorted(os.listdir(out_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                rows.append(json.load(f))
    return rows


def fmt_bytes(b: float) -> str:
    return f"{b/1e9:.1f}G" if b >= 1e8 else f"{b/1e6:.0f}M"


def fit_verdict(r: Dict[str, Any]) -> str:
    """"yes", or the lever of a cell whose arguments and temporaries do not
    fit a device's 80 GB (as JAX's report names its levers)."""
    if r.get("fits_hbm_80g"):
        return "yes"
    mem = r["roofline"]["memory_per_device_bytes"]
    levers = []
    if r.get("kind") == "train":
        if (r.get("variant") or {}).get("remat") != "block":
            levers.append("--remat block")
        levers.append("--microbatches")
    else:
        levers.append("a smaller batch")
    levers.append("a larger mesh")
    return (f"NO: does not fit: temporaries {fmt_bytes(mem['temp_bytes'])} of "
            f"{fmt_bytes(mem['per_device_total'])}; try {' / '.join(levers)}")


def dryrun_table(rows: List[Dict[str, Any]], mesh: str) -> str:
    out = [
        f"### Mesh `{mesh}`",
        "",
        "| arch | shape | B x S | status | trace (s) | arguments | temporaries | total a device "
        "| fits 80G HBM |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("mesh") != mesh:
            continue
        bs = f"{r.get('global_batch', '?')} x {r.get('seq_len', '?')}"
        if r["status"] != "OK":
            out.append(f"| {r['arch']} | {r['shape']} | {bs} | {r['status']} | — | — | — | — | "
                       f"{r.get('reason') or r.get('error', '')} |")
            continue
        mem = r["roofline"].get("memory_per_device_bytes") or {}
        out.append(f"| {r['arch']} | {r['shape']} | {bs} | OK | {r.get('trace_s', 0):.1f} | "
                   f"{fmt_bytes(mem['argument_bytes'])} | {fmt_bytes(mem['temp_bytes'])} | "
                   f"{fmt_bytes(mem['per_device_total'])} | {fit_verdict(r)} |")
    return "\n".join(out)


def roofline_table(rows: List[Dict[str, Any]], mesh: str = "one") -> str:
    out = [
        "| arch | shape | FLOPs/step | compute (s) | memory (s) | collective (s) | dominant "
        "| MODEL/counted flops | roofline frac | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("mesh") != mesh or r["status"] != "OK":
            continue
        rl = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rl['flops_per_device']:.4g} | "
            f"{rl['compute_s']:.4g} | {rl['memory_s']:.4g} | {rl['collective_s']:.4g} | "
            f"**{rl['dominant']}** | "
            f"{rl['useful_ratio']:.2f} | {rl['roofline_fraction']:.3f} | {_lever(rl)} |")
    return "\n".join(out)


def _lever(rl: Dict[str, Any]) -> str:
    if rl["dominant"] == "memory":
        if rl["useful_ratio"] < 0.6:
            return "cut remat recompute / padding waste (useful ratio low)"
        return "fuse the elementwise work (the byte count is unfused)"
    if rl["dominant"] == "collective":
        cb = rl.get("collective_breakdown") or {}
        top = max(((k, v) for k, v in cb.items() if k not in ("total", "counts")
                   and isinstance(v, (int, float))), key=lambda kv: kv[1], default=("?", 0))[0]
        return f"reduce {top} volume (reshard or overlap)"
    return "compute-bound: tune the products and kernels toward the tensor-core peak"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.abspath(OUT_DIR))
    args = ap.parse_args()
    rows = load(args.dir)
    ok = sum(1 for r in rows if r["status"] == "OK")
    skip = sum(1 for r in rows if r["status"] == "SKIP")
    print("## Dry run (one H100, meta device)\n")
    print(f"{ok} OK / {skip} SKIP of {len(rows)} cells "
          "(SKIPs: `long_500k` on pure full-attention archs).\n")
    for mesh in sorted({r.get("mesh") for r in rows}):
        print(dryrun_table(rows, mesh))
        print()
    print(f"## Roofline ({CARD})\n")
    print(f"compute = FLOPs / {PEAK:.4g}; memory = bytes / {HBM_BW:.4g}; collective = bytes "
          f"over each mesh axis / its link ({NVLINK_BW:.4g} B/s NVLink in a node of "
          f"{NODE_CARDS}, {IB_BW:.4g} B/s InfiniBand between nodes); all per device. FLOPs "
          "and bytes of one device's program (kernel ops by their formulas; bytes are the "
          "unfused operand and result bytes of every op); collective bytes from "
          "launch/comm_cost.py.\n")
    for mesh in sorted({r.get("mesh") for r in rows}):
        print(f"### Mesh `{mesh}`\n")
        print(roofline_table(rows, mesh))
        print()


if __name__ == "__main__":
    main()
