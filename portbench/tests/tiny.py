"""Tiny cells for the CPU tests: a copy of ``portbench/`` (and of
``BENCHMARK.json``) in a temporary folder with a tiny configuration of a
family, a tiny traffic mix and a workload that runs them under the limits of
a real cell."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.bench.layout import BENCH_DIR, ROOT

# attn_impl "pallas": the SSD goes through ``ssd_scan`` (on the CPU its plain version), the
# call the check reads on the card
SSM = dict(num_layers=2, d_model=64, vocab_size=256, tokenizer_vocab_size=250, ssm_state=16,
           ssm_head_dim=16, ssm_chunk=16, attn_impl="pallas")
# (configuration, tiny sizes); every tiny cell takes the limits of LIMITS_OF
CELLS = {"ssm": ("mamba2-2.7b", SSM)}
LIMITS_OF = "mamba2-2.7b.train.s2048"
TRAFFIC = "train.b4.s2048"


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def copy_bench(tmp: Path) -> Path:
    """A copy of the benchmark's folder and ``BENCHMARK.json`` under
    ``tmp``; returns the copy's ``portbench`` folder."""
    base = tmp / "portbench"
    shutil.copytree(BENCH_DIR, base, ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return base


def add_tiny(base: Path, family: str, batch: int = 2, seq: int = 48) -> str:
    """Adds ``tiny-<family>.cell``: the family's configuration at tiny
    widths computed in f32 (the port's plain CPU route), ``batch`` rows of
    ``seq`` tokens, the limits of the benchmark's cell ``LIMITS_OF``."""
    config, model = CELLS[family]
    cfg = json.loads((base / "configs" / f"{config}.json").read_text())
    cfg["model"].update(model)
    cfg["precision"]["dtype"] = "float32"
    cfg["name"] = f"tiny-{family}"
    write(base / "configs" / f"tiny-{family}.json", cfg)
    tr = json.loads((base / "traffic" / f"{TRAFFIC}.json").read_text())
    tr.update(name="tiny", batch=batch, seq=seq)
    write(base / "traffic" / f"tiny-{family}.json", tr)
    limits = json.loads((base / "workloads" / f"{LIMITS_OF}.json").read_text())["limits"]
    name = f"tiny-{family}.cell"
    write(base / "workloads" / f"{name}.json",
          {"name": name, "config": f"tiny-{family}", "traffic": f"tiny-{family}", "chips": 1,
           "why": "a CPU test", "limits": limits})
    return name
