"""A tiny cell of the dense family for the CPU tests, beside ``tiny.py``'s:
starcoder2-3b's published block (LayerNorm, biases, GELU MLP, tied head, a
window shorter than the sequence) at tiny widths in f32, under the limits
of the benchmark's cell ``LIMITS_OF``."""
from __future__ import annotations

import json
from pathlib import Path

from portbench.tests.tiny import write

CONFIG = "starcoder2-3b"
# attn_impl "pallas" (the file's): attention goes through ``flash_attention``
# (on the CPU its plain version), the call the check reads on the card
DENSE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=256, attn_window=16)
LIMITS_OF = "starcoder2-3b.train.s8192"
TRAFFIC = "train.b1.s8192"


def add_tiny_dense(base: Path, batch: int = 2, seq: int = 48, name: str = "tiny-dense",
                   **model) -> str:
    """Adds ``<name>.cell``: the dense configuration at ``DENSE``'s widths
    (and ``model``'s changes) in f32, ``batch`` rows of ``seq`` tokens;
    returns the cell's name."""
    cfg = json.loads((base / "configs" / f"{CONFIG}.json").read_text())
    cfg["model"].update(DENSE, **model)
    cfg["precision"]["dtype"] = "float32"
    cfg["name"] = name
    write(base / "configs" / f"{name}.json", cfg)
    tr = json.loads((base / "traffic" / f"{TRAFFIC}.json").read_text())
    tr.update(name=name, batch=batch, seq=seq)
    write(base / "traffic" / f"{name}.json", tr)
    limits = json.loads((base / "workloads" / f"{LIMITS_OF}.json").read_text())["limits"]
    cell = f"{name}.cell"
    write(base / "workloads" / f"{cell}.json",
          {"name": cell, "config": name, "traffic": name, "chips": 1, "why": "a CPU test",
           "limits": limits})
    return cell
