"""Finds the benchmark's pieces by name: every cell, configuration, traffic
mix, source, driver, model family, per-layer metric and kernel family is a
file of its own under ``portbench/``, so a later change adds files and edits
none.

    workloads/<cell>.json      config, traffic, chips, why, limits of `correct`
    configs/<config>.json      the model as it is run, its source and cuts
    traffic/<traffic>.json     the traffic's parameters; ``driver`` and ``source`` name code
    drivers/<driver>.py        runs a cell: set-up, the window, the check
    sources/<source>.py        the generator of batches that the feed reads
    families/<family>.py       the plain reference of a model family
    metrics/<metric>.py        one reader a per-layer metric: ``read(run) -> float | None``
    kernels/<family>/<role>.json   name patterns that attribute device time
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(kind: str, name: str, base: Path = BENCH_DIR) -> Dict[str, Any]:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} "
                       f"({path} is missing)")
    with open(path) as f:
        return json.load(f)


def names(kind: str, suffix: str = ".json", base: Path = BENCH_DIR) -> List[str]:
    """The names of every file of ``kind`` (their stems)."""
    folder = base / kind
    if not folder.is_dir():
        return []
    return sorted(p.name[: -len(suffix)] for p in folder.iterdir()
                  if p.name.endswith(suffix) and not p.name.startswith(("_", ".")))


def load_module(kind: str, name: str, base: Path = BENCH_DIR) -> ModuleType:
    """``<base>/<kind>/<name>.py`` as a module (a name may hold dots and
    dashes, so it is loaded from its file, not imported by name)."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module named {name!r} ({path} is missing)")
    key = f"portbench._{kind}.{name}@{base}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def kernel_families(base: Path = BENCH_DIR) -> Dict[str, List[Dict[str, Any]]]:
    """{family: [{"role", "patterns", "calls"}, ...]} from
    ``kernels/<family>/<role>.json``, families and roles in name order."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    folder = base / "kernels"
    for fam in sorted(p for p in folder.iterdir() if p.is_dir()):
        roles = []
        for path in sorted(fam.glob("*.json")):
            with open(path) as f:
                spec = json.load(f)
            roles.append({"role": path.stem, "patterns": list(spec["patterns"]),
                          "calls": list(spec.get("calls", []))})
        if roles:
            out[fam.name] = roles
    return out


def benchmark_spec(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload with everything its files name, loaded."""

    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    family: ModuleType
    driver: ModuleType
    source: ModuleType
    base: Path

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]

    @property
    def token_ids(self) -> int:
        """How many ids the traffic draws from: the tokenizer's, where the
        embedding is padded past it, else the vocabulary's."""
        m = self.config["model"]
        return m.get("tokenizer_vocab_size", m["vocab_size"])


def load_cell(name: str, base: Path = BENCH_DIR,
              overrides: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name``; ``overrides`` replaces whole top-level entries of
    its workload, config or traffic (``{"config": {...}}``), for tests."""
    overrides = overrides or {}
    workload = overrides.get("workload") or load_json("workloads", name, base)
    config = overrides.get("config") or load_json("configs", workload["config"], base)
    traffic = overrides.get("traffic") or load_json("traffic", workload["traffic"], base)
    return Cell(name=name, workload=workload, config=config, traffic=traffic,
                family=load_module("families", config["family"], base),
                driver=load_module("drivers", traffic["driver"], base),
                source=load_module("sources", traffic["source"], base), base=base)
