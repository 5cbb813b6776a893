"""Roofline of a dry-run cell on one NVIDIA H100 (twin of the JAX package's
``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs / (chips x 989e12 bf16 FLOP/s)
    memory     = bytes / (chips x 3.35e12 B/s HBM)
    collective = collective bytes / (chips x link rate)

The constants are the card's own (H100 SXM, dense bf16; ``flops.PEAK_FLOPS``
and ``flops.HBM_BYTES_PER_S``).  On one card no collective runs, so the
collective term is 0 and no link rate is needed.  On the production meshes
(256 and 512 chips) the collective bytes are unknown: JAX reads them from the
partitioned HLO, and an eager step on ``meta`` runs none.  The report then
holds null for them and leaves the term out of ``dominant`` and
``roofline_fraction``, rather than count it as 0.

FLOPs come from ``FlopCounterMode`` over the step on ``meta``, with each
kernel op charged its formula (``kernels._shape``); bytes are the operand
and result bytes of every op the step runs, an unfused upper estimate of
XLA's "bytes accessed".  JAX's ``parse_collective_bytes`` and ``hlo_cost``
parse XLA's HLO text, which an eager PyTorch step does not produce, so they
have no twin.

MODEL_FLOPS = 6.N.D for training (N params, active params for MoE; D
tokens), 2.N_active.tokens for forward-only (prefill/decode) cells; the
ratio MODEL/counted flags remat and attention work beyond 6.N.D.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional

from .flops import HBM_BYTES_PER_S, PEAK_FLOPS

PEAK = PEAK_FLOPS["bfloat16"]
HBM_BW = HBM_BYTES_PER_S
CARD = "NVIDIA H100 80GB HBM3 (SXM), dense bf16"


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device quantities counted over the step on meta
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: Optional[float]  # None: not countable
    # derived terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    dominant: str
    # accounting
    model_flops_total: float
    hlo_flops_total: float  # the counted FLOPs of all chips (JAX's field name)
    useful_ratio: float  # MODEL_FLOPS / counted FLOPs (total)
    roofline_fraction: float  # compute_s / max(all terms): compute-bound = 1
    memory_per_device_bytes: Dict[str, Any]
    collective_breakdown: Dict[str, Any]
    note: str = ""

    def to_json(self) -> Dict[str, Any]:
        return asdict(self)


def model_flops(cfg, shape, kind: str, chips: int) -> float:
    """6.N.D train, 2.N.D forward-only (N = active params)."""
    n_active = cfg.param_counts()["active"]
    if kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    # decode: ONE new token per sequence
    return 2.0 * n_active * shape.global_batch


def build_report(arch: str, shape_name: str, mesh_name: str, chips: int,
                 cost: Dict[str, float], mem: Dict[str, Any], cfg, shape, kind: str,
                 note: str = "") -> RooflineReport:
    """The report of one cell from ``cost`` = {"flops", "bytes",
    "collective_bytes"} per device, counted over the step on ``meta``; a
    ``collective_bytes`` of None (not countable) leaves the term out."""
    flops_dev = float(cost["flops"])
    bytes_dev = float(cost["bytes"])
    coll_dev = cost.get("collective_bytes", 0.0)
    coll = {"total": coll_dev, "counts": {} if coll_dev is not None else None}
    compute_s = flops_dev / PEAK
    memory_s = bytes_dev / HBM_BW
    collective_s = 0.0 if coll_dev is not None else None  # one card: no collective
    terms = {"compute": compute_s, "memory": memory_s}
    if collective_s is not None:
        terms["collective"] = collective_s
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, kind, chips)
    total = flops_dev * chips
    bound = max(terms.values())
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll_dev,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops_total=mf, hlo_flops_total=total,
        useful_ratio=mf / total if total else 0.0,
        roofline_fraction=compute_s / bound if bound > 0 else 0.0,
        memory_per_device_bytes=mem, collective_breakdown=coll, note=note)
