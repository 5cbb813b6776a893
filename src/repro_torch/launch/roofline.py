"""Roofline of a dry-run cell on one NVIDIA H100 (twin of the JAX package's
``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs a device / 989e12 bf16 FLOP/s
    memory     = bytes a device / 3.35e12 B/s HBM
    collective = sum over mesh axes of collective bytes a device / link rate

The constants are the card's own (H100 SXM, dense bf16; ``flops.PEAK_FLOPS``
and ``flops.HBM_BYTES_PER_S``) and its system's links: NVLink 4 within an
8-card HGX H100 node, and one 400 Gb/s InfiniBand NDR port a card between
nodes.  A mesh axis whose group spans more than one node of 8 takes the
slower rate (``link_rate``); ranks are numbered in the mesh's row-major
order, 8 to a node.  On one card no collective runs and the term is 0.

FLOPs come from the step on ``meta`` (one card: ``FlopCounterMode``; a
mesh: the local program of one device, ``dryrun.count_partitioned``), with
each kernel op charged its formula (``kernels._shape``); bytes are the
operand and result bytes of every op the step runs, an unfused upper
estimate of XLA's "bytes accessed".  The collective bytes are
``comm_cost``'s, the twin of JAX's ``parse_collective_bytes`` and
``hlo_cost`` (which read them from XLA's partitioned HLO).

``memory_per_device_bytes`` carries the dry run's memory fields, JAX's:
``argument_bytes``, ``output_bytes``, ``temp_bytes`` (``launch.memory``),
``alias_bytes`` and ``per_device_total = argument_bytes + temp_bytes``.

MODEL_FLOPS = 6.N.D for training (N params, active params for MoE; D
tokens), 2.N_active.tokens for forward-only (prefill/decode) cells; the
ratio MODEL/counted flags remat and attention work beyond 6.N.D.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional

from .flops import HBM_BYTES_PER_S, PEAK_FLOPS

PEAK = PEAK_FLOPS["bfloat16"]
HBM_BW = HBM_BYTES_PER_S
CARD = "NVIDIA H100 80GB HBM3 (SXM), dense bf16"
# NVIDIA HGX H100 (8 x H100 SXM5): NVLink 4, 18 links of 25 GB/s = 450 GB/s a
# direction a card (900 GB/s both ways, NVIDIA's H100 datasheet)
NVLINK_BW = 450e9
# between nodes: one ConnectX-7 400 Gb/s NDR InfiniBand port a card (the DGX
# H100 reference design), 50 GB/s a direction
IB_BW = 50e9
NODE_CARDS = 8


def link_rate(axis: str, mesh_sizes: Dict[str, int]) -> float:
    """Bytes/s a card sends over ``axis``'s group: NVLink when the group
    lies in one node of ``NODE_CARDS`` (its dim and every faster dim fit),
    else InfiniBand.  "world" is a group of the whole mesh."""
    names = list(mesh_sizes)
    if axis not in names:
        span = math.prod(mesh_sizes.values())
    else:
        span = math.prod(mesh_sizes[n] for n in names[names.index(axis):])
    return NVLINK_BW if span <= NODE_CARDS else IB_BW


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device quantities counted over the step on meta
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    # derived terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
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
                 cost: Dict[str, Any], mem: Dict[str, Any], cfg, shape, kind: str,
                 note: str = "", mesh_sizes: Optional[Dict[str, int]] = None) -> RooflineReport:
    """The report of one cell from ``cost`` = {"flops", "bytes",
    "collective_bytes"} per device, counted over the step on ``meta``, and
    on a mesh ``"collectives"``: ``comm_cost``'s detail, whose bytes by mesh
    axis (``mesh_sizes``: the mesh's axis names and sizes) each go at their
    axis's ``link_rate``."""
    flops_dev = float(cost["flops"])
    bytes_dev = float(cost["bytes"])
    coll_dev = float(cost.get("collective_bytes", 0.0))
    coll: Dict[str, Any] = dict(cost.get("collectives") or {"total": coll_dev, "counts": {}})
    rates = {a: link_rate(a, mesh_sizes or {}) for a in coll.get("by_axis", {})}
    if rates:
        coll["link_bytes_per_s"] = rates
    compute_s = flops_dev / PEAK
    memory_s = bytes_dev / HBM_BW
    collective_s = sum(b / rates[a] for a, b in coll.get("by_axis", {}).items())
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
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
