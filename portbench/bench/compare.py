"""The numbers that decide ``correct`` for a training cell, each against
the limit its workload file sets.

    batch_mismatches  batches the step received that differ from the
                      source's batches of the seed (exact; limit 0)
    loss_gap          the largest |loss - reference loss| / |reference loss|
                      over the reference's steps
    grad_gap          the worst leaf's |norm - reference norm| of the first
                      gradient as AdamW takes it (after clipping), over the
                      larger of the reference's norm of the leaf and of the
                      median leaf
    update_gap        the same of the parameters' change over the reference's
                      steps, over the leaves whose reference gradient is at
                      least ``MOVED`` of the median leaf's

    ssd_gap           (a family's kernel number) the largest |y - y_ref| of
                      one kernel call of the timed path, over the largest
                      |y_ref|: the program's output against the reference's
                      f32 work on the call's own inputs

The readings come by piece - a leaf, or one layer of a leaf stacked over
layers - and are judged by the program's leaves: a leaf's norm is the root of
its pieces' squared norms.  A reading that is not finite is infinite, and
fails any limit.
"""
from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List, Optional, Sequence

MOVED = 1e-3  # a reference gradient under this share of the median leaf's: round-off only


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) != len(ref):
        return math.inf
    return _finite(max(abs(p - r) / abs(r) for p, r in zip(prog, ref)))


def piece_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Sequence[str]] = None) -> float:
    if set(prog) != set(ref):
        return math.inf
    floor = statistics.median(ref.values())
    names = list(ref) if keep is None else list(keep)
    return _finite(max(abs(prog[n] - ref[n]) / max(ref[n], floor) for n in names))


def moved(ref_grad1: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding."""
    floor = MOVED * statistics.median(ref_grad1.values())
    return [n for n, g in ref_grad1.items() if g >= floor]


def by_leaf(pieces: Dict[str, float]) -> Dict[str, float]:
    """Norms by leaf from norms by piece ("path[layer]" is a piece of path)."""
    squares: Dict[str, float] = {}
    for name, norm in pieces.items():
        leaf = name.split("[")[0]
        squares[leaf] = squares.get(leaf, 0.0) + norm * norm
    return {leaf: math.sqrt(sq) for leaf, sq in squares.items()}


def gaps(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """loss_gap, grad_gap and update_gap of the program's readings against
    the reference's (``reference.train_steps``' keys), by leaf."""
    pg, rg = by_leaf(prog["grad1"]), by_leaf(ref["grad1"])
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": piece_gap(pg, rg),
            "update_gap": piece_gap(by_leaf(prog["update"]), by_leaf(ref["update"]), moved(rg))}


def output_gap(got, want) -> float:
    """max |got - want| / max |want| of two tensors."""
    scale = float(want.abs().max())
    return _finite(float((got.float() - want).abs().max()) / scale) if scale > 0 else math.inf


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} in the limits' order; a number with no
    limit is an error of the workload file."""
    missing = set(values) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    return {k: {"value": values[k], "limit": limits[k]} for k in limits if k in values}


def correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
