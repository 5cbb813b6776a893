"""mfu_pct: the whole train step (``repro_torch.train``): the model's own
FLOPs a step (the family's ``model_flops``: 6 N T for the matmuls, the
attention's visible pairs, the SSD's work; nothing recomputed) times the
window's steps, over the window's seconds, as a share of the card's bf16
peak of 989e12 FLOP/s.  Read from the un-profiled window."""
from portbench.bench.flops import PEAK_FLOPS


def read(run):
    cell, win = run["cell"], run["window"]
    if not win["steps"] or win["seconds"] <= 0:
        return None
    flops = cell.family.model_flops(cell.config["model"], cell.traffic["batch"],
                                    cell.traffic["seq"])
    return flops * win["steps"] / win["seconds"] / PEAK_FLOPS["bfloat16"] * 100.0
