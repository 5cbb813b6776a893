"""flash_roofline_pct: the flash-attention kernels, forward and backward
(``repro_torch.kernels.flash_attention``): the least time of the traced
steps' flash calls - each call's FLOPs over its visible (query, key) pairs
at the tensor-core peak of the compute dtype, or its bytes at the HBM rate,
the larger (``bench/flash_flops.py``) - over the device time of the flash
kernels.  A call is one launch of its role's ``calls`` pattern; every call
is the cell's causal self-attention over the traffic's whole sequence.
None without a trace and where no flash kernel ran."""
from portbench.bench import flash_flops as FF


def read(run):
    trace, fam = run["trace"], run["families"]
    if trace is None:
        return None
    us = fam.time_us(trace, "flash_attention")
    if us <= 0:
        return None
    cell = run["cell"]
    m, t = cell.config["model"], cell.traffic
    D = m.get("head_dim") or m["d_model"] // m["num_heads"]
    shape = (t["batch"], t["seq"], m["num_heads"], m["num_kv_heads"], D,
             m.get("attn_window", 0), cell.config["precision"]["dtype"])
    least = (fam.calls(trace, "flash_attention", "forward") * FF.flash_bound_s(*shape)
             + fam.calls(trace, "flash_attention", "backward")
             * FF.flash_bound_s(*shape, backward=True))
    return least / (us * 1e-6) * 100.0
