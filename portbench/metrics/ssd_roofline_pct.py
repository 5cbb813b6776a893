"""ssd_roofline_pct: the ``ssd_scan`` kernels, forward and backward
(``repro_torch.kernels.ssd_scan``): the least time of the traced steps' SSD
calls - f32 inputs priced at the TF32 tensor-core peak, bf16 at the bf16
peak, or their bytes at the HBM rate (``bench/flops.py``) - over the device
time of the SSD kernels (the backward's recomputed chunk states included,
which its FLOP count prices)."""
from portbench.bench import flops as FL


def read(run):
    trace, fam = run["trace"], run["families"]
    if trace is None:
        return None
    us = fam.time_us(trace, "ssd_scan")
    if us <= 0:
        return None
    m, t = run["cell"].config["model"], run["cell"].traffic
    di = m["ssm_expand"] * m["d_model"]
    # the f32 params promote the convolution's output: the scan takes f32 inputs
    dtype = "float32" if run["cell"].config["precision"]["param_dtype"] == "float32" else \
        run["cell"].config["precision"]["dtype"]
    shape = (t["batch"], t["seq"], di // m["ssm_head_dim"], m["ssm_head_dim"], m["ssm_state"],
             m["ssm_groups"], m["ssm_chunk"], dtype)
    least = (fam.calls(trace, "ssd_scan", "forward") * FL.ssd_bound_s(*shape)
             + fam.calls(trace, "ssd_scan", "backward") * FL.ssd_bound_s(*shape, backward=True))
    return least / (us * 1e-6) * 100.0
