"""matmul_ms: the model's projections, MLP and head
(``repro_torch.models.layers``, ``lm``): device ms a step of the GEMM
kernels (``kernels/matmul/``) in the traced steps."""


def read(run):
    trace = run["trace"]
    if trace is None or not trace.device:
        return None
    us = run["families"].time_us(trace, "matmul")
    return us / trace.steps * 1e-3 if us > 0 else None
