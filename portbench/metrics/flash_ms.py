"""flash_ms: the flash-attention kernels, forward and backward
(``repro_torch.kernels.flash_attention``): device ms a traced step of the
kernels that ``kernels/flash_attention/`` names.  None without a trace and
where no flash kernel ran (a cell without attention, a run on the CPU)."""


def read(run):
    trace = run["trace"]
    if trace is None or not trace.device:
        return None
    us = run["families"].time_us(trace, "flash_attention")
    return us / trace.steps * 1e-3 if us > 0 else None
