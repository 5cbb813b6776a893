"""peak_mem_gb: the device: ``torch.cuda.max_memory_allocated()`` over the
window, after ``reset_peak_memory_stats()`` at its start, in GB (1e9)."""


def read(run):
    peak = run["peak_window_bytes"]
    return peak / 1e9 if peak else None
