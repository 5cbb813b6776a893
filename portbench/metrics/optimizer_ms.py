"""optimizer_ms: the train step (``repro_torch.train``): device ms a traced
step of the optimizer - the gradient norm, the host read of the clip scale
and AdamW - from the program's ``train_phase_seconds{phase=optimizer}``
(``bench/phases.py``)."""
from portbench.bench.phases import per_step_ms


def read(run):
    return per_step_ms(run, "optimizer")
