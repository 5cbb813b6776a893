"""backward_ms: the train step (``repro_torch.train``): device ms a traced
step of the backward (``loss.backward()``, the layers' recompute under
remat included), from the program's ``train_phase_seconds{phase=backward}``
(``bench/phases.py``)."""
from portbench.bench.phases import per_step_ms


def read(run):
    return per_step_ms(run, "backward")
