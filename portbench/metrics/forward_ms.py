"""forward_ms: the train step (``repro_torch.train``): device ms a traced
step of the forward - the gradient buffers zeroed, the model run and the
loss - from the program's ``train_phase_seconds{phase=forward}``
(``bench/phases.py``)."""
from portbench.bench.phases import per_step_ms


def read(run):
    return per_step_ms(run, "forward")
