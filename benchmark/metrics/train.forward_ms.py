"""train.forward_ms (ms): device time a traced optimizer step of the
kernels launched inside the program's ``train.forward`` span: the model's
forward and the loss (``benchmark/spans.py``)."""
from benchmark.spans import per_step_ms


def read(view):
    return per_step_ms(view, "forward")
