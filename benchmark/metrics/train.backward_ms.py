"""train.backward_ms (ms): device time a traced optimizer step of the
kernels launched inside the program's ``train.backward`` span, less the
recomputed layer forwards (``train.recompute_ms``; ``benchmark/spans.py``)."""
from benchmark.spans import per_step_ms


def read(view):
    return per_step_ms(view, "backward")
