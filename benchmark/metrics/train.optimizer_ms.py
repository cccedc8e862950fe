"""train.optimizer_ms (ms): device time a traced optimizer step of the
kernels launched inside the program's ``train.optimizer`` spans: Adam's
``zero_grad`` and ``step`` (``benchmark/spans.py``)."""
from benchmark.spans import per_step_ms


def read(view):
    return per_step_ms(view, "optimizer")
