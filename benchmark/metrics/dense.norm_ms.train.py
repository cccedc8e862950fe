"""dense.norm_ms.train (ms): device time a traced optimizer step of the
kernels of the program's ``norm`` spans (``ops/norm.py``, the BatchNorm
gate's affine): their forward, their recompute and, through each autograd
node's sequence number, their backward (``benchmark/spans.py``)."""
from benchmark.spans import per_step_ms


def read(view):
    return per_step_ms(view, "norm")
