"""model.gate_ms.train (ms): device time a traced optimizer step of the
kernels of the program's ``gate`` spans (``models/gated_gcn.py``: the edge
gate up to its norm; the gate front on the BatchNorm branch, the endpoint
gathers, ``B3·e`` and the adds on the LayerNorm branch): their forward,
their recompute and, through each autograd node's sequence number, their
backward (``benchmark/layer_spans.py``)."""
from benchmark.layer_spans import per_step_ms


def read(view):
    return per_step_ms(view, "gate")
