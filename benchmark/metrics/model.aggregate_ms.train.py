"""model.aggregate_ms.train (ms): device time a traced optimizer step of the
kernels of the program's ``aggregate`` spans (``models/gated_gcn.py``: the
σ sums through ``a1h + h_fwd + h_bwd``; on the BatchNorm branch with the
gate epilog, on the LayerNorm branch with the σ-aggregate): their forward,
their recompute and, through each autograd node's sequence number, their
backward (``benchmark/layer_spans.py``)."""
from benchmark.layer_spans import per_step_ms


def read(view):
    return per_step_ms(view, "aggregate")
