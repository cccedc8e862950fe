"""train.recompute_ms (ms): device time a traced optimizer step of the
kernels of the layer forwards that remat ``"layer"`` runs again in the
backward: launched under a ``model.layer`` span inside ``train.backward``
(``benchmark/spans.py``)."""
from benchmark.spans import per_step_ms


def read(view):
    return per_step_ms(view, "recompute")
