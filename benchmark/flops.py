"""Model FLOPs of a training step, from the shapes: three forwards' worth of
the configuration's reference ``forward_flops`` (``benchmark/reference/``;
the backward takes the product with each input and with each weight). The
recompute of a checkpointed layer is not counted, being no model FLOP.
"""
from benchmark import reference


def step_flops(model: dict, n: int, e: int) -> int:
    """``model``: the configuration's dict; ``n``, ``e``: real nodes and edges."""
    return 3 * reference.load(model).forward_flops(model, n, e)
