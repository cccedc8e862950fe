"""gate_front_bwd (csrc/gate_front_bwd.cu): the gate's total cotangent and
its column sum; ints ``(n_rows, n_real, d, n_parts, vec)``."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    e, _, d, _, _ = ints
    return (3 * e * d + 3 * d) * 4, 5 * e * d, FP32_OPS_PER_S
