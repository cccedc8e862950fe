"""gate_front_bwd_bf16 (csrc/gate_front_bwd.cu, its bf16 entry): the gate's
total cotangent (bf16) and its f32 column sum; ints
``(n_rows, n_real, d, n_parts, vec)``. d_gate, gate and d_total bf16;
d_mom and d_bias3 f32."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    e, _, d, _, _ = ints
    return 3 * e * d * 2 + 3 * d * 4, 5 * e * d, FP32_OPS_PER_S
