"""layer_norm_relu_residual_bf16 (csrc/layer_norm.cu, its bf16 entry):
``relu(LN(x)·scale + bias) + residual`` over bf16 rows; ints ``(n_rows, d,
eps, vec, lanes_log2, chunks, aligned)``. Reads x, the residual, scale and
bias, writes out, all bf16 (the statistics are taken in f32 in registers);
about 10 operations an element, as the f32 entry."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n_rows, d = ints[:2]
    return (3 * n_rows * d + 2 * d) * 2, 10 * n_rows * d, FP32_OPS_PER_S
