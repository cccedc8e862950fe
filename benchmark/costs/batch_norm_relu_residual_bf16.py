"""batch_norm_relu_residual_bf16 (csrc/batch_norm.cu, its bf16 entry):
``relu(BN(x)·scale + bias) + residual`` over every bf16 row from the f32
moments' sums; ints ``(n_rows, d, eps, vec, lanes_log2, chunks,
aligned)``. Reads x, the residual, scale and bias (bf16) and the sums ``1 +
2d`` (f32), writes out (bf16); 6 operations an element, as the f32 entry."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n_rows, d = ints[:2]
    return (3 * n_rows * d + 2 * d) * 2 + (1 + 2 * d) * 4, 6 * n_rows * d, FP32_OPS_PER_S
