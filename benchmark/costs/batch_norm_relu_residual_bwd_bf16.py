"""batch_norm_relu_residual_bwd_bf16 (csrc/batch_norm.cu, its bf16 entry): dx
over every row; ints ``(n_rows, d, eps, vec, lanes_log2, chunks,
aligned)``. x, the cotangent, scale, bias and dx are bf16, the mask a byte
a row, the forward's sums ``1 + 2d`` and the column sums ``2d`` f32; 12
operations an element, as the f32 entry."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n_rows, d = ints[:2]
    return ((3 * n_rows * d + 2 * d) * 2 + (1 + 2 * d + 2 * d) * 4 + n_rows, 12 * n_rows * d,
            FP32_OPS_PER_S)
