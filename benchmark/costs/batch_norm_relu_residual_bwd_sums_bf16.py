"""batch_norm_relu_residual_bwd_sums_bf16 (csrc/batch_norm.cu, its bf16
entry): the column sums ``[d_scale | d_bias]`` over every row; ints
``(n_rows, d, eps, vec, lanes_log2, chunks, aligned, max_parts)``. x, the
cotangent, scale and bias are bf16; the forward's sums ``1 + 2d``, a
partial row of ``2d`` for each of at most ``max_parts`` blocks and the two
gradients f32; 8 operations an element, as the f32 entry."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n_rows, d, parts = ints[0], ints[1], ints[7]
    return ((2 * n_rows * d + 2 * d) * 2 + (1 + 2 * d + (parts + 1) * 2 * d) * 4,
            8 * n_rows * d, FP32_OPS_PER_S)
