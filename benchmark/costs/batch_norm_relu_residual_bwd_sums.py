"""batch_norm_relu_residual_bwd_sums (csrc/batch_norm.cu): the column sums
``[d_scale | d_bias] = [Σ gy·xh | Σ gy]`` over every row, the backward's
first pass; ints ``(n_rows, d, eps, vec, lanes_log2, chunks, aligned,
max_parts)``. Reads x, the cotangent, scale, bias and the forward's sums
``1 + 2d``, writes a partial row of ``2d`` for each of at most
``max_parts`` blocks and the two gradients; 8 operations an element (the
normalisation and affine again, the mask, the two sums)."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n_rows, d, parts = ints[0], ints[1], ints[7]
    return ((2 * n_rows * d + 2 * d + 1 + 2 * d + (parts + 1) * 2 * d) * 4, 8 * n_rows * d,
            FP32_OPS_PER_S)
