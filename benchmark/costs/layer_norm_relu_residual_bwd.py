"""layer_norm_relu_residual_bwd (csrc/layer_norm.cu): dx and the column
sums ``[d_scale | d_bias]``; ints ``(n_rows, d, eps, vec, lanes_log2,
chunks, aligned, max_parts)``. Reads x, the cotangent, scale and bias,
writes dx and the two gradients, and a partial row of both for each of
at most ``max_parts`` blocks; about 20 operations an element (the
forward's statistics again, the mask, the two row sums of the gradient, dx
and the two column sums)."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n_rows, d, parts = ints[0], ints[1], ints[7]
    return (3 * n_rows * d + 4 * d + 2 * parts * d) * 4, 20 * n_rows * d, FP32_OPS_PER_S
