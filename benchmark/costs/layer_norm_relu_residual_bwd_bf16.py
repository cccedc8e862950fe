"""layer_norm_relu_residual_bwd_bf16 (csrc/layer_norm.cu, its bf16 entry): dx
and the column sums ``[d_scale | d_bias]``; ints ``(n_rows, d, eps, vec,
lanes_log2, chunks, aligned, max_parts)``. x, the cotangent, scale, bias
and dx are bf16; the two gradients and a partial row of both for each of
at most ``max_parts`` blocks f32; about 20 operations an element, as the
f32 entry."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n_rows, d, parts = ints[0], ints[1], ints[7]
    return ((3 * n_rows * d + 2 * d) * 2 + (2 * d + 2 * parts * d) * 4, 20 * n_rows * d,
            FP32_OPS_PER_S)
