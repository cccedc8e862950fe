"""batch_norm_relu_residual_bwd (csrc/batch_norm.cu): dx over every row, the
backward's second pass; ints ``(n_rows, d, eps, vec, lanes_log2, chunks,
aligned)``. Reads x, the cotangent, the mask (a byte a row), scale, bias,
the forward's sums ``1 + 2d`` and the column sums ``2d``, writes dx; 12
operations an element (the normalisation and affine again, the mask, dx's
two terms)."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n_rows, d = ints[:2]
    return ((3 * n_rows * d + 2 * d + 1 + 2 * d + 2 * d) * 4 + n_rows, 12 * n_rows * d,
            FP32_OPS_PER_S)
