"""batch_norm_relu_residual (csrc/batch_norm.cu): ``relu(BN(x)·scale + bias) +
residual`` over every row from the moments' sums, the BatchNorm's second
pass; ints ``(n_rows, d, eps, vec, lanes_log2, chunks, aligned)``. Reads x,
the residual, scale, bias and the sums ``1 + 2d``, writes out; 6 operations
an element (the normalisation, the affine, the ReLU and the add)."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n_rows, d = ints[:2]
    return (3 * n_rows * d + 2 * d + 1 + 2 * d) * 4, 6 * n_rows * d, FP32_OPS_PER_S
