"""layer_norm_relu_residual (csrc/layer_norm.cu): ``relu(LN(x)·scale +
bias) + residual`` over rows; ints ``(n_rows, d, eps, vec, lanes_log2,
chunks, aligned)``. Reads x, the residual, scale and bias, writes out;
about 10 operations an element (the two row sums, the normalisation, the
affine, the ReLU and the add)."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n_rows, d = ints[:2]
    return (3 * n_rows * d + 2 * d) * 4, 10 * n_rows * d, FP32_OPS_PER_S
