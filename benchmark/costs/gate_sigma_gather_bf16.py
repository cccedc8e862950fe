"""gate_sigma_gather_bf16 (csrc/gate_epilog.cu, its bf16 entry): the gate's
BatchNorm affine, ReLU and residual, and the forward sigma-weighted sums
over the in-edges; ints ``(n, n_rows, d, vec)``. gate, e_in, e_new and the
gathered table are bf16; the affine and the [N, 2D] sums f32."""
from benchmark.costs import distinct
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n, e, d, _ = ints
    return ((3 * e * d + distinct(g, "src") * d) * 2 + (2 * d + 2 * n * d) * 4
            + (n + 1 + e) * 4, 8 * e * d, FP32_OPS_PER_S)
