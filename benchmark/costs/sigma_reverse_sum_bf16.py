"""sigma_reverse_sum_bf16 (csrc/reverse_sum.cu, its bf16 entry): the reverse
sigma-weighted sums over each node's out-edges; ints ``(n, d, vec)``. e_new
and the table bf16, the [N, 2D] sums f32."""
from benchmark.costs import distinct
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n, d, _ = ints
    er = g["er"]
    return ((er * d + distinct(g, "dst") * d) * 2 + 2 * n * d * 4 + (2 * er + n + 1) * 4,
            5 * g["e"] * d, FP32_OPS_PER_S)
