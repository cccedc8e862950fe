"""sigma_aggregate_gather_bf16 (csrc/sigma_aggregate.cu, its bf16 entry): the
LayerNorm layer's forward sigma-weighted sums, the neighbour rows gathered
inside; ints ``(n, d, vec)``. e_new and the gathered table bf16, the
[N, 2D] sums f32."""
from benchmark.costs import distinct
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n, d, _ = ints
    er = g["er"]
    return ((er * d + distinct(g, "src") * d) * 2 + 2 * n * d * 4 + (n + 1 + er) * 4,
            5 * g["e"] * d, FP32_OPS_PER_S)
