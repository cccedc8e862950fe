"""rev_bwd_bf16 (csrc/rev_bwd.cu, its bf16 entry): the reverse aggregation's
backward; ints ``(n, n_rows, d, vec)``. The [E, D] rows and the gathered
table are bf16; the [N, 2D] g_sums f32."""
from benchmark.costs import distinct
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    _, e, d, _ = ints
    er = g["er"]
    n_bytes = (er * d + 2 * e * d + distinct(g, "dst") * d) * 2 \
        + distinct(g, "src") * 2 * d * 4 + (2 * e + er) * 4
    return n_bytes, 12 * e * d, FP32_OPS_PER_S
