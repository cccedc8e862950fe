"""sigma_aggregate_bwd_gather_bf16 (csrc/sigma_aggregate.cu, its bf16 entry):
its backward, an edge-balanced walk; ints ``(n, n_rows, d, vec)``. The
[E, D] rows (e_new's real rows in, d_e and d_v out) and the gathered table
bf16; the [N, 2D] g_sums f32."""
from benchmark.costs import distinct
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    _, e, d, _ = ints
    er = g["er"]
    n_bytes = (er * d + 2 * e * d + distinct(g, "src") * d) * 2 \
        + distinct(g, "dst") * 2 * d * 4 + (e + er) * 4
    return n_bytes, 12 * e * d, FP32_OPS_PER_S
