"""epilog_bwd_bf16 (csrc/epilog_bwd.cu, its bf16 entry): the gate epilog's
backward, an edge-balanced walk; ints ``(n, n_rows, d, max_parts, vec)``.
The [E, D] rows and the gathered table are bf16; the [N, 2D] g_sums, the
affine and d_affine f32."""
from benchmark.costs import distinct
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    _, e, d, _, _ = ints
    er = g["er"]
    n_bytes = (5 * e * d + er * d + distinct(g, "src") * d) * 2 \
        + (distinct(g, "dst") * 2 * d + 4 * d) * 4 + (e + er) * 4
    return n_bytes, 18 * e * d, FP32_OPS_PER_S
