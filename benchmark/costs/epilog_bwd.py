"""epilog_bwd (csrc/epilog_bwd.cu): the gate epilog's backward, an
edge-balanced walk; ints ``(n, n_rows, d, max_parts, vec)``. gate and the
cotangent of e_new are read and three outputs written on every row, e_new
read on the real rows."""
from benchmark.costs import distinct
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    _, e, d, _, _ = ints
    er = g["er"]
    n_bytes = (5 * e * d + er * d + distinct(g, "dst") * 2 * d + distinct(g, "src") * d
               + 4 * d + e + er) * 4
    return n_bytes, 18 * e * d, FP32_OPS_PER_S
