"""rev_bwd (csrc/rev_bwd.cu): the reverse aggregation's backward; ints
``(n, n_rows, d, vec)``."""
from benchmark.costs import distinct
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    _, e, d, _ = ints
    er = g["er"]
    n_bytes = (er * d + 2 * e * d + distinct(g, "src") * 2 * d + distinct(g, "dst") * d
               + 2 * e + er) * 4
    return n_bytes, 12 * e * d, FP32_OPS_PER_S
