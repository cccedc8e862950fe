"""sigma_aggregate_bwd_gather (csrc/sigma_aggregate.cu): its backward, an
edge-balanced walk; ints ``(n, n_rows, d, vec)``."""
from benchmark.costs import distinct
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    _, e, d, _ = ints
    er = g["er"]
    n_bytes = (er * d + 2 * e * d + distinct(g, "dst") * 2 * d + distinct(g, "src") * d
               + e + er) * 4
    return n_bytes, 12 * e * d, FP32_OPS_PER_S
