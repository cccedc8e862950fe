"""gate_front (csrc/gate_front.cu): ``gate = b1h[src] + b2h[dst] + e W3 + b3``
and the BatchNorm sums; ints ``(n_rows, n_real, d, n_parts, vec)``. The
product runs on the tensor cores as three TF32 products (split-TF32)."""
from benchmark.costs import distinct
from benchmark.peaks import TF32_TC_OPS_PER_S


def cost(ints, g):
    e, _, d, _, _ = ints
    n_bytes = (2 * e * d + (distinct(g, "src") + distinct(g, "dst")) * d + d * d + 3 * d) * 4 \
        + 2 * e * 4
    return n_bytes, 3 * 2 * e * d * d, TF32_TC_OPS_PER_S
