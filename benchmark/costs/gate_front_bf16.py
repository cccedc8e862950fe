"""gate_front_bf16 (csrc/gate_front.cu, its bf16 entry): ``gate = b1h[src] +
b2h[dst] + e W3 + b3`` in bf16 and the BatchNorm sums in f32; ints
``(n_rows, n_real, d, n_parts, bn, stages)``. e and gate, both tables, W3
and b3 are bf16, the sums f32; the product is one bf16 tensor-core product
with an f32 accumulator."""
from benchmark.costs import distinct
from benchmark.peaks import BF16_TC_OPS_PER_S


def cost(ints, g):
    e, _, d = ints[:3]
    n_bytes = (2 * e * d + (distinct(g, "src") + distinct(g, "dst")) * d + d * d + d) * 2 \
        + 2 * d * 4 + 2 * e * 4
    return n_bytes, 2 * e * d * d, BF16_TC_OPS_PER_S
