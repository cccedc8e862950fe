"""segment_sum_by_dst_bf16 (csrc/segment_sum.cu, its bf16 entry): per node
the f32 sum of its in-edges' bf16 rows, canonical order; ints
``(n, d, vec)``."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n, d, _ = ints
    return g["er"] * d * 2 + (n * d + n + 1) * 4, g["e"] * d, FP32_OPS_PER_S
