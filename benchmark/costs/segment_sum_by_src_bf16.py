"""segment_sum_by_src_bf16 (csrc/segment_sum.cu, its bf16 entry): per node
the f32 sum of its out-edges' bf16 rows through the by_src order; ints
``(n, d, vec)``."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n, d, _ = ints
    return g["er"] * d * 2 + (n * d + n + 1 + g["er"]) * 4, g["e"] * d, FP32_OPS_PER_S
