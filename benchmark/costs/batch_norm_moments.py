"""batch_norm_moments (csrc/batch_norm.cu): the column sums ``[count | Σx |
Σx²]`` of the rows where the mask is set, the BatchNorm's first pass; ints
``(n_rows, d, vec, lanes_log2, chunks, aligned, max_parts)``. Reads the
mask (a byte a row) and x on the real rows only (the graph's real nodes
where the launch runs over its padded nodes), writes a partial row of
``1 + 2d`` for each of at most ``max_parts`` blocks and the sums; 3
operations an element read (the add and the square's fused multiply-add)."""
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n_rows, d, parts = ints[0], ints[1], ints[6]
    real = g["nr"] if n_rows == g["n"] else n_rows
    width = 1 + 2 * d
    return real * d * 4 + n_rows + (parts + 1) * width * 4, 3 * real * d, FP32_OPS_PER_S
