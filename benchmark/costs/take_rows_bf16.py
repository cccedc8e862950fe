"""take_rows_bf16 (csrc/take.cu, its bf16 entry): ``out[k] = table[ids[k]]``
on bf16 rows; ints ``(n_ids, n_rows, d, vec)``. The distinct rows read are
taken as the fewer of the two endpoint counts (the gathered side is not in
the arguments)."""
from benchmark.costs import distinct
from benchmark.peaks import FP32_OPS_PER_S


def cost(ints, g):
    n_ids, n_rows, d, _ = ints
    rows = min(n_rows, distinct(g, "src"), distinct(g, "dst"))
    return (rows * d + n_ids * d) * 2 + n_ids * 4, 0, FP32_OPS_PER_S
