"""The kernel costs and the MFU's FLOP count against numbers worked by hand
at a small shape: N = 10 nodes, E = 40 edge rows (30 real), D = 8, every
node an endpoint (u_src = u_dst = 10)."""
import pytest

from benchmark import costs, flops
from benchmark.peaks import FP32_OPS_PER_S, TF32_TC_OPS_PER_S, bound_s

G = dict(n=10, e=40, nr=10, er=30, u_src=10, u_dst=10)
D = 8
# entry: (integer arguments, bytes, operations, peak) worked by hand
CASES = {
    # 10 rows of 8, 40 ids, 40 rows out: (80 + 40 + 320) * 4
    "take_rows": ((40, 10, D, 1), 1760, 0, FP32_OPS_PER_S),
    # 30 real rows of 8 in, 10 sums of 8 out, 11 offsets: (240 + 80 + 11) * 4
    "segment_sum_by_dst": ((10, D, 1), 1324, 320, FP32_OPS_PER_S),
    # ... and the 30 ids of the by_src order
    "segment_sum_by_src": ((10, D, 1), 1444, 320, FP32_OPS_PER_S),
    # e and gate (2*40*8), both tables (20*8), W3 (64), b3 and the sums (24); ids 2*40
    "gate_front": ((40, 30, D, 1, 1), (640 + 160 + 64 + 24) * 4 + 320, 3 * 2 * 40 * 64,
                   TF32_TC_OPS_PER_S),
    # gate, e_in, e_new (3*320), a table (80), affine (16), sums (160); offsets, src
    "gate_sigma_gather": ((10, 40, D, 1), (960 + 80 + 16 + 160) * 4 + 51 * 4, 8 * 320,
                          FP32_OPS_PER_S),
    "sigma_reverse_sum": ((10, D, 1), (240 + 80 + 160) * 4 + 71 * 4, 5 * 320, FP32_OPS_PER_S),
    "gate_front_bwd": ((40, 30, D, 1, 1), (960 + 24) * 4, 5 * 320, FP32_OPS_PER_S),
    "epilog_bwd": ((10, 40, D, 1024, 1), (1600 + 240 + 160 + 80 + 32 + 70) * 4, 18 * 320,
                   FP32_OPS_PER_S),
    "rev_bwd": ((10, 40, D, 1), (240 + 640 + 160 + 80 + 110) * 4, 12 * 320, FP32_OPS_PER_S),
    "sigma_aggregate_gather": ((10, D, 1), (240 + 80 + 160) * 4 + 41 * 4, 5 * 320,
                               FP32_OPS_PER_S),
    "sigma_aggregate_bwd_gather": ((10, 40, D, 1), (240 + 640 + 160 + 80 + 70) * 4, 12 * 320,
                                   FP32_OPS_PER_S),
}


@pytest.mark.parametrize("entry", sorted(CASES))
def test_cost(entry):
    ints, n_bytes, n_ops, peak = CASES[entry]
    assert costs.load(entry)(ints, G) == (n_bytes, n_ops, peak)


def test_unknown_entry_has_no_cost():
    assert costs.load("no_such_entry") is None


def test_bound_is_the_larger_time():
    assert bound_s(3.35e12, 0, 1e12) == 1.0
    assert bound_s(0, 2e12, 1e12) == 2.0


def test_flops_by_hand():
    model = dict(hidden_features=4, nb_pos_enc=2, hidden_edge_features=3,
                 hidden_edge_scores=5, edge_features=2, num_gnn_layers=2)
    n, e = 7, 11
    layers = 2 * (5 * 2 * 7 * 16 + 2 * 11 * 16)  # 2 * (1120 + 352)
    encoders = 2 * 7 * 4 * 4 + 2 * 11 * (2 * 3 + 3 * 4)  # 224 + 396
    head = 2 * (2 * 7 * 4 * 5 + 11 * 4 * 5 + 11 * 5)  # 2 * (280 + 220 + 55)
    assert flops.forward_flops(model, n, e) == layers + encoders + head == 4674
    assert flops.step_flops(model, n, e) == 3 * 4674


def test_flops_at_the_cells_size():
    """About 229 GFLOP a forward layer, 11.2 TFLOP a step at chr19 scale."""
    model = dict(hidden_features=256, nb_pos_enc=16, hidden_edge_features=16,
                 hidden_edge_scores=64, edge_features=2, num_gnn_layers=16)
    assert 5 * 2 * 150_000 * 256**2 + 2 * 1_000_000 * 256**2 == pytest.approx(229.4e9, rel=1e-3)
    assert flops.step_flops(model, 150_000, 1_000_000) == pytest.approx(11.15e12, rel=5e-3)
