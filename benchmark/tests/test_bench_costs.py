"""The kernel costs and the MFU's FLOP count against numbers worked by hand
at a small shape: N = 10 nodes, E = 40 edge rows (30 real), D = 8, every
node an endpoint (u_src = u_dst = 10); a bf16 entry counts 2 bytes a bf16
element and 4 an f32 one or an id."""
import pytest

from benchmark import costs, flops, metrics
from benchmark.peaks import BF16_TC_OPS_PER_S, FP32_OPS_PER_S, TF32_TC_OPS_PER_S, bound_s

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
    # bf16: 10 rows of 8 and 40 rows out (80 + 320) * 2; 40 ids
    "take_rows_bf16": ((40, 10, D, 1), 800 + 160, 0, FP32_OPS_PER_S),
    # 30 real bf16 rows (240 * 2); f32 sums and offsets (80 + 11) * 4
    "segment_sum_by_dst_bf16": ((10, D, 1), 480 + 364, 320, FP32_OPS_PER_S),
    "segment_sum_by_src_bf16": ((10, D, 1), 480 + 364 + 120, 320, FP32_OPS_PER_S),
    # e, gate, both tables, W3 and b3 in bf16 (640 + 160 + 64 + 8) * 2, the
    # f32 sums 16 * 4, ids 2 * 40 * 4; one bf16 product 2 * 40 * 64
    "gate_front_bf16": ((40, 30, D, 1, 64, 4), 1744 + 64 + 320, 2 * 40 * 64,
                        BF16_TC_OPS_PER_S),
    # gate, e_in, e_new and a table in bf16 (960 + 80) * 2; affine and sums
    # (16 + 160) * 4; offsets and src 51 * 4
    "gate_sigma_gather_bf16": ((10, 40, D, 1), 2080 + 704 + 204, 8 * 320, FP32_OPS_PER_S),
    # e_new's real rows and a table (240 + 80) * 2; sums 160 * 4; ids 71 * 4
    "sigma_reverse_sum_bf16": ((10, D, 1), 640 + 640 + 284, 5 * 320, FP32_OPS_PER_S),
    # d_gate, gate, d_total (960 * 2); d_mom and d_bias3 24 * 4
    "gate_front_bwd_bf16": ((40, 30, D, 1, 1), 1920 + 96, 5 * 320, FP32_OPS_PER_S),
    # five [E, D], e_new's real rows, a table (1600 + 240 + 80) * 2; g_sums
    # and the affine (160 + 32) * 4; ids 70 * 4
    "epilog_bwd_bf16": ((10, 40, D, 1024, 1), 3840 + 768 + 280, 18 * 320, FP32_OPS_PER_S),
    # real rows, two [E, D], a table (240 + 640 + 80) * 2; g_sums 160 * 4;
    # ids 110 * 4
    "rev_bwd_bf16": ((10, 40, D, 1), 1920 + 640 + 440, 12 * 320, FP32_OPS_PER_S),
}

# the bf16 entries at the cells' size (N = 150,000, E = 999,995, D = 256,
# every node an endpoint): each file's bound against the "bound ms" column
# of PERF.md's bf16 kernel table, where the same counts gave it
N, E = 150_000, 999_995
BF16_TABLE = {
    "gate_front_bf16": ((E, E, 256, 132, 256, 4), 0.3539),
    "gate_sigma_gather_bf16": ((N, E, 256, 1), 0.5745),
    "sigma_reverse_sum_bf16": ((N, 256, 1), 0.2700),
    "take_rows_bf16": ((E, N, 64, 1), 0.0451),
    "segment_sum_by_dst_bf16": ((N, 256, 1), 0.1989),
    "segment_sum_by_src_bf16": ((N, 256, 1), 0.2001),
    "gate_front_bwd_bf16": ((E, E, 256, 1024, 1), 0.4585),
    "epilog_bwd_bf16": ((N, E, 256, 1024, 1), 1.0340),
    "rev_bwd_bf16": ((N, E, 256, 1), 0.5767),
}


@pytest.mark.parametrize("entry", sorted(CASES))
def test_cost(entry):
    ints, n_bytes, n_ops, peak = CASES[entry]
    assert costs.load(entry)(ints, G) == (n_bytes, n_ops, peak)


@pytest.mark.parametrize("entry", sorted(BF16_TABLE))
def test_bf16_bound_at_the_cells_size(entry):
    ints, table_ms = BF16_TABLE[entry]
    g = dict(n=N, e=E, nr=N, er=E, u_src=N, u_dst=N)
    assert 1e3 * bound_s(*costs.load(entry)(ints, g)) == pytest.approx(table_ms, rel=0.01)


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


class _View:
    def __init__(self, dtype):
        self.model = dict(hidden_features=256, nb_pos_enc=16, hidden_edge_features=16,
                          hidden_edge_scores=64, edge_features=2, num_gnn_layers=16,
                          compute_dtype=dtype)
        self.steps = [dict(nr=150_000, er=1_000_000)] * 2
        self.window_s = 1.0


@pytest.mark.parametrize("dtype, peak", [("float32", TF32_TC_OPS_PER_S),
                                         ("bfloat16", BF16_TC_OPS_PER_S)])
def test_mfu_peak_by_dtype(dtype, peak):
    """Two steps a second: TF32's peak for a float32 model, as before the
    bf16 cell; bf16's for a bfloat16 one."""
    view = _View(dtype)
    want = 100.0 * 2 * flops.step_flops(view.model, 150_000, 1_000_000) / peak
    assert metrics.load("train.mfu")(view) == want
    assert metrics.load("train.mfu")(_View("float32")) == pytest.approx(4.512, rel=1e-3)


@pytest.mark.parametrize("name", ["train.mfu", "device.idle.train", "train.optimizer_ms"])
def test_bf16_reader_reads_as_its_base(name):
    """The bf16 cell's per-layer metrics are its base metrics' readings
    under names that move its own rate."""
    view = _View("bfloat16")
    view.busy_s, view.kernels, view.launches, view.spans = 0.5, [], [], {}
    assert metrics.load(name + ".bf16")(view) == metrics.load(name)(view)
