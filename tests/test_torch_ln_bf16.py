"""The LayerNorm GatedGCN in bf16 on the CPU, at a small size:

* three steps of the port's ``_epoch_pass`` (``batch_norm=False``, bf16,
  remat ``"unroll_group"`` in groups of 4) held to the plain f32 reference
  (``benchmark/reference/model.py``) through ``compare.training_numbers``,
  under the cell's limits and tighter tolerances, with a frozen step and
  the reference with fp8 E4M3 products (the benchmark's control for bf16)
  far from it;
* the layer's ``gate`` and ``aggregate`` spans: opened in every forward and
  recompute of a layer, and changing no value;
* the cost of each bf16 entry of the LayerNorm branch, as
  ``kernels.roofline.train`` counts it, worked by hand at
  ``benchmark/tests/test_bench_costs.py``'s shape;
* the readers of the layer spans, and the cells ``benchmark/run.py`` gives
  them to; the ``ln-bf16.train-full`` cell's files.
"""
import contextlib
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cells, costs, layer_spans, metrics, run
from benchmark.peaks import FP32_OPS_PER_S
from benchmark.reference import model as ref_model
from benchmark.trace import Recorder
from gnnome_tpu_torch.config import ModelConfig
from gnnome_tpu_torch.models.model import init_model_params
from gnnome_tpu_torch.train import loop
from gnnome_tpu_torch.train.checkpoint import iter_leaves
from gnnome_tpu_torch.utils import profiling
from test_torch_cuda import _graph

ROOT = Path(__file__).resolve().parent.parent
CELL = "ln-bf16.train-full"
LAYERS = 4
# the bf16 LayerNorm model's tolerances at this size: the program reads a
# change gap of 0.007-0.016 and a median-leaf direction gap of 1.6e-5 to
# 2.9e-5 on these seeds, the E4M3 control 2.0e-3 to 5.1e-3 in direction
CHANGE_GAP, DIRECTION_GAP = 0.1, 3e-4


def _small_cell(seed):
    """``ln-bf16.train-full`` at 2,000 nodes and 12,000 edges and 4 layers
    (one group of 4), full widths, its set-up (the program's three steps)
    run on the CPU; and the cell's limits."""
    spec = run.load_spec(CELL)
    spec["config"]["num_gnn_layers"] = LAYERS
    spec["traffic"].update(n_nodes=2000, n_edges=12000)
    cell = cells.make(spec["config"], spec["traffic"], seed, "cpu", Recorder(False))
    cell.setup()
    return cell, spec["limits"]


def _over(numbers, limits):
    return [k for k, limit in limits.items() if numbers[k] > limit]


@pytest.mark.parametrize("seed", [2**31 + 11, 4_400_000_123])
def test_epoch_pass_against_the_reference(seed):
    """The program's three steps within the cell's limits and close to the
    reference's; a step that leaves the parameters as they were
    (``change_gap`` 1) outside both; and on these seeds, whose loss
    gradient does not cancel, the fp8 E4M3 control's first gradient outside
    the direction tolerance, 30 times further from the reference's
    direction than the program's."""
    ref_model.exact_f32_products()
    cell, limits = _small_cell(seed)
    assert cell.cfg.train.remat == "unroll_group" and cell.cfg.train.remat_group == LAYERS
    assert cell.cfg.train.compute_dtype == "bfloat16" and not cell.cfg.model.batch_norm
    assert len(cell.first["losses"]) == 3
    numbers = cell.numbers()
    assert not _over(numbers, limits), numbers
    assert numbers["change_gap"] <= CHANGE_GAP, numbers
    assert numbers["grad_cos_gap_median"] <= DIRECTION_GAP, numbers
    frozen = cell.numbers(dict(cell.first, theta3=cell.theta0))
    assert _over(frozen, limits) == ["change_gap"]
    assert frozen["change_gap"] > CHANGE_GAP
    control = cell.numbers(cell.reference_readings(ref_model.E4M3_BITS))
    assert control["grad_cos_gap_median"] > DIRECTION_GAP, control
    assert control["grad_cos_gap_median"] >= 30 * numbers["grad_cos_gap_median"], (
        control, numbers)


def _problem():
    g, rng = _graph(9, device="cpu")
    cfg = ModelConfig(hidden_features=16, num_gnn_layers=LAYERS, nb_pos_enc=4,
                      batch_norm=False)
    params = init_model_params(torch.Generator().manual_seed(3), cfg, "cpu")
    inputs = (g, torch.from_numpy(rng.standard_normal((g.n_edges_padded, 2)).astype(np.float32)),
              torch.from_numpy(rng.standard_normal((g.n_nodes_padded, 6)).astype(np.float32)),
              torch.from_numpy((rng.random(g.n_edges_padded) < 0.7).astype(np.float32)),
              torch.tensor(0.5))
    return params, loop.make_optimizer(params), inputs


def _step(profile: bool):
    params, opt, inputs = _problem()
    acts = [torch.profiler.ProfilerActivity.CPU]
    ctx = torch.profiler.profile(activities=acts) if profile else contextlib.nullcontext()
    with ctx as prof:
        loss, _ = loop.train_step(params, opt, *inputs, batch_norm=False, remat="unroll_group",
                                  remat_group=LAYERS, compute_dtype="bfloat16")
    return loss, dict(iter_leaves(params)), prof


def test_layer_spans_change_no_value():
    off_loss, off_params, _ = _step(profile=False)
    on_loss, on_params, prof = _step(profile=True)
    assert torch.equal(off_loss, on_loss)
    assert off_params.keys() == on_params.keys()
    for k, v in off_params.items():
        assert torch.equal(v, on_params[k]), k
    # each layer opens both spans in its forward and again in its recompute
    opened = Counter(e.name for e in prof.events()
                     if e.name.startswith(profiling.SPAN_PREFIX))
    for name in ("gate", "aggregate", "model.layer"):
        assert opened[profiling.SPAN_PREFIX + name] == 2 * LAYERS, opened
    assert opened[profiling.SPAN_PREFIX + "norm"] >= 4 * LAYERS


def test_layer_span_readers_on_a_cpu_profile():
    """A CPU profile holds the spans and no device time: each reader reads
    0 ms; a window whose program never opened the span (a program before
    the spans) leaves the metric out; a window with no profile too."""
    _, _, prof = _step(profile=True)
    red = layer_spans.reduce(prof.events())
    assert {"gate", "aggregate", "norm", "model.layer"} <= red["seen"]
    assert red["steps"] == 1

    class View:
        pass

    view = View()
    view.layer_spans = red
    for name in ("model.gate_ms.train", "model.aggregate_ms.train"):
        assert metrics.load(name)(view) == 0.0
    view.layer_spans = dict(red, seen=red["seen"] - {"gate", "aggregate"})
    assert metrics.load("model.gate_ms.train")(view) is None
    assert metrics.load("model.aggregate_ms.train")(view) is None
    view.layer_spans = {"steps": 2, "seen": {"gate", "aggregate"},
                        ("gate", "forward"): 0.004, ("gate", "recompute"): 0.004,
                        ("gate", "backward"): 0.01, ("aggregate", "backward"): 0.02}
    assert metrics.load("model.gate_ms.train")(view) == pytest.approx(9.0)
    assert metrics.load("model.aggregate_ms.train")(view) == pytest.approx(10.0)
    del prof  # no profile on the stack
    assert metrics.load("model.gate_ms.train")(View()) is None


# benchmark/tests/test_bench_costs.py's shape: N = 10 nodes, E = 40 edge rows
# (30 real), D = 8, every node an endpoint; 2 bytes a bf16 element, 4 an f32
# one or an id
G = dict(n=10, e=40, nr=10, er=30, u_src=10, u_dst=10)
D = 8
BF16_CASES = {
    # x, residual and out (3 * 40 * 8) and scale and bias (2 * 8), bf16;
    # 10 operations an element
    "layer_norm_relu_residual_bf16": ((40, D, 1e-5, 8, 3, 1, 1), (960 + 16) * 2, 10 * 320),
    # x, g and dx (960) and scale and bias (16) bf16; the two gradients (16)
    # and 1056 partial rows of both (2 * 1056 * 8) f32; 20 an element
    "layer_norm_relu_residual_bwd_bf16": ((40, D, 1e-5, 8, 3, 1, 1, 1056),
                                          (960 + 16) * 2 + (16 + 16896) * 4, 20 * 320),
    # e_new's real rows and a table (240 + 80) bf16; sums 160 f32; offsets
    # and src (11 + 30) ids
    "sigma_aggregate_gather_bf16": ((10, D, 1), (240 + 80) * 2 + 160 * 4 + 41 * 4, 5 * 320),
    # e_new's real rows, d_e and d_v, a table (240 + 640 + 80) bf16; g_sums
    # (10 * 16) f32; segment ids and src (40 + 30)
    "sigma_aggregate_bwd_gather_bf16": ((10, 40, D, 1), 960 * 2 + 160 * 4 + 70 * 4, 12 * 320),
}


@pytest.mark.parametrize("entry", sorted(BF16_CASES))
def test_bf16_cost_by_hand(entry):
    ints, n_bytes, n_ops = BF16_CASES[entry]
    assert costs.load(entry)(ints, G) == (n_bytes, n_ops, FP32_OPS_PER_S)


@pytest.mark.parametrize("entry", sorted(BF16_CASES))
def test_bf16_cost_is_its_f32_entry_at_two_bytes(entry):
    """The same operations as the f32 entry, and fewer bytes: at most the
    f32 count and at least half of it."""
    ints, _, _ = BF16_CASES[entry]
    f32 = costs.load(entry[: -len("_bf16")])(ints, G)
    bf16 = costs.load(entry)(ints, G)
    assert bf16[1:] == f32[1:]
    assert f32[0] / 2 <= bf16[0] < f32[0]


@pytest.mark.parametrize("cell", ["bn-f32.train-full", "ln-f32.train-full"])
def test_f32_cells_read_the_layer_spans(cell):
    """Each f32 training cell reads the layer spans under the names that
    move its rate."""
    spec = run.load_spec(cell)
    model = {m["name"]: m for m in spec["per_layer"] if m["layer"] == "model"}
    assert set(model) == {"model.gate_ms.train", "model.aggregate_ms.train"}
    for m in model.values():
        assert m["moves"] == "train_edges_per_s" and m["source"] == "device_trace"
        assert m["unit"] == "ms" and metrics.load(m["name"]) is not None


def test_bf16_cell_reads_no_layer_span():
    """No ``.bf16`` form of the layer-span readers yet: the bf16 cell's
    per-layer metrics are those it had, each moving its own rate."""
    spec = run.load_spec("bn-bf16.train-full")
    assert not [m for m in spec["per_layer"] if m["layer"] == "model"]
    assert all(m["moves"] == "train_edges_per_s.bf16" for m in spec["per_layer"])


def test_ln_bf16_cell_finds_its_files():
    """The LayerNorm model in bf16: ``gatedgcn-ln-f32`` but for its dtype, its
    source and what it assumes, on ``bn-bf16.train-full``'s traffic, read by
    the bf16 metrics and the two layer-span readers, each moving its own
    rate, and compared by the first loss and the change over three steps."""
    spec = run.load_spec(CELL)
    config = spec["config"]
    f32 = json.loads((ROOT / "benchmark/configs/gatedgcn-ln-f32.json").read_text())
    own = {"name", "source", "architecture", "compute_dtype", "assumed"}
    assert config.keys() == f32.keys()
    assert {k: v for k, v in config.items() if k not in own} == {
        k: v for k, v in f32.items() if k not in own}
    assert config["compute_dtype"] == "bfloat16" and not config["batch_norm"]
    assert config["reduced"] == [] and set(config["assumed"]) == {"compute_dtype"}
    assert spec["chips"] == 1
    assert spec["traffic"] == run.load_spec("bn-bf16.train-full")["traffic"]
    assert set(spec["limits"]) == {"loss_gap_first", "change_gap"}
    assert ref_model.CONTROL_BITS[config["compute_dtype"]] == ref_model.E4M3_BITS
    assert {m["name"] for m in spec["end_to_end"]} == {"train_edges_per_s.bf16", "peak_mem_gib",
                                                       "setup_s"}
    bf16 = {m["name"] for m in run.load_spec("bn-bf16.train-full")["per_layer"]}
    names = {m["name"] for m in spec["per_layer"]}
    assert len(bf16) == 9 and names == bf16 | {"model.gate_ms.train.bf16",
                                               "model.aggregate_ms.train.bf16"}
    for m in spec["per_layer"]:
        assert m["moves"] == "train_edges_per_s.bf16" and metrics.load(m["name"]) is not None


def test_layer_span_readers_read_as_their_base():
    """Each ``.bf16`` form reads as its base reader: a view without the
    spans leaves both out, and a view with them gives the same ms."""

    class View:
        pass

    view = View()
    view.layer_spans = {"steps": 2, "seen": {"gate", "aggregate"},
                        ("gate", "forward"): 0.004, ("gate", "recompute"): 0.004,
                        ("gate", "backward"): 0.01, ("aggregate", "backward"): 0.02}
    empty = View()
    empty.layer_spans = {"steps": 1, "seen": set()}
    for base in ("model.gate_ms.train", "model.aggregate_ms.train"):
        assert metrics.load(base + ".bf16")(view) == metrics.load(base)(view)
        assert metrics.load(base + ".bf16")(empty) is None
