"""The control, at a size a test run can hold: the reference with its
products' operands rounded to the nearest precision below the
configuration's (TF32 below float32, fp8 E4M3's significand below
bfloat16), put in the program's place, is judged not correct by each
training cell's limits and the assemble cell's, at full widths on a small
graph on the CPU."""
import pytest

from benchmark import cells
from conftest import load_spec
from benchmark.reference import model as ref_model
from benchmark.trace import Recorder


def small_cell(name, seed=2**31 + 3):
    spec = load_spec(name)
    spec["traffic"].update(n_nodes=2000, n_edges=12000)
    if "cluster" in name:
        spec["traffic"]["train"] = {"num_parts_train": 16, "batch_size_train": 4,
                                    "cluster_jitter": 4}
    cell = cells.make(spec["config"], spec["traffic"], seed, "cpu", Recorder(False))
    cell.setup()
    return spec, cell


def over_limit(numbers, limits):
    return [k for k, limit in limits.items() if k in numbers and numbers[k] > limit]


def control_fails(name):
    ref_model.exact_f32_products()
    spec, cell = small_cell(name)
    assert not over_limit(cell.numbers(), spec["limits"])
    bits = ref_model.CONTROL_BITS[spec["config"]["compute_dtype"]]
    control = cell.numbers(cell.reference_readings(bits))
    assert over_limit(control, spec["limits"])


@pytest.mark.parametrize("name", ["bn-f32.train-full", "ln-f32.train-full",
                                  "bn-f32.train-cluster"])
def test_tf32_reference_fails_training_limits(name):
    control_fails(name)


def test_fp8_reference_fails_bf16_limits():
    control_fails("bn-bf16.train-full")


def test_tf32_reference_fails_assemble_limits():
    spec, cell = small_cell("bn-f32.assemble")
    cell.unit(decode=False)
    g = cell.checked()[0]
    assert not over_limit(cell.numbers(), spec["limits"])
    control = cell.numbers(cell.reference_logits(g, ref_model.TF32_BITS))
    assert over_limit(control, spec["limits"]) == ["logit_gap"]


def test_bf16_cell_finds_its_files():
    spec = load_spec("bn-bf16.train-full")
    assert spec["config"]["compute_dtype"] == "bfloat16"
    assert spec["traffic"]["train"] == {"num_parts_train": 1, "remat": "unroll_group",
                                        "remat_group": 4}
    assert set(spec["limits"]) == {"change_gap", "grad_cos_gap_median"}
    assert spec["traffic"]["rate_metric"] == "train_edges_per_s.bf16"
    assert {m["name"] for m in spec["end_to_end"]} == {"train_edges_per_s.bf16", "peak_mem_gib",
                                                       "setup_s"}
    assert len(spec["per_layer"]) == 9
    assert all(m["name"].endswith(".bf16") and m["moves"] == "train_edges_per_s.bf16"
               for m in spec["per_layer"])
    assert ref_model.CONTROL_BITS[spec["config"]["compute_dtype"]] == ref_model.E4M3_BITS
