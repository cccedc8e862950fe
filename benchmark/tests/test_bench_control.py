"""The control, at a size a test run can hold: the reference computed in
TF32 (the nearest precision below the configuration's float32), put in the
program's place, is judged not correct by each training cell's limits and
the assemble cell's, at full widths on a small graph on the CPU."""
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


@pytest.mark.parametrize("name", ["bn-f32.train-full", "ln-f32.train-full",
                                  "bn-f32.train-cluster"])
def test_tf32_reference_fails_training_limits(name):
    ref_model.exact_f32_products()
    spec, cell = small_cell(name)
    assert not over_limit(cell.numbers(), spec["limits"])
    control = cell.numbers(cell.reference_readings(tf32=True))
    assert over_limit(control, spec["limits"])


def test_tf32_reference_fails_assemble_limits():
    spec, cell = small_cell("bn-f32.assemble")
    cell.unit(decode=False)
    g = cell.checked()[0]
    assert not over_limit(cell.numbers(), spec["limits"])
    control = cell.numbers(cell.reference_logits(g, tf32=True))
    assert over_limit(control, spec["limits"]) == ["logit_gap"]
