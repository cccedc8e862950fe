"""On the card: a traced run reads every per-layer metric of its cell from
the device's timeline, within its range (a roofline share never past
100%), and an untraced run reads its end-to-end metrics; both are correct.
Smaller graphs than the cells' (20k nodes), full widths. Skips without a
card: ``python -m pytest benchmark/tests -m cuda`` on the card."""
import pytest

from benchmark import run
from conftest import load_spec

pytestmark = pytest.mark.cuda


def small(cell):
    """Graphs of 20k nodes; ClusterGCN pieces of ~10k, near the cell's."""
    spec = load_spec(cell)
    spec["traffic"].update(n_nodes=20_000, n_edges=130_000)
    if "cluster" in cell:
        spec["traffic"]["train"] = {"num_parts_train": 8, "batch_size_train": 4,
                                    "cluster_jitter": 2}
    return spec


@pytest.mark.parametrize("cell", ["bn-f32.train-full", "ln-f32.train-full",
                                  "bn-bf16.train-full", "bn-f32.train-cluster",
                                  "bn-f32.assemble"])
def test_traced_run_reads_its_metrics(cell, card):
    spec = small(cell)
    result = run.run_cell(spec, 2**31 + 99, 1.0, True)
    assert result["correct"], result["compared"]
    names = {m["name"] for m in spec["per_layer"]}
    assert set(result["metrics"]) == names
    for name, m in result["metrics"].items():
        assert m["value"] > 0, name
        if m["unit"] == "%":
            assert m["value"] <= 100.0, name
    dev = result["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert 0 < len(result["breakdown"]["device_ops"]) <= 10


@pytest.mark.parametrize("cell", ["bn-f32.train-full", "bn-f32.assemble"])
def test_untraced_run_reads_end_to_end(cell, card):
    spec = small(cell)
    result = run.run_cell(spec, 2**31 + 98, 2.0, False)
    assert result["correct"], result["compared"]
    assert set(result["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert all(m["value"] > 0 for m in result["metrics"].values())
