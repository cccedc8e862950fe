"""The seam between a configuration and its reference model: the module that
the configuration's key ``reference`` names (``benchmark/reference/__init__.py``
``load``) is the one its cell's set-up, reference steps, control and FLOP
count use, and a key that names no sound reference fails when the spec is
loaded, naming the configuration and the key."""
import contextlib
import importlib
import json
import shutil

import pytest
import torch

from benchmark import cells, flops, reference, run
from benchmark.reference import model as ref_model
from benchmark.trace import Recorder
from conftest import ROOT, load_spec

HERE = ROOT / "benchmark" / "tests"
SPY = "benchmark/tests/spy_reference.py"
CONFIGS = sorted((ROOT / "benchmark" / "configs").glob("*.json"))
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def bn_f32() -> dict:
    return json.loads((ROOT / "benchmark/configs/gatedgcn-bn-f32.json").read_text())


@contextlib.contextmanager
def spy_in_reach():
    """The spy reference, its record empty, with the loader looking for a
    configuration's reference in ``benchmark/tests/`` (and there alone)."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(reference, "DIR", HERE)
        module = importlib.import_module("benchmark.tests.spy_reference")
        module.CALLS.clear()
        yield module, patch


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_configurations_name_the_gatedgcn_reference(path):
    assert reference.load(json.loads(path.read_text())) is ref_model


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_takes_its_configurations_reference(cell):
    spec = load_spec(cell)
    made = cells.make(spec["config"], spec["traffic"], 1, "cpu", Recorder(False))
    assert made.reference is ref_model


@pytest.mark.parametrize("key", ["benchmark/reference/no_such_model.py", SPY,
                                 "benchmark/reference/../flops.py", "benchmark/reference",
                                 None])
def test_no_sound_file_fails_at_load(key):
    config = dict(bn_f32(), reference=key)
    with pytest.raises(ValueError, match="not a .py file under benchmark/reference/") as err:
        reference.load(config)
    assert "'gatedgcn-bn-f32'" in str(err.value) and "key 'reference'" in str(err.value)
    assert repr(key) in str(err.value)


def test_module_without_forward_flops_fails_at_load():
    with spy_in_reach() as (spy, patch):
        patch.delattr(spy, "forward_flops")
        with pytest.raises(ValueError, match="lacks forward_flops$") as err:
            reference.load(dict(bn_f32(), reference=SPY))
    assert "'gatedgcn-bn-f32', key 'reference'" in str(err.value)
    # nor is a module of the package that holds no model a reference
    with pytest.raises(ValueError, match="lacks init_params, forward, train_step"):
        reference.load(dict(bn_f32(), reference="benchmark/reference/compare.py"))


def test_spec_load_fails_on_a_missing_reference(tmp_path):
    """``run.load_spec`` refuses the cell before any run."""
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    (tmp_path / "benchmark" / "configs").mkdir(parents=True)
    for path in CONFIGS:
        shutil.copy(path, tmp_path / "benchmark" / "configs")
    assert run.load_spec("bn-f32.train-full", root=tmp_path)["config"] == bn_f32()
    path = tmp_path / "benchmark/configs/gatedgcn-bn-f32.json"
    path.write_text(json.dumps(dict(bn_f32(), reference="benchmark/reference/gps.py")))
    with pytest.raises(ValueError, match="'gatedgcn-bn-f32', key 'reference'.*gps.py"):
        run.load_spec("bn-f32.train-full", root=tmp_path)


def test_flops_come_from_the_reference():
    want = flops.step_flops(bn_f32(), 7, 11)
    with spy_in_reach() as (spy, _):
        assert flops.step_flops(dict(bn_f32(), reference=SPY), 7, 11) == want
    assert spy.CALLS == ["forward_flops"]


def readings(config: dict, traffic: dict, seed: int = 2**31 + 5) -> tuple:
    """``control.py``'s readings of a cell of ``config`` and ``traffic`` on the
    CPU, as its ``main`` takes them."""
    control = importlib.import_module("control")
    cell = cells.make(config, traffic, seed, "cpu", Recorder(False))
    cell.reference.exact_f32_products()
    cell.setup()
    cell.free()
    return cell, control.readings(cell, controls=True)


def test_the_cell_runs_on_the_reference_its_configuration_names(monkeypatch):
    """Every use of the contract reaches the spy, and the numbers it gives
    are the real module's, the half batch (``bce_loss`` swapped on the
    module the cell uses) included."""
    monkeypatch.syspath_prepend(str(ROOT / "benchmark"))
    # one thread: the CPU's sums then run in one order, and two runs of one
    # reference agree bit for bit
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spy_and_real_readings()
    finally:
        torch.set_num_threads(threads)


def spy_and_real_readings():
    # bn-f32.train-full at test_bench_control.py's graph size, full widths,
    # two layers (the seam is the same at sixteen, eight times slower here)
    n, e = 2000, 12000
    traffic = dict(load_spec("bn-f32.train-full")["traffic"], n_nodes=n, n_edges=e)
    config = dict(bn_f32(), num_gnn_layers=2)
    want_flops = flops.step_flops(config, n, e)
    with spy_in_reach() as (spy, _):
        cell, got = readings(dict(config, reference=SPY), traffic)
        assert flops.step_flops(cell.config, n, e) == want_flops
    assert cell.reference is spy and cell.ref is not None
    assert set(spy.CALLS) == set(reference.CONTRACT)
    # set-up draws the weights; three reference runs of three steps follow (the
    # check's, the control's, the half batch's; the frozen step reuses the check's)
    assert spy.CALLS.count("init_params") == 1 and spy.CALLS.count("Adam") == 3
    assert spy.CALLS.count("train_step") == 9 and spy.CALLS.count("bce_loss") == 9
    assert spy.CALLS.count("CONTROL_BITS") == 1
    real_cell, want = readings(config, traffic)
    assert real_cell.reference is ref_model
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["half_batch"] != got["program"] != got["control"]
