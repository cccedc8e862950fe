"""Readers of the per-layer metrics, one file a metric, named as the metric
in ``BENCHMARK.json``. Each file's ``read(view)`` returns the number, or
None where the traced run holds nothing to read (the metric is then left
out of the result line). ``view`` is the traced window of one run
(``benchmark/run.py`` ``TracedWindow``)."""
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str):
    path = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
