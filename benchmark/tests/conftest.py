"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from the
repository's root. Tests marked ``cuda`` run on the card only and skip here."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# cells whose files the benchmark holds and BENCHMARK.json does not list yet
# (PERF.md, Open questions): their correctness is tested all the same
UNLISTED = {
    "bn-f32.train-cluster": dict(config="gatedgcn-bn-f32", traffic="train-cluster", chips=1),
    "bn-f32.assemble": dict(config="gatedgcn-bn-f32", traffic="assemble", chips=1),
}


def load_spec(cell):
    """The run spec of a cell, listed in ``BENCHMARK.json`` or not."""
    from benchmark import run

    return run.load_spec(cell, UNLISTED.get(cell))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
