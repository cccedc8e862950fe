"""A stand-in reference model for ``test_bench_seam.py``: the code of
``benchmark/reference/model.py`` run in this module's own namespace, so that
its functions read this module's globals (a ``bce_loss`` that the half-batch
control swaps here is the one its ``train_step`` calls), with each use of the
contract recorded in ``CALLS``."""
from pathlib import Path

from benchmark.reference import model as _model

exec(compile(Path(_model.__file__).read_text(), _model.__file__, "exec"))

CALLS: list = []


def _recorded(name, fn):
    def call(*args, **kw):
        CALLS.append(name)
        return fn(*args, **kw)
    return call


for _name in ("init_params", "forward", "train_step", "bce_loss", "exact_f32_products",
              "forward_flops"):
    globals()[_name] = _recorded(_name, globals()[_name])


class Adam(Adam):  # noqa: F821 (defined by the code above)
    def __init__(self, *args, **kw):
        CALLS.append("Adam")
        super().__init__(*args, **kw)


class _RecordedBits(dict):
    def __getitem__(self, key):
        CALLS.append("CONTROL_BITS")
        return super().__getitem__(key)


CONTROL_BITS = _RecordedBits(CONTROL_BITS)  # noqa: F821
