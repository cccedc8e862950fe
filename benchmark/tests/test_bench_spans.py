"""The reduction of the program's spans (``benchmark/spans.py``) on the CPU:
a toy step opens the program's spans around CPU ops, and each op of its
arithmetic stands for a kernel it launched (one second each, so sums count
them)."""
import types
from collections import Counter

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from benchmark import metrics, spans
from gnnome_tpu_torch.utils.profiling import span

NEW_METRICS = ("train.forward_ms", "train.backward_ms", "train.recompute_ms",
               "train.optimizer_ms", "dense.norm_ms.train")


def norm(x):
    with span("norm"):
        return torch.tanh(x) * 1.5


def layer(x, w):
    with span("model.layer"):
        return torch.relu(norm(x @ w)) + x


def step(w, x, remat: bool):
    with span("train.step"):
        with span("train.optimizer"):
            w.grad = None
        with span("train.forward"):
            h = checkpoint(layer, x, w, use_reentrant=False) if remat else layer(x, w)
            loss = h.square().mean()
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            with torch.no_grad():
                w.sub_(0.1 * w.grad)


def profiled(remat: bool, steps: int = 2):
    """Events of ``steps`` toy steps, with an op before them outside any step."""
    torch.manual_seed(0)
    w = torch.randn(8, 8, requires_grad=True)
    x = torch.randn(16, 8)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.exp(x)
        for _ in range(steps):
            step(w, x, remat)
    return prof.events()


# the ops that stand for kernels: the toy's arithmetic, forward and backward
WORK = {"aten::exp", "aten::mm", "aten::tanh", "aten::tanh_backward", "aten::mul",
        "aten::relu", "aten::threshold_backward", "aten::add", "aten::pow", "aten::mean",
        "aten::sub_"}


def work_launches(events):
    return [(e, 1.0) for e in events if e.name in WORK]


def attributed(remat: bool):
    events = profiled(remat)
    return spans.attribute(events, work_launches(events))


def by_op(rows, name):
    return [(phase, mods) for op, _, phase, mods in rows if op.name == name]


@pytest.mark.parametrize("remat", [False, True])
def test_forward_ops_go_to_their_innermost_span(remat):
    rows = attributed(remat)
    tanh = [mods for phase, mods in by_op(rows, "aten::tanh") if phase == "forward"]
    assert tanh == [(spans.NORM, spans.LAYER)] * 2
    mm = [mods for phase, mods in by_op(rows, "aten::mm") if phase == "forward"]
    assert mm == [(spans.LAYER,)] * 2


@pytest.mark.parametrize("remat", [False, True])
def test_backward_ops_go_by_sequence_number_to_their_forward_span(remat):
    rows = attributed(remat)
    assert by_op(rows, "aten::tanh_backward") == [("backward", (spans.NORM, spans.LAYER))] * 2
    # the loss's backward lies outside every module span
    assert [mods for phase, mods in by_op(rows, "aten::pow") if phase == "backward"] == [()] * 2


@pytest.mark.parametrize("remat", [False, True])
def test_recompute_is_counted_apart(remat):
    rows = attributed(remat)
    phases = Counter(phase for phase, _ in by_op(rows, "aten::tanh"))
    assert phases == ({"forward": 2, "recompute": 2} if remat else {"forward": 2})
    recomputed = Counter(op.name for op, _, phase, _ in rows if phase == "recompute")
    forward_in_layer = Counter(op.name for op, _, phase, mods in rows
                               if phase == "forward" and spans.LAYER in mods)
    if remat:  # the layer's forward again, up to the last tensor the backward needs
        assert recomputed["aten::mm"] == 2
        assert all(n <= forward_in_layer[name] for name, n in recomputed.items())
    else:
        assert not recomputed


@pytest.mark.parametrize("remat", [False, True])
def test_phases_partition_the_step(remat):
    events = profiled(remat)
    launches = work_launches(events)
    out = spans.reduce(events, launches)
    assert out["steps"] == 2
    assert out["unphased"] == 0.0
    assert sum(out[k] for k in spans.KINDS) == out["step"]
    # every launch but the one before the steps
    assert out["step"] == len(launches) - 1
    assert out["norm"] == sum(out[f"norm_{k}"] for k in spans.KINDS)
    # tanh and the product by 1.5, in each of two steps
    assert out["norm_forward"] == out["norm_backward"] == 4
    assert out["norm_recompute"] == (4 if remat else 0)
    assert out["recompute"] > 0 if remat else out["recompute"] == 0


def test_readers_read_nothing_from_a_program_without_spans():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.randn(4, 4).sum()
    assert prof is not None
    view = types.SimpleNamespace()
    assert [metrics.load(name)(view) for name in NEW_METRICS] == [None] * len(NEW_METRICS)


def test_readers_find_the_window_on_the_calling_stack():
    w = torch.randn(8, 8, requires_grad=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(w, torch.randn(16, 8), remat=True)
    assert prof is not None
    view = types.SimpleNamespace()
    # no device on the CPU: every span reads zero device time
    assert [metrics.load(name)(view) for name in NEW_METRICS] == [0.0] * len(NEW_METRICS)
    assert view.program_spans["steps"] == 1
    assert metrics.load("train.forward_ms")(types.SimpleNamespace()) == 0.0
