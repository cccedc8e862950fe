"""The port's spans (``gnnome_tpu_torch/utils/profiling.py`` ``span``): free
while no profiler records, one tree a training step under the CPU profiler,
and the same values with the profiler on and off."""
import contextlib
from collections import Counter

import numpy as np
import pytest
import torch

from gnnome_tpu_torch.config import ModelConfig
from gnnome_tpu_torch.models.model import init_model_params
from gnnome_tpu_torch.train import loop
from gnnome_tpu_torch.train.checkpoint import iter_leaves
from gnnome_tpu_torch.utils import profiling
from test_torch_cuda import _graph

CPU = [torch.profiler.ProfilerActivity.CPU]


def _problem(batch_norm: bool):
    """A 2-layer model on a small random graph, its optimizer and inputs."""
    g, rng = _graph(7, device="cpu")
    cfg = ModelConfig(hidden_features=16, num_gnn_layers=2, nb_pos_enc=4,
                      batch_norm=batch_norm)
    params = init_model_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = loop.make_optimizer(params)
    inputs = (g, torch.from_numpy(rng.standard_normal((g.n_edges_padded, 2)).astype(np.float32)),
              torch.from_numpy(rng.standard_normal((g.n_nodes_padded, 6)).astype(np.float32)),
              torch.from_numpy((rng.random(g.n_edges_padded) < 0.7).astype(np.float32)),
              torch.tensor(0.5))
    return params, opt, inputs


def _steps(batch_norm: bool, remat: str = "layer", n: int = 2, profile: bool = False):
    params, opt, inputs = _problem(batch_norm)
    ctx = torch.profiler.profile(activities=CPU) if profile else contextlib.nullcontext()
    with ctx as prof:
        losses = [loop.train_step(params, opt, *inputs, batch_norm=batch_norm, remat=remat)[0]
                  for _ in range(n)]
    return losses, dict(iter_leaves(params)), prof


def test_span_without_a_profiler_never_enters_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered while no profiler records")

    # the name the spans call (torch.optim opens its own ranges through
    # torch.autograd.profiler whatever the profiler's state)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("train.step") is profiling.span("norm")
    with profiling.span("train.step"):
        pass
    losses, _, _ = _steps(batch_norm=True, n=1)
    assert torch.isfinite(losses[0])


def _parents(events):
    """Each program span's nearest enclosing program span (None at the top)."""
    spans = [e for e in events if e.name.startswith(profiling.SPAN_PREFIX)]
    parent = {}
    for s in spans:
        p = s.cpu_parent
        while p is not None and not p.name.startswith(profiling.SPAN_PREFIX):
            p = p.cpu_parent
        parent[id(s)] = p
    return spans, parent


@pytest.mark.parametrize("remat", ["layer", "none"])
@pytest.mark.parametrize("batch_norm", [True, False], ids=["batchnorm", "layernorm"])
def test_span_tree_of_a_training_step(batch_norm, remat):
    _, _, prof = _steps(batch_norm, remat, profile=True)
    spans, parent = _parents(prof.events())

    def short(e):
        return e.name[len(profiling.SPAN_PREFIX):]

    def children(s):
        return [c for c in spans if parent[id(c)] is s]

    steps = [s for s in spans if parent[id(s)] is None]
    assert [short(s) for s in steps] == ["train.step", "train.step"]
    for step in steps:
        phases = children(step)
        assert Counter(map(short, phases)) == {"train.optimizer": 2, "train.forward": 1,
                                               "train.backward": 1}
        by_name = {short(p): p for p in phases}
        fwd_layers = [c for c in children(by_name["train.forward"]) if short(c) == "model.layer"]
        bwd_layers = [c for c in children(by_name["train.backward"])
                      if short(c) == "model.layer"]
        assert len(fwd_layers) == 2
        assert len(bwd_layers) == (2 if remat == "layer" else 0)
        for layer in fwd_layers + bwd_layers:
            # the gate, the edge norm, the aggregation and the node norm;
            # BatchNorm's moments nest in its norm
            assert [short(c) for c in children(layer)] == ["gate", "norm", "aggregate", "norm"]
    # every norm sits in a layer, directly or inside another norm, and
    # neither the gate nor the aggregation holds another span
    for s in spans:
        if short(s) == "norm":
            assert short(parent[id(s)]) in ("model.layer", "norm")
        if short(s) in ("gate", "aggregate"):
            assert short(parent[id(s)]) == "model.layer"
            assert not children(s)


@pytest.mark.parametrize("batch_norm", [True, False], ids=["batchnorm", "layernorm"])
def test_values_equal_with_the_profiler_on_and_off(batch_norm):
    off_losses, off_params, _ = _steps(batch_norm)
    on_losses, on_params, _ = _steps(batch_norm, profile=True)
    assert all(torch.equal(a, b) for a, b in zip(off_losses, on_losses))
    assert off_params.keys() == on_params.keys()
    for k, v in off_params.items():
        assert torch.equal(v, on_params[k]), k
