"""The LayerNorm layer's edge gate through the gate front, on the CPU.

The LayerNorm GatedGCN layer (``batch_norm=False``, narrow gathers) takes
its gate ``b1h[src] + b2h[dst] + e·W3 + b3`` from ``fused_gate_front`` with
``moments=False``: the moments are computed and left unread, so the
backward passes ``d_gate`` through as ``d_total`` and takes ``d_bias3`` as
its f32 column sum, without ``gate_front_bwd``. Held here, through the
kernels' plain versions (CPU tensors), against autograd of the expression
the layer summed before (two ``gather_by_endpoint`` row gathers and
``linear(B3, e)``) and against ``jax.vjp`` of the JAX LayerNorm layer's
same expression (``backend="pallas_interpret"`` on the banded graph,
``"xla"`` on a random one).

Tolerances:
  * float32: the gate and every gradient rtol = atol = 1e-5, the outputs
    summed over every edge (``d_W3``, ``d_bias3``) rtol 1e-5 and atol
    1e-6·max|ref| (tests/test_torch_train.py's);
  * bfloat16: the gate front rounds where the TPU kernel rounds (the
    product and ``+ b3`` in bf16, the two endpoint rows added to it in f32
    and rounded once), where the layer's expression rounds ``b1h[src] +
    b2h[dst]`` to bf16 before a second bf16 add: one rounding fewer, in
    another order. So the gate is held to one bf16 rounding of each
    partial sum and of the gate, ``2⁻⁷·(|b1h[src]| + |b2h[dst]| + |pb|) +
    ulp(gate)``. The gradients do not depend on the gate, only on
    ``d_gate``: one bf16 ulp, plus 1e-5·max|ref| for the sums over edges
    (tests/test_torch_bf16.py's); ``d_bias3``, an f32 column sum rounded
    once as the old expression's, within half an ulp of the exact sum
    (JAX's CPU VJP sums that column in bf16, several ulps off).

The BatchNorm layer's gate front (``moments=True``) keeps its backward: its
gradients are checked bit for bit against that backward composed by hand
from ``gate_front_bwd``, the segment sums and the two products.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.models.common import linear as jax_linear
from gnnome_tpu.ops.segment import gather_by_endpoint as jax_gather
from gnnome_tpu_torch.models import gated_gcn
from gnnome_tpu_torch.models.common import linear
from gnnome_tpu_torch.ops import gate_front as gate_front_mod
from gnnome_tpu_torch.ops.dense import weight_grad
from gnnome_tpu_torch.ops.gate_front import GateFront, gate_front_bwd
from gnnome_tpu_torch.ops.segment import fused_gate_front, gather_by_endpoint
from gnnome_tpu_torch.ops.segment_sum import segment_sum
from test_torch_bf16 import (
    EDGE_SUM_ATOL, assert_bf16_close, bf16, jb, npf, rb, tb, ulp)
from test_torch_ops import D, banded_edges, both_graphs, f32, random_edges, t
from test_torch_train import close_all

NAMES = ("d_b1h", "d_b2h", "d_e", "d_w3", "d_bias3")


@pytest.fixture(params=["pallas_interpret", "xla"])
def case(request):
    """(backend, JAX graph, port graph, rng): the banded graph for the
    Pallas kernels, a random graph for XLA; both padded."""
    rng = np.random.default_rng(37)
    make = banded_edges if request.param == "pallas_interpret" else random_edges
    jg, tg = both_graphs(*make(rng))
    return request.param, jg, tg, rng


def _inputs(jg, rng, draw):
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    return [draw(rng, n, D), draw(rng, n, D), draw(rng, e, D),
            draw(rng, D, D, scale=D ** -0.5), draw(rng, D)]


def _front(tg, moments):
    return lambda b1h, b2h, e, w3, b3: fused_gate_front(b1h, b2h, e, w3, b3, tg,
                                                        moments=moments)[0]


def _layer_expression(tg):
    """The gate as the LayerNorm layer summed it before it took the gate
    front: two row gathers and ``linear(B3, e)``."""
    return lambda b1h, b2h, e, w3, b3: (gather_by_endpoint(b1h, tg.src, tg.by_src)
                                        + gather_by_endpoint(b2h, tg.dst, tg.by_dst)
                                        + linear({"w": w3, "b": b3}, e))


def _jax_expression(jg, backend):
    """The JAX LayerNorm layer's gate (``gnnome_tpu/models/gated_gcn.py``)."""
    n = jg.n_nodes_padded
    return lambda b1h, b2h, e, w3, b3: (jax_gather(b1h, jg.src, jg.by_src, n, backend)
                                        + jax_gather(b2h, jg.dst, jg.by_dst, n, backend)
                                        + jax_linear({"w": w3, "b": b3}, e))


def _run(fn, leaves, d_gate):
    """``fn``'s output and the gradients of ``leaves`` for ``d_gate``."""
    leaves = [x.clone().requires_grad_(True) for x in leaves]
    gate = fn(*leaves)
    gate.backward(d_gate)
    return gate.detach(), [x.grad for x in leaves]


def test_layernorm_gate_front_f32_matches_the_layer_and_jax(case, monkeypatch):
    """float32: the gate and its five gradients through the moments-free gate
    front against autograd of the layer's old expression and against
    ``jax.vjp`` of JAX's; ``gate_front_bwd`` does not run, the moments take
    no gradient, and only ``e`` and ``W3`` are saved for the backward."""
    backend, jg, tg, rng = case
    inputs = _inputs(jg, rng, f32)
    d_gate = f32(rng, jg.n_edges_padded, D)
    calls = []
    monkeypatch.setattr(gate_front_mod, "gate_front_bwd",
                        lambda *a: calls.append(1) or gate_front_bwd(*a))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x) or x, lambda x: x):
        leaves = [t(x).requires_grad_(True) for x in inputs]
        gate, mom = fused_gate_front(*leaves, tg, moments=False)
    assert not mom.requires_grad and len(saved) == 2
    gate.backward(t(d_gate))
    assert calls == []
    got = [x.grad for x in leaves]
    ref_gate, ref = _run(_layer_expression(tg), [t(x) for x in inputs], t(d_gate))
    np.testing.assert_allclose(gate.detach().numpy(), ref_gate.numpy(), rtol=1e-5, atol=1e-5)
    close_all(got, [r.numpy() for r in ref], edge_sums=(3, 4))
    jgate, jvjp = jax.vjp(_jax_expression(jg, backend), *map(jnp.asarray, inputs))
    np.testing.assert_allclose(gate.detach().numpy(), np.asarray(jgate), rtol=1e-5,
                               atol=1e-5)
    close_all(got, jvjp(jnp.asarray(d_gate)), edge_sums=(3, 4))


def test_layernorm_gate_front_bf16_matches_the_layer_and_jax(case, monkeypatch):
    """bfloat16: the gate within one rounding of each partial sum of the
    layer's old expression and of JAX's (the gate front rounds once where
    they round twice), and the five gradients within one bf16 ulp of both
    (plus 1e-5·max|ref| for the sums over edges), in bf16; ``d_bias3``
    within half an ulp of the exact column sum, as the old expression's."""
    backend, jg, tg, rng = case
    inputs = _inputs(jg, rng, bf16)
    d_gate = bf16(rng, jg.n_edges_padded, D)
    calls = []
    monkeypatch.setattr(gate_front_mod, "gate_front_bwd",
                        lambda *a: calls.append(1) or gate_front_bwd(*a))
    gate, got = _run(_front(tg, False), [tb(x) for x in inputs], tb(d_gate))
    assert calls == [] and gate.dtype == torch.bfloat16
    assert all(x.dtype == torch.bfloat16 for x in got)
    src, dst = np.asarray(jg.src), np.asarray(jg.dst)
    b1h, b2h, e, w3, b3 = inputs
    x1, x2 = b1h[src], b2h[dst]
    pb = rb(rb(e.astype(np.float64) @ w3.astype(np.float64)) + b3)
    bound = 2.0 ** -7 * (np.abs(x1) + np.abs(x2) + np.abs(pb)) + ulp(npf(gate))
    ref_gate, ref = _run(_layer_expression(tg), [tb(x) for x in inputs], tb(d_gate))
    jgate, jvjp = jax.vjp(_jax_expression(jg, backend), *map(jb, inputs))
    for want in (ref_gate, jgate):
        assert (np.abs(npf(gate) - npf(want)) <= bound).all()
    # JAX's bias VJP sums the bf16 column in bf16 on the CPU (here up to 1.6
    # off a sum of ~130); the port, as before, sums it in f32 and rounds once
    col = d_gate.astype(np.float64).sum(0)
    assert (np.abs(npf(got[4]) - col) <= ulp(col) / 2 + EDGE_SUM_ATOL * np.abs(col).max()).all()
    for refs, n_refs in ((ref, 5), (jvjp(jb(d_gate)), 4)):
        for name, leaf, w in list(zip(NAMES, got, refs))[:n_refs]:
            assert_bf16_close(leaf, w, atol=EDGE_SUM_ATOL * float(np.abs(npf(w)).max()),
                              name=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_gate_front_backward_is_unchanged(dtype):
    """``moments=True`` (the default, the BatchNorm layer's): the gradients
    are those of ``gate_front_bwd`` composed with the two segment sums, the
    ``d_e`` product and ``weight_grad``, bit for bit, and the gate, ``e``
    and ``W3`` are saved."""
    rng = np.random.default_rng(41)
    src, dst, n = random_edges(rng)
    tg = both_graphs(src, dst, n)[1]
    draw, cast = (f32, t) if dtype == "float32" else (bf16, tb)
    inputs = [cast(x) for x in _inputs(tg, rng, draw)]
    d_gate = cast(draw(rng, tg.n_edges_padded, D))
    d_mom = torch.from_numpy(f32(rng, 2, D, scale=1.0 / tg.n_edges))
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x) or x, lambda x: x):
        gate, mom = GateFront.apply(*leaves, tg.src, tg.dst, tg.n_edges, tg.by_src, tg.by_dst)
    assert mom.requires_grad and len(saved) == 3
    torch.autograd.backward([gate, mom], [d_gate, d_mom])
    d_total, d_bias3 = gate_front_bwd(d_gate, gate.detach(), d_mom, tg.n_edges)
    b1h, b2h, e, w3, b3 = inputs
    want = [segment_sum(d_total, tg.by_src).to(b1h.dtype),
            segment_sum(d_total, tg.by_dst).to(b2h.dtype), d_total @ w3.T,
            weight_grad(e, d_total), d_bias3.to(b3.dtype)]
    for name, leaf, w in zip(NAMES, leaves, want):
        assert leaf.grad.dtype == w.dtype and torch.equal(leaf.grad, w), name


@pytest.mark.parametrize("batch_norm", [True, False])
def test_layer_takes_its_gate_from_the_gate_front(batch_norm, monkeypatch):
    """The narrow layer of either norm sums its gate in one gate-front call,
    with moments only for the BatchNorm, and gathers no endpoint row; the
    LayerNorm layer's output and gradients are those of the layer with its
    old gate expression put back, to 1e-5."""
    rng = np.random.default_rng(43)
    src, dst, n = random_edges(rng, n=200, e=1500)
    tg = both_graphs(src, dst, n)[1]
    d = 32
    params = gated_gcn.init_gated_gcn_layer(torch.Generator().manual_seed(3), d, "cpu")
    h = t(f32(rng, tg.n_nodes_padded, d))
    e = t(f32(rng, tg.n_edges_padded, d))
    cot = (t(f32(rng, tg.n_nodes_padded, d)), t(f32(rng, tg.n_edges_padded, d)))
    seen = []
    real_front = gated_gcn.fused_gate_front

    def front(*args, moments=True):
        seen.append(moments)
        return real_front(*args, moments=moments)

    def grads_of(layer_front):
        monkeypatch.setattr(gated_gcn, "fused_gate_front", layer_front)
        leaves = {k: v.clone().requires_grad_(True) for k, v in
                  [(f"{m}.{q}", x) for m, p in params.items() for q, x in p.items()]}
        tree = {}
        for k, v in leaves.items():
            m, q = k.split(".")
            tree.setdefault(m, {})[q] = v
        outs = gated_gcn.gated_gcn_layer(tree, tg, h, e, batch_norm=batch_norm)
        torch.autograd.backward(outs, cot)
        return [o.detach() for o in outs], {k: v.grad for k, v in leaves.items()}

    monkeypatch.setattr(gated_gcn, "gather_by_endpoint",
                        lambda *a: pytest.fail("the narrow layer gathered endpoint rows"))
    outs, got = grads_of(front)
    assert seen == [batch_norm]
    if batch_norm:
        return

    def old_front(b1h, b2h, e, w3, b3, graph, moments=True):
        return _layer_expression(graph)(b1h, b2h, e, w3, b3), None

    monkeypatch.setattr(gated_gcn, "gather_by_endpoint", gather_by_endpoint)
    ref_outs, ref = grads_of(old_front)
    for a, b in zip(outs, ref_outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    for k, w in ref.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()) + 1e-6, err_msg=k)

