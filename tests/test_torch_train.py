"""The port's training path on the CPU, held against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; the port
runs its kernels' plain versions (CPU tensors), the JAX side its custom
VJPs. Per-op gradients are compared twice, as in tests/test_torch_ops.py:
with ``backend="pallas_interpret"`` on the banded graph at D=128, so that
JAX takes its Pallas backward kernels (``sorted_segment_sum_pallas``,
``segment_sum_unsorted_pallas``, ``gate_front_bwd_stream_pallas``,
``epilog_bwd_pallas``, ``rev_bwd_pallas``), and with ``"xla"`` on the
random graph. Every cotangent is random on pad rows too, so a backward that
masks padding differently from the JAX VJP fails.

Tolerances:
  * per-op gradients rtol = atol = 1e-5: both sides sum in f32 in other
    orders (one-hot matmul blocks, segment_sum, index_add_). The outputs
    summed over every edge (``d_W3 = eᵀ·d_total``, ``d_bias3``,
    ``d_affine``: thousands of terms with cancellation) are held to
    rtol = 1e-5 and atol = 1e-6·max|ref| instead, the rounding of an f32
    sum of that length (measured 7e-7·max|ref|, JAX's xla backend against
    the port on the same CPU);
  * model gradients, relative norm ``‖g − g_jax‖ / ‖g_jax‖`` ≤ 1e-4 per
    leaf: f32 summation order carried through 3 BatchNorm layers (measured
    up to 1.1e-5). Exception: leaves whose reference gradient is below
    1e-6·‖all gradients‖ are f32 rounding noise, and are held to
    ‖g‖ ≤ 1e-5·‖all gradients‖ instead. The biases of A1, B1, B2 and B3
    always are (a BatchNorm follows them and subtracts any per-feature
    constant, so their exact gradient is zero: ~1e-9 against ≥ 1e-4 for
    every other leaf here), and so are A2's and A3's where every node has
    an in-edge and an out-edge (then they shift every node's mean alike);
  * the shipped model's shape (16 layers, D=256) on the 60 kb genome graph
    that chip_smoke.py also trains: relative norm ≤ 5e-2 per leaf. That
    graph is nearly a chain and its PageRank features are nearly constant,
    so the first layer's node BatchNorm sees a variance of ~1e-7 against a
    squared mean of ~1: its f32 E[x²] − mean² is rounding noise, and the two
    packages' ulp-level differences in ``A1·h`` come out amplified (JAX's
    own xla and Pallas backends agree there only because they run the same
    XLA code for that layer). Measured worst leaf 1.7e-2; chip_smoke.py
    holds the card against the CPU to the same 5e-2;
  * 3 Adam steps: losses and parameters to 1e-5, except those same biases
    and every element whose first-step JAX gradient is within 10·eps of
    zero (eps = 1e-8, Adam's): Adam divides their noise gradient by
    |g| + 1e-8, so either package moves them by noise of up to lr per step;
    they are held to within steps·lr of their start on both sides. The
    first step's gradients are held per leaf as above.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.config import Config as JaxConfig
from gnnome_tpu.config import ModelConfig as JaxModelConfig
from gnnome_tpu.core.graph import PAD_SEGMENT as JAX_PAD
from gnnome_tpu.core.graph import build_graph as jax_build_graph
from gnnome_tpu.core.graph import pad_features as jax_pad_features
from gnnome_tpu.core.graph import prepare_edge_features as jax_prepare
from gnnome_tpu.evaluation.metrics import bce_with_logits as jax_bce
from gnnome_tpu.models.model import init_model_params as jax_init
from gnnome_tpu.models.model import model_forward as jax_forward
from gnnome_tpu.ops.segment import (
    _fused_sigma_reverse_unsorted,
    fused_gate_front as jax_gate_front,
    fused_gate_sigma_gather as jax_gate_sigma_gather,
    gather_by_endpoint as jax_gather,
    segment_sum_csr,
)
from gnnome_tpu.train import checkpoint as jax_ckpt
from gnnome_tpu.train import loop as jax_loop
from gnnome_tpu.train.checkpoint import _flatten
from gnnome_tpu_torch.config import Config, ModelConfig, TrainConfig
from gnnome_tpu_torch.core.graph import build_graph, pad_features, prepare_edge_features
from gnnome_tpu_torch.data.simulate import simulate_reads, write_fasta
from gnnome_tpu_torch.evaluation.metrics import bce_with_logits, classification_metrics
from gnnome_tpu_torch.models.model import model_forward
from gnnome_tpu_torch.ops.gate_epilog import (
    GateSigmaGather, epilog_bwd, gate_sigma_gather_plain)
from gnnome_tpu_torch.ops.gate_front import GateFront, gate_front_bwd, gate_front_plain
from gnnome_tpu_torch.ops.reverse_sum import (
    SigmaReverseSum, opp_bwd, rev_bwd, sigma_opposite_plain, sigma_reverse_sum_plain)
from gnnome_tpu_torch.ops.segment_sum import segment_sum
from gnnome_tpu_torch.ops.sigma_aggregate import sigma_aggregate_bwd, sigma_aggregate_plain
from gnnome_tpu_torch.ops.take import TakeRows, take_rows, take_rows_plain
from gnnome_tpu_torch.train import checkpoint as ckpt
from gnnome_tpu_torch.train import loop
from gnnome_tpu_torch.train.checkpoint import iter_leaves, params_from_jax
from test_torch_model import _inputs
from test_torch_ops import D, banded_edges, both_graphs, f32, random_edges, t

TOL = dict(rtol=1e-5, atol=1e-5)
LR = 1e-3
# biases whose exact gradient is zero: a BatchNorm follows them directly
BN_CANCELLED = ("['A1']['b']", "['B1']['b']", "['B2']['b']", "['B3']['b']")
NOISE = 1e-6  # of the norm of all gradients: below it a reference leaf is rounding noise


def grad_errors(got, want, cancelled=BN_CANCELLED):
    """Per leaf ``‖g − g_ref‖ / ‖g_ref‖``, leaving out the leaves whose
    reference gradient is rounding noise; asserts that those include every
    bias whose exact gradient is zero (``cancelled``: the BatchNorm-fed
    ones by default) and that the port's are noise too."""
    total = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2)) for w in want.values()))
    noise = {k for k, w in want.items() if np.linalg.norm(w) <= NOISE * total}
    assert {k for k in want if k.endswith(cancelled)} <= noise
    for k in noise:
        assert np.linalg.norm(got[k]) <= 10 * NOISE * total, k
    return {k: float(np.linalg.norm(got[k] - w) / np.linalg.norm(w))
            for k, w in want.items() if k not in noise}


@pytest.fixture(params=["pallas_interpret", "xla"])
def case(request):
    """(backend, JAX graph, port graph, rng): the banded graph for the
    Pallas kernels, a random graph for XLA; both padded."""
    rng = np.random.default_rng(17)
    make = banded_edges if request.param == "pallas_interpret" else random_edges
    jg, tg = both_graphs(*make(rng))
    return request.param, jg, tg, rng


def grads(fn, inputs, cotangents):
    """Gradients of the port's ``fn(*inputs)`` (numpy inputs) for the given
    cotangents."""
    leaves = [t(x).requires_grad_(True) for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [t(c) for c in cotangents])
    return [x.grad for x in leaves]


def jax_grads(fn, inputs, cotangents):
    out, vjp = jax.vjp(fn, *[jnp.asarray(x) for x in inputs])
    cot = tuple(jnp.asarray(c) for c in cotangents)
    return vjp(cot if isinstance(out, tuple) else cot[0])


def close_all(got, want, edge_sums=()):
    """``edge_sums``: indices of the outputs summed over every edge."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        tol = dict(rtol=1e-5, atol=1e-6 * np.abs(w).max()) if i in edge_sums else TOL
        np.testing.assert_allclose(g.numpy(), w, **tol)


# ---------------------------------------------------------------------------
# per-op gradients against the JAX VJPs
# ---------------------------------------------------------------------------


def test_segment_sum_matches_jax(case):
    backend, jg, tg, rng = case
    data = f32(rng, jg.n_edges_padded, D)
    for ours, theirs in ((tg.by_dst, jg.by_dst), (tg.by_src, jg.by_src)):
        want = segment_sum_csr(jnp.asarray(data), theirs, jg.n_nodes_padded, backend)
        np.testing.assert_allclose(segment_sum(t(data), ours).numpy(), np.asarray(want),
                                   **TOL)


def test_gather_by_endpoint_grad_matches_jax(case):
    backend, jg, tg, rng = case
    values = f32(rng, jg.n_nodes_padded, D)
    for (index, csr), (jindex, jcsr) in (((tg.src, tg.by_src), (jg.src, jg.by_src)),
                                         ((tg.dst, tg.by_dst), (jg.dst, jg.by_dst))):
        cot = f32(rng, jg.n_edges_padded, D)
        got = grads(lambda v: TakeRows.apply(v, index, csr), [values], [cot])
        want = jax_grads(lambda v: jax_gather(v, jindex, jcsr, jg.n_nodes_padded, backend),
                         [values], [cot])
        close_all(got, want)


def test_gate_front_grad_matches_jax(case):
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    inputs = [f32(rng, n, D), f32(rng, n, D), f32(rng, e, D),
              f32(rng, D, D, scale=D ** -0.5), f32(rng, D)]
    cot = [f32(rng, e, D), f32(rng, 2, D, scale=1.0 / jg.n_edges)]
    got = grads(lambda *x: GateFront.apply(*x, tg.src, tg.dst, tg.n_edges, tg.by_src,
                                           tg.by_dst), inputs, cot)
    want = jax_grads(lambda *x: jax_gate_front(*x, jg.src, jg.dst, (jg.by_src, jg.by_dst),
                                               n, jg.n_edges, backend), inputs, cot)
    close_all(got, want, edge_sums=(3, 4))


def test_gate_sigma_gather_grad_matches_jax(case):
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    affine = np.stack([rng.uniform(0.5, 1.5, D), rng.standard_normal(D)]).astype(np.float32)
    inputs = [f32(rng, e, D), f32(rng, e, D), f32(rng, n, D), affine]
    cot = [f32(rng, n, 2 * D), f32(rng, e, D)]
    got = grads(lambda *x: GateSigmaGather.apply(*x, tg.by_dst, tg.src, tg.by_src),
                inputs, cot)
    dst_key = jnp.where(jg.edge_mask, jg.dst, JAX_PAD)
    want = jax_grads(lambda *x: jax_gate_sigma_gather(
        *x, (dst_key, jg.src), jg.by_dst, jg.by_src, n, backend), inputs, cot)
    close_all(got, want, edge_sums=(3,))


def test_reverse_sum_grad_matches_jax(case):
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    e_new, values = f32(rng, e, D), f32(rng, n, D)
    cot = [f32(rng, n, 2 * D)]
    got = grads(lambda en, v: SigmaReverseSum.apply(en, v, tg.by_src, tg.dst, tg.by_dst),
                [e_new, values], cot)
    want = jax_grads(lambda en, v: _fused_sigma_reverse_unsorted(
        v, en, jg.by_src.key_canonical, jg.dst, jg.by_src, jg.by_dst, n, backend),
        [e_new, values], cot)
    close_all(got, want)


# ---------------------------------------------------------------------------
# plain backward versions against autograd of the plain forwards
# ---------------------------------------------------------------------------


def test_plain_backward_matches_autograd():
    """On an unpadded graph (a padded edge gathers row 0 in the forward, and
    the JAX VJP, unlike autograd of the gather, drops its cotangent), the
    backward kernels' plain versions give what autograd of the forward
    kernels' plain versions gives, in every form of each."""
    rng = np.random.default_rng(23)
    src, dst, n = random_edges(rng, n=120, e=900)
    g = build_graph(src, dst, n, device="cpu")
    e, d = g.n_edges_padded, 24

    # take rows
    values, cot = f32(rng, n, d), f32(rng, e, d)
    for index, csr in ((g.src, g.by_src), (g.dst, g.by_dst)):
        close_all([segment_sum(t(cot), csr)],
                  grads(lambda v: take_rows_plain(v, index), [values], [cot]))
    # gate front
    inputs = [f32(rng, n, d), f32(rng, n, d), f32(rng, e, d), f32(rng, d, d), f32(rng, d)]
    d_gate, d_mom = f32(rng, e, d), f32(rng, 2, d, scale=0.01)
    want = grads(lambda *x: gate_front_plain(*x, g.src, g.dst, g.n_edges), inputs,
                       [d_gate, d_mom])
    gate, _ = gate_front_plain(*map(t, inputs), g.src, g.dst, g.n_edges)
    d_total, d_bias3 = gate_front_bwd(t(d_gate), gate, t(d_mom), g.n_edges)
    got = [segment_sum(d_total, g.by_src), segment_sum(d_total, g.by_dst),
           d_total @ t(inputs[3]).T, t(inputs[2]).T @ d_total, d_bias3]
    close_all(got, [w.numpy() for w in want], edge_sums=(3, 4))
    # gate epilog with the forward aggregation
    affine = np.stack([rng.uniform(0.5, 1.5, d), rng.standard_normal(d)]).astype(np.float32)
    inputs = [f32(rng, e, d), f32(rng, e, d), f32(rng, n, d), affine]
    g_sums, g_enew = f32(rng, n, 2 * d), f32(rng, e, d)
    want = grads(lambda *x: gate_sigma_gather_plain(*x, g.by_dst, g.src), inputs,
                       [g_sums, g_enew])
    _, e_new = gate_sigma_gather_plain(*map(t, inputs), g.by_dst, g.src)
    d_gr, d_ein, d_vals, d_aff = epilog_bwd(t(inputs[0]), e_new, t(g_enew), t(g_sums),
                                            t(inputs[2]), t(affine), g.by_dst, g.src)
    close_all([d_gr, d_ein, segment_sum(d_vals, g.by_src), d_aff],
              [w.numpy() for w in want], edge_sums=(3,))
    # reverse aggregation
    e_new, values, cot = f32(rng, e, d), f32(rng, n, d), f32(rng, n, 2 * d)
    want = grads(lambda en, v: sigma_reverse_sum_plain(en, v, g.by_src, g.dst),
                       [e_new, values], [cot])
    d_en, d_vr = rev_bwd(t(e_new), t(cot), t(values), g.by_src, g.dst)
    close_all([d_en, segment_sum(d_vr, g.by_dst)], [w.numpy() for w in want])
    # the same in src-sorted order, taken back through inv_order
    want = grads(lambda en, v: sigma_opposite_plain(en, v, g.by_src), [e_new, values], [cot])
    d_en, d_vr = (take_rows(x, g.by_src.inv_order)
                  for x in opp_bwd(t(e_new), t(cot), t(values), g.by_src))
    close_all([d_en, segment_sum(d_vr, g.by_dst)], [w.numpy() for w in want])
    # the σ-aggregate: by_dst over a node table at src, by_dst and by_src
    # over pregathered rows
    for csr, ids, rows in ((g.by_dst, g.src, n), (g.by_dst, None, e), (g.by_src, None, e)):
        inputs = [f32(rng, e, d), f32(rng, rows, d)]
        want = grads(lambda x, v: sigma_aggregate_plain(x, v, csr, ids), inputs, [cot])
        d_e, d_v = sigma_aggregate_bwd(t(inputs[0]), t(cot), t(inputs[1]), csr, ids)
        close_all([d_e, d_v if ids is None else segment_sum(d_v, g.by_src)],
                  [w.numpy() for w in want])
    # the gate epilog over pregathered rows: d_vals is their gradient
    inputs = [f32(rng, e, d), f32(rng, e, d), f32(rng, e, d), affine]
    want = grads(lambda *x: gate_sigma_gather_plain(*x, g.by_dst), inputs, [g_sums, g_enew])
    _, e_new = gate_sigma_gather_plain(*map(t, inputs), g.by_dst)
    got = epilog_bwd(t(inputs[0]), e_new, t(g_enew), t(g_sums), t(inputs[2]), t(affine),
                     g.by_dst)
    close_all(list(got), [w.numpy() for w in want], edge_sums=(3,))


# ---------------------------------------------------------------------------
# the model: gradients, remat, Adam steps, checkpoints, the loop
# ---------------------------------------------------------------------------


def _problem(rng, d, nb_pos_enc=4, layers=3):
    """The graph and features of tests/test_torch_model.py, with labels,
    for both packages (both padded alike)."""
    src, dst, n, e_feat, pe = _inputs(rng, nb_pos_enc=nb_pos_enc)
    y = (rng.random(len(src)) < 0.7).astype(np.float32)
    cfg = JaxModelConfig(hidden_features=d, num_gnn_layers=layers, nb_pos_enc=nb_pos_enc,
                         hidden_edge_scores=16)
    jg = jax_build_graph(src, dst, n)
    jax_in = (jg, jax_prepare(jg, e_feat), jnp.asarray(jax_pad_features(pe, jg.n_nodes_padded)),
              jax_prepare(jg, y))
    g = build_graph(src, dst, n, node_pad_multiple=512, edge_pad_multiple=1024, device="cpu")
    port_in = (g, prepare_edge_features(g, e_feat),
               torch.from_numpy(pad_features(pe, g.n_nodes_padded)), prepare_edge_features(g, y))
    return cfg, jax_in, port_in


def _port_grads(params, port_in, pos_weight, remat="layer"):
    g, e_feat, pe, y = port_in
    leaves = [leaf.requires_grad_(True) for _, leaf in iter_leaves(params)]
    for leaf in leaves:
        leaf.grad = None
    logits = model_forward(params, g, e_feat, pe, remat=remat)
    bce_with_logits(logits, y, g.edge_mask, torch.tensor(pos_weight)).backward()
    return {k: leaf.grad.numpy() for k, leaf in iter_leaves(params)}


def _check_grads(got, want):
    errs = grad_errors(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


@pytest.mark.parametrize("d", [32, 128])
def test_model_grads_match_jax(d):
    cfg, (jg, je, jpe, jy), port_in = _problem(np.random.default_rng(d), d)
    jparams = jax_init(jax.random.PRNGKey(1), cfg)

    def loss_fn(p):
        return jax_bce(jax_forward(p, jg, je, jpe, backend="xla"), jy, jg.edge_mask, 0.5)

    want = _flatten(jax.grad(loss_fn)(jparams))
    got = _port_grads(params_from_jax(_flatten(jparams), device="cpu"), port_in, 0.5)
    assert set(got) == set(want)
    _check_grads(got, want)


DEEP_GRAD_TOL = 5e-2  # chip_smoke.py holds the card to the same bound


def test_deep_model_grads_on_genome_match_jax(genome_root):
    from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset

    (_, s), = AssemblyGraphDataset(genome_root, nb_pos_enc=16, device="cpu")
    g = s.graph
    jg = jax_build_graph(g.src[: g.n_edges].numpy(), g.dst[: g.n_edges].numpy(), g.n_nodes)
    # canonical order in, canonical order out: the JAX graph keeps it
    e_feat, y = (x[: g.n_edges].numpy() for x in (s.e_feat, s.y))
    pos_weight = float((1 - y).sum() / y.sum())
    jparams = jax_init(jax.random.PRNGKey(0), JaxModelConfig())

    def loss_fn(p):
        logits = jax_forward(p, jg, jax_prepare(jg, e_feat),
                             jnp.asarray(jax_pad_features(s.pe.numpy(), jg.n_nodes_padded)),
                             backend="xla")
        return jax_bce(logits, jax_prepare(jg, y), jg.edge_mask, pos_weight)

    want = _flatten(jax.grad(loss_fn)(jparams))
    got = _port_grads(params_from_jax(_flatten(jparams), device="cpu"),
                      (g, s.e_feat, s.pe, s.y), pos_weight)
    errs = grad_errors(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= DEEP_GRAD_TOL, (worst, errs[worst])


def test_remat_modes_give_the_same_gradients():
    cfg, _, port_in = _problem(np.random.default_rng(5), 32, layers=4)
    arrays = _flatten(jax_init(jax.random.PRNGKey(2), cfg))
    ref = _port_grads(params_from_jax(arrays, device="cpu"), port_in, 0.5, remat="none")
    for remat in ("layer", "group", "unroll_group"):
        got = _port_grads(params_from_jax(arrays, device="cpu"), port_in, 0.5, remat=remat)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-9, err_msg=k)
    with pytest.raises(ValueError):
        model_forward(params_from_jax(arrays, device="cpu"), *port_in[:3], remat="scan")


# Adam's first update is lr·g/(|g| + eps) (eps = 1e-8): where the first
# step's gradient is within AT_EPS·eps of zero, the f32 rounding noise of g
# (up to ~1e-9 between the packages' sum orders, measured) decides what
# fraction of lr the element moves (one element of ['layers'][2]['A3']['w']
# with |g| ~ 7e-9 moved by 0.399·lr here and 0.428·lr in JAX). Outside that
# band the update's sensitivity, lr·eps·δ/(|g| + eps)², stays below 1e-6
# for noise δ up to 1e-8, and TOL holds.
AT_EPS = 10
ADAM_EPS = 1e-8


def _jax_first_grad(jparams, jax_in):
    """The gradient of JAX's first step (``train_step``'s loss, xla)."""
    jg, je, jpe, jy = jax_in

    def loss_fn(p):
        return jax_bce(jax_forward(p, jg, je, jpe, backend="xla"), jy, jg.edge_mask, 0.5)

    return _flatten(jax.grad(loss_fn)(jparams))


def _check_params(got, want, start, first_grad, n_steps):
    """Parameters after ``n_steps`` Adam steps, the port's against JAX's:
    TOL per element, but for the biases a BatchNorm cancels and the
    elements whose first gradient is within AT_EPS·eps of zero, which are
    held to n_steps·lr of their start on both sides (Adam moves an element
    by at most ~lr a step)."""
    for k, w in want.items():
        noise = np.abs(first_grad[k]) <= AT_EPS * ADAM_EPS
        if k.endswith(BN_CANCELLED):
            noise[...] = True
        for p in (got[k], w):
            assert np.abs(p - start[k])[noise].max(initial=0.0) \
                <= n_steps * LR * (1 + 1e-3), k
        np.testing.assert_allclose(got[k][~noise], w[~noise], **TOL, err_msg=k)


def _jax_steps(jparams, jax_in, n_steps, opt_state=None):
    jg, je, jpe, jy = jax_in
    opt_state = opt_state or jax_loop.set_lr(jax_loop.make_optimizer().init(jparams), LR)
    losses = []
    for _ in range(n_steps):
        jparams, opt_state, loss, _ = jax_loop.train_step(
            jparams, opt_state, jg, je, jpe, jy, jnp.float32(0.5), backend="xla")
        losses.append(float(loss))
    return jparams, opt_state, losses


def _port_steps(params, opt, port_in, n_steps):
    g, e_feat, pe, y = port_in
    return [float(loop.train_step(params, opt, g, e_feat, pe, y, torch.tensor(0.5))[0])
            for _ in range(n_steps)]


def test_three_adam_steps_match_jax():
    cfg, jax_in, port_in = _problem(np.random.default_rng(9), 32)
    jparams = jax_init(jax.random.PRNGKey(3), cfg)
    start = _flatten(jparams)
    first_grad = _jax_first_grad(jparams, jax_in)
    # the first step's gradients themselves, per leaf, as in test_model_grads_match_jax
    _check_grads(_port_grads(params_from_jax(start, device="cpu"), port_in, 0.5), first_grad)
    params = params_from_jax(start, device="cpu")
    opt = loop.make_optimizer(params, LR)
    losses = _port_steps(params, opt, port_in, 3)
    jparams, _, jlosses = _jax_steps(jparams, jax_in, 3)
    np.testing.assert_allclose(losses, jlosses, **TOL)
    _check_params(ckpt.flatten_params(params), _flatten(jparams), start, first_grad, 3)


def test_checkpoints_resume_across_packages(tmp_path):
    """One step in one package, a checkpoint, one step in the other: equal
    to two steps in the first, both ways round."""
    cfg, jax_in, port_in = _problem(np.random.default_rng(13), 32, layers=2)
    jparams0 = jax_init(jax.random.PRNGKey(4), cfg)
    start = _flatten(jparams0)
    first_grad = _jax_first_grad(jparams0, jax_in)
    jparams2, _, jlosses = _jax_steps(jparams0, jax_in, 2)

    # JAX writes after step 1, the port resumes and takes step 2
    jparams1, jstate1, _ = _jax_steps(jax_init(jax.random.PRNGKey(4), cfg), jax_in, 1)
    jax_ckpt.save_checkpoint(str(tmp_path / "j.npz"), jparams1, jstate1, 0,
                             scalars={"lr": LR})
    params = params_from_jax(start, device="cpu")
    opt = loop.make_optimizer(params, 0.5)
    epoch, meta = ckpt.load_checkpoint(str(tmp_path / "j.npz"), params, opt)
    assert (epoch, meta["lr"], opt.param_groups[0]["lr"]) == (0, LR, pytest.approx(LR))
    loss = _port_steps(params, opt, port_in, 1)
    np.testing.assert_allclose(loss, jlosses[1:], **TOL)
    _check_params(ckpt.flatten_params(params), _flatten(jparams2), start, first_grad, 2)

    # the port writes after step 1, JAX resumes and takes step 2
    params = params_from_jax(start, device="cpu")
    opt = loop.make_optimizer(params, LR)
    losses = _port_steps(params, opt, port_in, 2)
    params = params_from_jax(start, device="cpu")
    opt = loop.make_optimizer(params, LR)
    _port_steps(params, opt, port_in, 1)
    ckpt.save_checkpoint(str(tmp_path / "p.npz"), params, opt, 0, scalars={"lr": LR})
    template = jax_init(jax.random.PRNGKey(0), cfg)
    jp, jstate, epoch, meta = jax_ckpt.load_checkpoint(
        str(tmp_path / "p.npz"), template,
        jax_loop.set_lr(jax_loop.make_optimizer().init(template), 0.5))
    assert (epoch, meta["lr"]) == (0, LR)
    jp, _, jloss = _jax_steps(jp, jax_in, 1, jstate)
    np.testing.assert_allclose(jloss, losses[1:], **TOL)
    params = params_from_jax(start, device="cpu")
    opt = loop.make_optimizer(params, LR)
    _port_steps(params, opt, port_in, 2)
    _check_params(_flatten(jp), ckpt.flatten_params(params), start, first_grad, 2)


@pytest.fixture(scope="module")
def genome_root(tmp_path_factory):
    """Simulated reads of a 60 kb genome with a planted repeat (without one
    every edge is positive and pos_weight degenerates)."""
    root = tmp_path_factory.mktemp("train_genome")
    rng = np.random.default_rng(0)
    genome = rng.choice(list("ACGT"), size=60_000)
    genome[30_000:34_000] = genome[5_000:9_000]
    records = simulate_reads("".join(genome), coverage=14.0,
                             lengths=np.full(200, 2200, dtype=np.int64), seed=1)
    os.makedirs(root / "raw")
    write_fasta(str(root / "raw" / "0.fasta"), records)
    return str(root)


def _small_cfg(tmp_path, **train_kw):
    return Config(
        model=ModelConfig(num_gnn_layers=4, hidden_features=64, nb_pos_enc=8),
        train=TrainConfig(num_epochs=2, num_parts_train=1,
                          checkpoint_dir=str(tmp_path / "ckpt"),
                          pretrained_dir=str(tmp_path / "pre"), **train_kw))


def test_train_loop_overfits_and_resumes(genome_root, tmp_path):
    """The verify recipe: steps of train_step lower the loss, eval_step
    scores the graph, and train() resumes from its own checkpoint."""
    from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset

    cfg = _small_cfg(tmp_path)
    (_, s), = AssemblyGraphDataset(genome_root, nb_pos_enc=8, device="cpu")
    y = s.y[: s.graph.n_edges]
    assert 0 < float(y.sum()) < len(y)
    pos_weight = torch.tensor(float(len(y) - y.sum()) / float(y.sum()))
    params = loop.init_model_params(torch.Generator().manual_seed(0), cfg.model, "cpu")
    opt = loop.make_optimizer(params, LR)
    losses = [float(loop.train_step(params, opt, s.graph, s.e_feat, s.pe, s.y,
                                    pos_weight)[0]) for _ in range(12)]
    assert losses[-1] < losses[0]
    loss, counts, logits = loop.eval_step(params, s.graph, s.e_feat, s.pe, s.y, pos_weight)
    assert logits.shape == (s.graph.n_edges_padded,) and np.isfinite(float(loss))
    assert classification_metrics(counts)["f1"] > 0.3

    logs = []
    out = str(tmp_path / "run" / "overfit")
    first = loop.train(genome_root, None, out=out, overfit=True, cfg=cfg,
                       log_fn=logs.append, device="cpu")
    assert len(first["loss_train"]) == 2 and os.path.exists(first["best_model"])
    cfg.train.num_epochs = 4
    second = loop.train(genome_root, None, out=out, overfit=True, cfg=cfg,
                        log_fn=logs.append, device="cpu")
    assert any(m.startswith("Resumed from") and m.endswith("at epoch 2") for m in logs)
    assert len(second["loss_train"]) == 4
    assert second["loss_train"][:2] == pytest.approx(first["loss_train"], abs=1e-9)
    assert second["loss_train"][-1] < second["loss_train"][0]
    assert os.path.exists(os.path.join(cfg.train.checkpoint_dir, "runs",
                                       "overfit.metrics.jsonl"))


def test_train_refuses_what_is_not_ported(genome_root, tmp_path, monkeypatch):
    """An unknown ``compute_dtype`` is refused before any data is read (bf16
    covers every model: tests/test_torch_bf16.py); the default ClusterGCN
    regime (500 parts, batches of 50 clusters, jitter 100) is accepted and
    trains on pieces."""
    from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset

    cfg = _small_cfg(tmp_path)
    cfg.train.num_epochs = 1
    for k in ("num_parts_train", "batch_size_train", "cluster_jitter"):
        setattr(cfg.train, k, getattr(TrainConfig(), k))
    piece_nodes = []
    step = loop.train_step

    def counted(*args, **kw):
        piece_nodes.append(args[2].n_nodes)
        return step(*args, **kw)

    monkeypatch.setattr(loop, "train_step", counted)
    out = loop.train(genome_root, None, overfit=True, cfg=cfg, log_fn=lambda m: None,
                     device="cpu")
    assert len(out["loss_train"]) == 1 and np.isfinite(out["loss_train"]).all()
    (_, s), = AssemblyGraphDataset(genome_root, nb_pos_enc=8, device="cpu")
    # several pieces, which cover the graph once
    assert len(piece_nodes) > 1 and sum(piece_nodes) == s.graph.n_nodes
    cfg = _small_cfg(tmp_path, compute_dtype="float16")
    cfg.model.batch_norm = False
    with pytest.raises(ValueError, match="compute_dtype='float16'"):
        loop.train(str(tmp_path / "no_such_dataset"), None, overfit=True, cfg=cfg,
                   device="cpu")
    assert JaxConfig().train.num_parts_train == Config().train.num_parts_train > 1


def test_plateau_scheduler_matches_jax():
    ours = loop.ReduceLROnPlateau(factor=0.5, patience=1)
    theirs = jax_loop.ReduceLROnPlateau(factor=0.5, patience=1)
    lr_a = lr_b = 1.0
    for metric in (1.0, 1.1, 1.2, 0.5, 0.6, 0.7, 0.4):
        lr_a, lr_b = ours.step(metric, lr_a), theirs.step(metric, lr_b)
        assert lr_a == lr_b
        assert ours.state_dict() == theirs.state_dict()
