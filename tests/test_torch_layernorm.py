"""The LayerNorm layer, the wide-gather layer and the last four TPU kernels'
counterparts, held against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the port
runs its kernels' plain versions (CPU tensors). Per-op values and VJPs are
compared as in tests/test_torch_train.py: with ``backend="pallas_interpret"``
on the banded graph at D=128, so that JAX runs ``fused_sigma_aggregate_pallas``
and ``fused_gate_sigma_aggregate_pallas`` themselves in interpret mode, and
with ``"xla"`` on the random graph; both graphs carry pad nodes and PAD
edges, and every cotangent is random on pad rows too. The opposite-order
aggregation (``fused_sigma_opposite_pallas`` / ``opp_bwd_pallas``) runs in
interpret mode on a graph of 40 nodes, which keeps it to a few seconds.

Tolerances (the same reasons as tests/test_torch_train.py):
  * per-op values and gradients rtol = atol = 1e-5 (f32 sums in other
    orders); ``d_affine``, summed over every edge, to rtol 1e-5 and
    atol 1e-6·max|ref|;
  * 3-layer model gradients per leaf ``‖g − g_jax‖ / ‖g_jax‖`` ≤ 1e-4, and
    logits to 1e-4; leaves whose reference gradient is below 1e-6 of the
    whole gradient's norm are rounding noise, held to 1e-5 of it. On the
    BatchNorm variants those include every BatchNorm-fed bias (exact
    gradient zero); LayerNorm normalises rows, so no bias is cancelled there;
  * dropout: Torch cannot reproduce JAX's random stream, so no mask is
    compared across the packages. Rate 0 is the identity (bit for bit),
    kept entries are the undropped ones times 1/(1 − rate) (rtol 1e-6), and
    the kept share lies within 5 binomial standard deviations of 1 − rate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.core.graph import PAD_SEGMENT as JAX_PAD
from gnnome_tpu.evaluation.metrics import bce_with_logits as jax_bce
from gnnome_tpu.models.model import init_model_params as jax_init
from gnnome_tpu.models.model import model_forward as jax_forward
from gnnome_tpu.ops.segment import (
    _fused_sigma_aggregate,
    _fused_sigma_opposite as jax_fused_sigma_opposite,
    fused_gate_sigma_aggregate as jax_gate_sigma_aggregate,
    gated_aggregate as jax_gated_aggregate,
    gated_aggregate_opposite as jax_gated_aggregate_opposite,
    gated_aggregate_pregathered as jax_gated_aggregate_pregathered,
    gather_by_endpoint as jax_gather,
    opposite_megafused_supported,
)
from gnnome_tpu.train import checkpoint as jax_ckpt
from gnnome_tpu.train import loop as jax_loop
from gnnome_tpu.train.checkpoint import _flatten
from gnnome_tpu_torch.core.graph import build_graph
from gnnome_tpu_torch.evaluation.metrics import bce_with_logits
from gnnome_tpu_torch.models.gated_gcn import gated_gcn_layer, init_gated_gcn_layer
from gnnome_tpu_torch.models.model import model_forward
from gnnome_tpu_torch.ops.reverse_sum import opp_bwd, sigma_opposite_plain
from gnnome_tpu_torch.ops.segment import (
    _fused_sigma_opposite,
    fused_gate_sigma_aggregate,
    gated_aggregate,
    gated_aggregate_opposite,
    gated_aggregate_pregathered,
)
from gnnome_tpu_torch.ops.sigma_aggregate import SigmaAggregate, sigma_aggregate_plain
from gnnome_tpu_torch.ops.take import take_rows
from gnnome_tpu_torch.train import checkpoint as ckpt
from gnnome_tpu_torch.train import loop
from gnnome_tpu_torch.train.checkpoint import iter_leaves, params_from_jax
from test_torch_ops import D, banded_edges, both_graphs, f32, t
from test_torch_train import (  # noqa: F401  (genome_root is a fixture)
    BN_CANCELLED, _problem, _small_cfg, close_all, genome_root, grad_errors, grads,
    jax_grads)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(params=["pallas_interpret", "xla"])
def case(request):
    """(backend, JAX graph, port graph, rng): the banded graph for the
    Pallas kernels, a random graph for XLA; both padded."""
    from test_torch_ops import random_edges

    rng = np.random.default_rng(29)
    make = banded_edges if request.param == "pallas_interpret" else random_edges
    jg, tg = both_graphs(*make(rng))
    return request.param, jg, tg, rng


def _keys(jg):
    return (jnp.where(jg.edge_mask, jg.dst, JAX_PAD), jnp.where(jg.edge_mask, jg.src, JAX_PAD))


# ---------------------------------------------------------------------------
# row 10: the σ-aggregate, in each of its forms, against _fused_sigma_aggregate
# ---------------------------------------------------------------------------

FORMS = ("gather", "pregathered_by_dst", "pregathered_by_src")


@pytest.mark.parametrize("form", FORMS)
def test_sigma_aggregate_matches_jax(case, form):
    """The sums [N, 2D] and their VJP: the gather form against JAX's
    endpoint gather composed with ``_fused_sigma_aggregate`` (the gather's
    VJP is the segment sum over by_src), the pregathered forms against
    ``_fused_sigma_aggregate`` over by_dst and by_src."""
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    dst_key, src_key = _keys(jg)
    e_pre = f32(rng, e, D)
    cot = [f32(rng, n, 2 * D)]
    if form == "gather":
        values = f32(rng, n, D)
        got = grads(lambda x, v: SigmaAggregate.apply(x, v, tg.by_dst, tg.src, tg.by_src),
                    [e_pre, values], cot)
        want = jax_grads(lambda x, v: _fused_sigma_aggregate(
            x, jax_gather(v, jg.src, jg.by_src, n, backend), dst_key, jg.by_dst, n,
            backend), [e_pre, values], cot)
        fwd = (sigma_aggregate_plain(t(e_pre), t(values), tg.by_dst, tg.src),
               _fused_sigma_aggregate(jnp.asarray(e_pre), jax_gather(
                   jnp.asarray(values), jg.src, jg.by_src, n, backend), dst_key,
                   jg.by_dst, n, backend))
    else:
        csr, jcsr, key = ((tg.by_dst, jg.by_dst, dst_key) if form == "pregathered_by_dst"
                          else (tg.by_src, jg.by_src, src_key))
        vals = f32(rng, e, D)
        got = grads(lambda x, v: SigmaAggregate.apply(x, v, csr, None, None),
                    [e_pre, vals], cot)
        want = jax_grads(lambda x, v: _fused_sigma_aggregate(x, v, key, jcsr, n, backend),
                         [e_pre, vals], cot)
        fwd = (sigma_aggregate_plain(t(e_pre), t(vals), csr),
               _fused_sigma_aggregate(jnp.asarray(e_pre), jnp.asarray(vals), key, jcsr, n,
                                      backend))
    np.testing.assert_allclose(fwd[0].numpy(), np.asarray(fwd[1]), **TOL)
    close_all(got, want)
    # the pad rows' cotangents reach no input
    if form != "gather":
        assert got[1][tg.n_edges:].abs().max() == 0


def test_gated_aggregate_means_match_jax(case):
    """The public σ-weighted means (``gated_aggregate`` by_dst with the
    gather, ``gated_aggregate_pregathered`` by_dst and by_src) and their
    VJPs, cotangents random on pad rows."""
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    dst_key, src_key = _keys(jg)
    e_pre, values, vals = f32(rng, e, D), f32(rng, n, D), f32(rng, e, D)
    cot = [f32(rng, n, D)]
    got = grads(lambda x, v: gated_aggregate(v, x, tg.src, tg.by_src, tg.by_dst),
                [e_pre, values], cot)
    want = jax_grads(lambda x, v: jax_gated_aggregate(
        v, x, jg.src, jg.by_src, jg.by_dst, n, key=dst_key, backend=backend),
        [e_pre, values], cot)
    close_all(got, want)
    for csr, jcsr, key in ((tg.by_dst, jg.by_dst, dst_key), (tg.by_src, jg.by_src, src_key)):
        got = grads(lambda x, v: gated_aggregate_pregathered(v, x, csr), [e_pre, vals], cot)
        want = jax_grads(lambda x, v: jax_gated_aggregate_pregathered(
            v, x, jcsr, n, key, backend=backend), [e_pre, vals], cot)
        close_all(got, want)


# ---------------------------------------------------------------------------
# row 11: the gate epilog over pregathered values
# ---------------------------------------------------------------------------


def test_gate_sigma_aggregate_grad_matches_jax(case):
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    dst_key, _ = _keys(jg)
    affine = np.stack([rng.uniform(0.5, 1.5, D), rng.standard_normal(D)]).astype(np.float32)
    inputs = [f32(rng, e, D), f32(rng, e, D), f32(rng, e, D), affine]
    cot = [f32(rng, n, 2 * D), f32(rng, e, D)]
    sums, e_new = fused_gate_sigma_aggregate(*map(t, inputs), tg.by_dst)
    jsums, je_new = jax_gate_sigma_aggregate(*map(jnp.asarray, inputs), dst_key, jg.by_dst,
                                             n, backend)
    np.testing.assert_allclose(e_new.numpy(), np.asarray(je_new), **TOL)
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), **TOL)
    got = grads(lambda *x: fused_gate_sigma_aggregate(*x, tg.by_dst), inputs, cot)
    want = jax_grads(lambda *x: jax_gate_sigma_aggregate(*x, dst_key, jg.by_dst, n, backend),
                     inputs, cot)
    close_all(got, want, edge_sums=(3,))


# ---------------------------------------------------------------------------
# rows 12-13: the reverse aggregation in src-sorted order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
def test_sigma_opposite_matches_jax(backend):
    """``_fused_sigma_opposite`` (sums and VJP) and ``gated_aggregate_opposite``
    (means and VJP). Under pallas_interpret JAX runs
    ``fused_sigma_opposite_pallas`` and ``opp_bwd_pallas`` on a 40-node
    graph; under xla its composition on a random graph."""
    from test_torch_ops import random_edges

    rng = np.random.default_rng(43)
    if backend == "pallas_interpret":
        src = rng.integers(0, 40, 260).astype(np.int32)
        dst = rng.integers(0, 40, 260).astype(np.int32)
        jg, tg = both_graphs(src, dst, 40)
        jcsr = jg.by_src
        assert jcsr.order_plan.ok and jcsr.opp_plan.ok and jcsr.expand_plan.ok
    else:
        jg, tg = both_graphs(*random_edges(rng))
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    values, e_new = f32(rng, n, D), f32(rng, e, D)
    cot = [f32(rng, n, 2 * D)]
    got = grads(lambda v, x: _fused_sigma_opposite(v, x, tg.by_src, tg.by_dst),
                [values, e_new], cot)
    want = jax_grads(lambda v, x: jax_fused_sigma_opposite(v, x, jg.by_src, jg.by_dst, n,
                                                           backend), [values, e_new], cot)
    close_all(got, want)
    np.testing.assert_allclose(
        sigma_opposite_plain(t(e_new), t(values), tg.by_src).numpy(),
        np.asarray(jax_fused_sigma_opposite(jnp.asarray(values), jnp.asarray(e_new),
                                            jg.by_src, jg.by_dst, n, backend)), **TOL)
    if backend == "xla":
        assert not opposite_megafused_supported(jg.by_src, D, 4, backend)
        cot = [f32(rng, n, D)]
        got = grads(lambda v, x: gated_aggregate_opposite(v, x, tg.by_src, tg.by_dst),
                    [values, e_new], cot)
        want = jax_grads(lambda v, x: jax_gated_aggregate_opposite(
            v, x, jg.by_src, jg.by_dst, n, backend=backend), [values, e_new], cot)
        close_all(got, want)


def test_opp_bwd_is_rev_bwd_in_sorted_order():
    """Row 13's outputs are row 9's per-edge cotangents permuted into
    src-sorted order; ``inv_order`` takes them back exactly."""
    from gnnome_tpu_torch.ops.reverse_sum import rev_bwd

    rng = np.random.default_rng(47)
    src, dst, n = banded_edges(rng)
    g = build_graph(src, dst, n, node_pad_multiple=512, edge_pad_multiple=1024, device="cpu")
    e_new, values = t(f32(rng, g.n_edges_padded, 16)), t(f32(rng, g.n_nodes_padded, 16))
    g_sums = t(f32(rng, g.n_nodes_padded, 32))
    d_e_s, d_v_s = opp_bwd(e_new, g_sums, values, g.by_src)
    d_e, d_v = rev_bwd(e_new, g_sums, values, g.by_src, g.dst)
    order = g.by_src.order.long()
    assert torch.equal(d_e_s, d_e[order]) and torch.equal(d_v_s, d_v[order])
    assert torch.equal(take_rows(d_e_s, g.by_src.inv_order), d_e)
    assert d_e_s[g.n_edges:].abs().max() == 0 and d_v_s[g.n_edges:].abs().max() == 0


# ---------------------------------------------------------------------------
# the model: LayerNorm and wide-gather variants against jax.grad
# ---------------------------------------------------------------------------

VARIANTS = {  # name: (batch_norm, wide_gathers)
    "layernorm": (False, False),
    "wide": (True, True),
    "wide_src": (True, "src"),
    "layernorm_wide": (False, True),
}


def _port_loss_grads(params, port_in, pos_weight, **kw):
    g, e_feat, pe, y = port_in
    leaves = [leaf.requires_grad_(True) for _, leaf in iter_leaves(params)]
    for leaf in leaves:
        leaf.grad = None
    logits = model_forward(params, g, e_feat, pe, **kw)
    bce_with_logits(logits, y, g.edge_mask, torch.tensor(pos_weight)).backward()
    return logits.detach(), {k: leaf.grad.numpy() for k, leaf in iter_leaves(params)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("d", [32, 128])
def test_model_grads_match_jax(d, variant):
    batch_norm, wide = VARIANTS[variant]
    cfg, (jg, je, jpe, jy), port_in = _problem(np.random.default_rng(d + 1), d)
    cfg.batch_norm = batch_norm
    jparams = jax_init(jax.random.PRNGKey(1), cfg)

    def loss_fn(p):
        logits = jax_forward(p, jg, je, jpe, batch_norm=batch_norm, backend="xla",
                             wide_gathers=wide)
        return jax_bce(logits, jy, jg.edge_mask, 0.5), logits

    (_, jlogits), want = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    logits, got = _port_loss_grads(params_from_jax(_flatten(jparams), device="cpu"),
                                   port_in, 0.5, batch_norm=batch_norm, wide_gathers=wide)
    n_real = port_in[0].n_edges
    np.testing.assert_allclose(logits[:n_real].numpy(), np.asarray(jlogits)[:n_real],
                               rtol=1e-4, atol=1e-4)
    want = _flatten(want)
    errs = grad_errors(got, want, cancelled=BN_CANCELLED if batch_norm else ())
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


@pytest.mark.parametrize("variant", ["layernorm", "wide"])
def test_remat_layer_recompute_matches_no_remat(variant):
    """Under ``remat="layer"`` the recomputed layers reproduce the forward:
    the same gradients as keeping every layer's intermediates."""
    batch_norm, wide = VARIANTS[variant]
    cfg, _, port_in = _problem(np.random.default_rng(5), 32, layers=3)
    cfg.batch_norm = batch_norm
    arrays = _flatten(jax_init(jax.random.PRNGKey(2), cfg))
    ref = _port_loss_grads(params_from_jax(arrays, device="cpu"), port_in, 0.5,
                           batch_norm=batch_norm, wide_gathers=wide, remat="none")[1]
    got = _port_loss_grads(params_from_jax(arrays, device="cpu"), port_in, 0.5,
                           batch_norm=batch_norm, wide_gathers=wide, remat="layer")[1]
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-9, err_msg=k)


def test_layer_refuses_unknown_wide_gathers():
    cfg, _, port_in = _problem(np.random.default_rng(6), 16, layers=1)
    params = params_from_jax(_flatten(jax_init(jax.random.PRNGKey(0), cfg)), device="cpu")
    with pytest.raises(ValueError, match="wide_gathers"):
        model_forward(params, *port_in[:3], wide_gathers="auto")


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def _layer_inputs(seed=3, d=32):
    rng = np.random.default_rng(seed)
    from test_torch_ops import random_edges

    g = build_graph(*random_edges(rng, n=200, e=1500), device="cpu")
    params = init_gated_gcn_layer(torch.Generator().manual_seed(seed), d, device="cpu")
    return params, g, t(f32(rng, g.n_nodes_padded, d)), t(f32(rng, g.n_edges_padded, d))


@pytest.mark.parametrize("batch_norm", [True, False])
def test_dropout_scales_kept_entries_and_keeps_its_share(batch_norm):
    params, g, h, e = _layer_inputs()
    rate = 0.3
    plain, e_plain = gated_gcn_layer(params, g, h, e, batch_norm=batch_norm)
    dropped, e_drop = gated_gcn_layer(params, g, h, e, batch_norm=batch_norm,
                                      dropout_rate=rate,
                                      dropout_rng=torch.Generator().manual_seed(0))
    assert torch.equal(e_drop, e_plain)  # the edge state is not dropped
    kept = dropped != 0
    torch.testing.assert_close(dropped[kept], plain[kept] / (1 - rate), rtol=1e-6, atol=0)
    share, p, count = float(kept.float().mean()), 1 - rate, kept.numel()
    assert abs(share - p) <= 5 * np.sqrt(p * (1 - p) / count), share
    again, _ = gated_gcn_layer(params, g, h, e, batch_norm=batch_norm, dropout_rate=rate,
                               dropout_rng=torch.Generator().manual_seed(0))
    assert torch.equal(again, dropped)  # one seed, one mask


def test_dropout_in_model_forward():
    cfg, _, (g, e_feat, pe, y) = _problem(np.random.default_rng(8), 32, layers=2)
    params = params_from_jax(_flatten(jax_init(jax.random.PRNGKey(0), cfg)), device="cpu")
    ref = model_forward(params, g, e_feat, pe)
    # rate 0 is the identity, with or without a generator
    assert torch.equal(model_forward(params, g, e_feat, pe, dropout_rate=0.0,
                                     dropout_rng=torch.Generator().manual_seed(1)), ref)
    a = model_forward(params, g, e_feat, pe, dropout_rate=0.5,
                      dropout_rng=torch.Generator().manual_seed(1))
    b = model_forward(params, g, e_feat, pe, dropout_rate=0.5,
                      dropout_rng=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.allclose(a, ref)
    # the dropout path is differentiable (a plain loop, no checkpoint)
    for _, leaf in iter_leaves(params):
        leaf.requires_grad_(True)
    logits = model_forward(params, g, e_feat, pe, dropout_rate=0.5,
                           dropout_rng=torch.Generator().manual_seed(1))
    torch.testing.assert_close(logits, a, rtol=0, atol=0)
    bce_with_logits(logits, y, g.edge_mask, torch.tensor(0.5)).backward()
    assert all(torch.isfinite(leaf.grad).all() for _, leaf in iter_leaves(params))


# ---------------------------------------------------------------------------
# train(): the LayerNorm and wide-gather configs, and strict checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["layernorm", "wide"])
def test_train_variants_run_and_resume(genome_root, tmp_path, variant):
    """The verify recipe's ``train()`` for 2 epochs, then a resume to 3."""
    batch_norm, wide = VARIANTS[variant]
    cfg = _small_cfg(tmp_path, wide_gathers=wide)
    cfg.model.batch_norm = batch_norm
    logs = []
    out = str(tmp_path / "run" / variant)
    first = loop.train(genome_root, None, out=out, overfit=True, cfg=cfg,
                       log_fn=logs.append, device="cpu")
    cfg.train.num_epochs = 3
    second = loop.train(genome_root, None, out=out, overfit=True, cfg=cfg,
                        log_fn=logs.append, device="cpu")
    assert any(m.startswith("Resumed from") and m.endswith("at epoch 2") for m in logs)
    assert len(second["loss_train"]) == 3 and np.isfinite(second["loss_train"]).all()
    assert second["loss_train"][:2] == pytest.approx(first["loss_train"], abs=1e-9)


def test_resolve_perf_matches_jax():
    from gnnome_tpu_torch.config import TrainConfig

    small = build_graph(np.array([0, 1], np.int32), np.array([1, 0], np.int32), 2,
                        device="cpu")

    class Big:  # only the padded edge count is read
        n_edges_padded = 700_000

    for wide in ("auto", False, True, "src"):
        for remat in ("layer", "group", "unroll_group"):
            tc = TrainConfig(wide_gathers=wide, remat=remat, remat_group=4)
            for graph in (small, Big()):
                assert loop.resolve_perf(tc, graph) == jax_loop.resolve_perf(tc, graph)


def test_load_checkpoint_refuses_another_model(tmp_path):
    """A checkpoint of another depth or width, or one missing an optimizer
    leaf, raises naming the leaf and leaves the model as it was; a
    matching one loads."""
    cfg, _, port_in = _problem(np.random.default_rng(11), 16, layers=4)
    deep = params_from_jax(_flatten(jax_init(jax.random.PRNGKey(0), cfg)), device="cpu")
    opt = loop.make_optimizer(deep, 1e-3)
    loop.train_step(deep, opt, *port_in, torch.tensor(0.5))
    ckpt.save_checkpoint(str(tmp_path / "deep.npz"), deep, opt, 0, scalars={"lr": 1e-3})

    def template(layers, d):
        cfg.num_gnn_layers, cfg.hidden_features = layers, d
        p = params_from_jax(_flatten(jax_init(jax.random.PRNGKey(1), cfg)), device="cpu")
        return p, loop.make_optimizer(p, 1e-3)

    shallow, opt2 = template(2, 16)
    before = ckpt.flatten_params(shallow)
    with pytest.raises(KeyError, match=r"layers\W+\[2\]"):
        ckpt.load_checkpoint(str(tmp_path / "deep.npz"), shallow, opt2)
    narrow, opt3 = template(4, 8)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint(str(tmp_path / "deep.npz"), narrow, opt3)
    for k, v in ckpt.flatten_params(shallow).items():
        np.testing.assert_array_equal(v, before[k])

    with np.load(tmp_path / "deep.npz") as z:
        arrays = {k: z[k] for k in z.files if "nu['score2']['b']" not in k}
    np.savez(tmp_path / "short.npz", **arrays)
    same, opt4 = template(4, 16)
    with pytest.raises(KeyError, match=r"nu\W+score2\W+b"):
        ckpt.load_checkpoint(str(tmp_path / "short.npz"), same, opt4)
    epoch, meta = ckpt.load_checkpoint(str(tmp_path / "deep.npz"), same, opt4)
    assert (epoch, meta["lr"]) == (0, 1e-3)
    for k, v in ckpt.flatten_params(same).items():
        np.testing.assert_array_equal(v, ckpt.flatten_params(deep)[k])
    # the JAX package reads the port's checkpoint of the same model
    jp, _, jepoch, _ = jax_ckpt.load_checkpoint(
        str(tmp_path / "deep.npz"), jax_init(jax.random.PRNGKey(0), cfg),
        jax_loop.set_lr(jax_loop.make_optimizer().init(jax_init(jax.random.PRNGKey(0), cfg)),
                        0.5))
    assert jepoch == 0
    for k, v in _flatten(jp).items():
        np.testing.assert_array_equal(v, ckpt.flatten_params(deep)[k])

