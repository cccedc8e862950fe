"""bf16 compute for the LayerNorm model and the wide gathers on the CPU, held
against the JAX package's bf16: rows 10 and 11 and their VJPs, the bf16
LayerNorm and the LayerNorm model (tests/test_torch_bf16_wide_models.py
holds the wide-gather models with the same checks; the two files run on
two test workers).

Inputs are made with numpy from a seed and rounded to bf16 once; both
packages get the same bf16 values (the helpers of tests/test_torch_bf16.py).
The port runs its kernels' plain versions (CPU tensors), which round where
the TPU kernels round. JAX runs ``backend="pallas_interpret"`` on a banded
graph, where its ``fused_sigma_aggregate_pallas`` and
``fused_gate_sigma_aggregate_pallas`` run in bf16 (interpreted), and
``"xla"`` on a random graph.

Tolerances, and why:
  * bf16 outputs computed from the same inputs in f32 and rounded once
    (``d_e``, ``d_v``, ``e_new``, ``d_gate_raw``, ``d_e_in``, ``d_vals``):
    one bf16 ulp of the larger magnitude, ``ulp(x) = 2^(⌊log2|x|⌋ − 7)``
    (the f32 values differ by a few f32 ulps and may round apart), plus
    1e-6. A bf16 output rounded from an f32 sum over edges (the gather
    form's ``d_values``) adds 1e-5·max|ref|, as tests/test_torch_bf16.py.
  * f32 sums against ``pallas_interpret``: rtol = atol = 1e-5. Both round
    each summand σ·v and σ to bf16 before an f32 sum (the TPU kernel's
    contract, ``spmm_pallas.py:1233-1236``, ``:1395-1399``); only the
    order of the sums differs. Against ``xla``, whose composition sums f32
    summands (``segment.py:245-246``) and, for row 11, takes σ of the
    rounded ``e_new`` (``segment.py:1040-1045``), they are held to those
    roundings' effect summed over each node's edges (``summand_bound``),
    plus 1e-5.
  * ``d_affine`` (f32, summed over every edge): rtol 1e-5, atol
    1e-6·max|ref|.
  * the bf16 LayerNorm: JAX computes in the input dtype
    (``gnnome_tpu/ops/norm.py:58-68``) and so does the port, the means
    accumulated in f32 and rounded to bf16 (``jnp.mean`` and
    ``torch.mean`` both do); XLA may keep an intermediate in f32 where the
    port rounds it. With ``a = x − μ``, ``r = (var + eps)^-½``, each of
    ``μ``, ``a``, ``a·r``, ``a·r·s`` and the output rounds to bf16 (half an
    ulp each), and ``r`` carries the roundings of the squares, of ``var``
    and of the rsqrt (≤ 2⁻⁹ + 2⁻⁸ + 2⁻⁹ + 2⁻⁹ of it): the two are held to
    twice the sum of those terms' effects on the output (about 1% of
    ``|a·r·s|``, plus an output ulp); a mean summed in bf16 would be off by
    several ulps of μ.
  * the models (2 layers, D = 128, banded graph) and a training step, as
    tests/test_torch_bf16.py: the port within twice the spread of JAX's two
    backends, measured here, in logits, probabilities and each leaf's
    gradient; the loss by the bound the logits imply. The step: the port's
    one Adam step against Adam's first step on each JAX backend's gradient
    (``p − lr·g / (|g| + eps)``, optax's and torch's alike): no more
    elements apart by more than lr than JAX's two backends' steps, twice
    over, plus one (a bf16 gradient's sign is noise where |g| is at its
    rounding, and the two backends may happen to agree on every sign).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.config import ModelConfig as JaxModelConfig
from gnnome_tpu.core.graph import PAD_SEGMENT as JAX_PAD
from gnnome_tpu.core.graph import pad_features as jax_pad_features
from gnnome_tpu.core.graph import prepare_edge_features as jax_prepare
from gnnome_tpu.evaluation.metrics import bce_with_logits as jax_bce
from gnnome_tpu.models.model import init_model_params as jax_init
from gnnome_tpu.models.model import model_forward as jax_forward
from gnnome_tpu.ops.norm import masked_layer_norm as jax_layer_norm
from gnnome_tpu.ops.segment import (
    _fused_gate_bwd,
    _fused_sigma_aggregate,
    fused_gate_sigma_aggregate as jax_gate_sigma_aggregate,
    gather_by_endpoint as jax_gather,
)
from gnnome_tpu.train.checkpoint import _flatten
from gnnome_tpu_torch.core.graph import pad_features, prepare_edge_features
from gnnome_tpu_torch.evaluation.metrics import bce_with_logits
from gnnome_tpu_torch.models.model import model_forward
from gnnome_tpu_torch.ops.norm import masked_layer_norm
from gnnome_tpu_torch.ops.segment import fused_gate_sigma_aggregate
from gnnome_tpu_torch.ops.sigma_aggregate import SigmaAggregate
from gnnome_tpu_torch.train import checkpoint as ckpt
from gnnome_tpu_torch.train import loop
from gnnome_tpu_torch.train.checkpoint import iter_leaves, params_from_jax
from test_torch_bf16 import (
    BF, EDGE_SUM_ATOL, _apart, assert_bf16_close, assert_sums_close, bf16, check_grads,
    check_logits, jb, npf, summand_bound, tb, ulp)
from test_torch_ops import D, banded_edges, both_graphs, random_edges
from test_torch_train import BN_CANCELLED, LR

ATOL = 1e-6  # beside one ulp, for bf16 values near zero


@pytest.fixture(params=["pallas_interpret", "xla"])
def case(request):
    """(backend, JAX graph, port graph, rng): the banded graph for the
    Pallas kernels, a random graph for XLA; both padded."""
    rng = np.random.default_rng(37)
    make = banded_edges if request.param == "pallas_interpret" else random_edges
    jg, tg = both_graphs(*make(rng))
    return request.param, jg, tg, rng


def _keys(jg):
    return (jnp.where(jg.edge_mask, jg.dst, JAX_PAD), jnp.where(jg.edge_mask, jg.src, JAX_PAD))


# ---------------------------------------------------------------------------
# row 10: the σ-aggregate's three forms and their VJP
# ---------------------------------------------------------------------------

FORMS = ("gather", "pregathered_by_dst", "pregathered_by_src")


@pytest.mark.parametrize("form", FORMS)
def test_sigma_aggregate_bf16_matches_jax(case, form):
    """The f32 sums of bf16 ``e`` and values, and the VJP (JAX's ``_fused_bwd``
    through ``jax.vjp``, from the same bf16 inputs): the gather form
    composed with the endpoint gather, whose VJP sums ``d_v`` by src and
    rounds it to the table's bf16."""
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    dst_key, src_key = _keys(jg)
    e_pre = bf16(rng, e, D)
    if form == "gather":
        values = bf16(rng, n, D)

        def ours(x, v):
            return SigmaAggregate.apply(x, v, tg.by_dst, tg.src, tg.by_src)

        def theirs(x, v):
            return _fused_sigma_aggregate(x, jax_gather(v, jg.src, jg.by_src, n, backend),
                                          dst_key, jg.by_dst, n, backend)
        v_rows, key = tb(values)[tg.src], tg.by_dst.key
    else:
        csr, jcsr, jkey = ((tg.by_dst, jg.by_dst, dst_key) if form == "pregathered_by_dst"
                           else (tg.by_src, jg.by_src, src_key))
        values = bf16(rng, e, D)

        def ours(x, v):
            return SigmaAggregate.apply(x, v, csr, None, None)

        def theirs(x, v):
            return _fused_sigma_aggregate(x, v, jkey, jcsr, n, backend)
        v_rows, key = tb(values), csr.key
    leaves = [tb(e_pre).requires_grad_(True), tb(values).requires_grad_(True)]
    sums = ours(*leaves)
    assert sums.dtype == torch.float32
    jsums, vjp = jax.vjp(theirs, jb(e_pre), jb(values))
    assert_sums_close(sums, jsums, backend, summand_bound(tb(e_pre), v_rows, key, n), "sums",
                      strict="pallas_interpret")

    g = rng.standard_normal((n, 2 * D)).astype(np.float32)
    sums.backward(torch.from_numpy(g))
    want = vjp(jnp.asarray(g))
    for name, leaf, w in zip(("d_e", "d_values"), leaves, want):
        assert leaf.grad.dtype == torch.bfloat16 and w.dtype == BF, name
        summed = form == "gather" and name == "d_values"
        atol = EDGE_SUM_ATOL * float(np.abs(npf(w)).max()) if summed else ATOL
        assert_bf16_close(leaf.grad, w, atol=atol, name=name)
    if form != "gather":  # padded edges' cotangents reach no input
        assert leaves[1].grad[tg.n_edges:].abs().max() == 0


# ---------------------------------------------------------------------------
# row 11: the gate epilog over pregathered values, and its VJP
# ---------------------------------------------------------------------------


def test_gate_sigma_aggregate_bf16_matches_jax(case):
    """``e_new`` (one ulp) and the sums; the VJP against JAX's own
    ``_fused_gate_bwd`` on the same residuals (the forward's inputs: it
    recomputes e_new in f32 from them, as the port's bf16 entry does)."""
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    dst_key, _ = _keys(jg)
    affine = np.stack([rng.uniform(0.5, 1.5, D), rng.standard_normal(D)]).astype(np.float32)
    ins = [bf16(rng, e, D), bf16(rng, e, D), bf16(rng, e, D)]
    leaves = [tb(x).requires_grad_(True) for x in ins]
    t_aff = torch.from_numpy(affine).requires_grad_(True)
    sums, e_new = fused_gate_sigma_aggregate(*leaves, t_aff, tg.by_dst)
    assert sums.dtype == torch.float32 and e_new.dtype == torch.bfloat16
    jsums, je_new = jax_gate_sigma_aggregate(*map(jb, ins), jnp.asarray(affine), dst_key,
                                             jg.by_dst, n, backend)
    assert_bf16_close(e_new, je_new, atol=ATOL, name="e_new")
    bound = summand_bound(e_new, leaves[2].detach(), tg.by_dst.key, n, sigma_of_rounded=True)
    assert_sums_close(sums, jsums, backend, bound, "sums", strict="pallas_interpret")

    g_sums, g_enew = rng.standard_normal((n, 2 * D)).astype(np.float32), bf16(rng, e, D)
    torch.autograd.backward([sums, e_new], [torch.from_numpy(g_sums), tb(g_enew)])
    res = (*map(jb, ins), jnp.asarray(affine), dst_key, jg.by_dst.key_plan)
    want = _fused_gate_bwd(n, backend, res, (jnp.asarray(g_sums), jb(g_enew)))
    for name, leaf, w in zip(("d_gate_raw", "d_e_in", "d_vals"), leaves, want):
        assert leaf.grad.dtype == torch.bfloat16 and w.dtype == BF, name
        assert_bf16_close(leaf.grad, w, atol=ATOL, name=name)
    w_aff = npf(want[3])
    assert t_aff.grad.dtype == torch.float32
    np.testing.assert_allclose(t_aff.grad.numpy(), w_aff, rtol=1e-5,
                               atol=1e-6 * np.abs(w_aff).max())


# ---------------------------------------------------------------------------
# the bf16 LayerNorm
# ---------------------------------------------------------------------------


def layer_norm_bound(x, scale, bias, eps=1e-5):
    """Per element, twice the effect on the LayerNorm's output of rounding
    each of its bf16 intermediates (module docstring), from f64 values."""
    x, s, b = (np.asarray(a, np.float64) for a in (x, scale, bias))
    mu = x.mean(-1, keepdims=True)
    a = x - mu
    r = 1.0 / np.sqrt((a * a).mean(-1, keepdims=True) + eps)
    ar, ars = a * r, a * r * s
    out = ars + b
    terms = (ulp(mu) / 2 * np.abs(r * s) + ulp(a) / 2 * np.abs(r * s)
             + (2.0 ** -9 + 2.0 ** -8 + 2.0 ** -9 + 2.0 ** -9) * np.abs(ars)
             + ulp(ar) / 2 * np.abs(s) + ulp(ars) / 2 + ulp(out) / 2)
    return 2 * terms


@pytest.mark.parametrize("shift", [0.0, 3.0])
def test_masked_layer_norm_bf16_matches_jax(shift):
    """bf16 in, bf16 out, computed in the input dtype on both sides; rows
    centred at 0 and at 3 (the mean then takes most of each row)."""
    rng = np.random.default_rng(41)
    x = bf16(rng, 2000, D) + np.float32(shift)
    x = npf(jb(x))
    scale, bias = npf(jb(bf16(rng, D, scale=0.5) + 1.0)), bf16(rng, D)
    got = masked_layer_norm(tb(x), tb(scale), tb(bias))
    want = jax_layer_norm(jb(x), jb(scale), jb(bias))
    assert got.dtype == torch.bfloat16 and want.dtype == BF
    err = np.abs(npf(got) - npf(want))
    bound = layer_norm_bound(x, scale, bias)
    assert (err <= bound).all(), (int((err > bound).sum()), float(err.max()))
    # most elements agree exactly: the two differ only where a rounding does
    assert (err > 0).mean() < 0.05


# ---------------------------------------------------------------------------
# the models and a training step
# ---------------------------------------------------------------------------

BACKENDS = ("xla", "pallas_interpret")


def bf16_model_runs(batch_norm: bool, wide_gathers):
    """The 2-layer, D = 128 model of one variant under bf16 on the banded
    graph: logits, loss and gradients of one JAX parameter set in both JAX
    backends and in the port, the port's one training step, and Adam's
    first step on each backend's gradient."""
    rng = np.random.default_rng(31)
    src, dst, n = banded_edges(rng)
    jg, tg = both_graphs(src, dst, n)
    e_feat = rng.standard_normal((len(src), 2)).astype(np.float32)
    pe = rng.standard_normal((n, 6)).astype(np.float32)
    y = (rng.random(len(src)) < 0.7).astype(np.float32)
    cfg = JaxModelConfig(hidden_features=D, num_gnn_layers=2, nb_pos_enc=4,
                         hidden_edge_scores=16, batch_norm=batch_norm)
    jparams = jax_init(jax.random.PRNGKey(5), cfg)
    start = _flatten(jparams)
    jin = (jax_prepare(jg, e_feat), jnp.asarray(jax_pad_features(pe, jg.n_nodes_padded)),
           jax_prepare(jg, y))
    kw = dict(batch_norm=batch_norm, wide_gathers=wide_gathers, compute_dtype="bfloat16")
    runs = {}
    for backend in BACKENDS:
        def loss_fn(p):
            logits = jax_forward(p, jg, jin[0], jin[1], backend=backend, **kw)
            return jax_bce(logits, jin[2], jg.edge_mask, 0.5), logits

        (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
        grads = {k: np.asarray(v) for k, v in _flatten(grads).items()}
        step = {k: start[k] - np.float32(LR) * g / (np.abs(g) + np.float32(1e-8))
                for k, g in grads.items()}
        runs[backend] = dict(logits=npf(logits)[: jg.n_edges], loss=float(loss), grads=grads,
                             params=step)

    pin = (prepare_edge_features(tg, e_feat),
           torch.from_numpy(pad_features(pe, tg.n_nodes_padded)), prepare_edge_features(tg, y))
    params = params_from_jax(start, device="cpu")
    leaves = dict(iter_leaves(params))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    logits = model_forward(params, tg, pin[0], pin[1], **kw)
    assert logits.dtype == torch.float32
    loss = bce_with_logits(logits, pin[2], tg.edge_mask, torch.tensor(0.5))
    loss.backward()
    assert all(leaf.grad.dtype == torch.float32 for leaf in leaves.values())
    params = params_from_jax(start, device="cpu")
    opt = loop.make_optimizer(params, LR)
    step_loss = float(loop.train_step(params, opt, tg, *pin[:2], pin[2], torch.tensor(0.5),
                                      **kw)[0])
    runs["port"] = dict(logits=npf(logits)[: tg.n_edges], loss=float(loss.detach()),
                        grads={k: leaf.grad.numpy().copy() for k, leaf in leaves.items()},
                        params={k: np.array(v) for k, v in ckpt.flatten_params(params).items()},
                        step_loss=step_loss)
    runs["start"], runs["batch_norm"] = start, batch_norm
    return runs


def check_train_step(runs):
    """The port's step: its loss is the forward's, the master weights stay
    f32 and move by at most lr, and it is as close to Adam's step on each
    JAX backend's gradient as those two are to each other, twice over."""
    jx, jp, port = runs["xla"], runs["pallas_interpret"], runs["port"]
    cancelled = BN_CANCELLED if runs["batch_norm"] else ()
    np.testing.assert_allclose(port["step_loss"], port["loss"], rtol=1e-6)
    start = runs["start"]
    for k, p in port["params"].items():
        assert p.dtype == np.float32, k
        assert np.abs(p - start[k]).max() <= LR * (1 + 1e-3), k
    spread = _apart(jp["params"], jx["params"], cancelled)
    for ref in (jx, jp):
        assert _apart(port["params"], ref["params"], cancelled) <= 2 * spread + 1


@pytest.fixture(scope="module")
def ln_runs():
    return bf16_model_runs(batch_norm=False, wide_gathers=False)


def test_layernorm_bf16_logits_match_jax(ln_runs):
    check_logits(ln_runs)


def test_layernorm_bf16_grads_match_jax(ln_runs):
    check_grads(ln_runs, cancelled=())


def test_layernorm_bf16_train_step_matches_jax(ln_runs):
    check_train_step(ln_runs)
