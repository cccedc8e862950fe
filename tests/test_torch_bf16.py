"""The port's bf16 compute (``compute_dtype="bfloat16"``) on the CPU, held
against the JAX package's bf16.

Inputs are made with numpy from a seed and rounded to bf16 once; both
packages get the same bf16 values. The port runs its kernels' plain
versions (CPU tensors), which round where the TPU kernels round. The JAX
side runs ``backend="xla"`` on a random graph and ``"pallas_interpret"``
on a banded one (where its Pallas kernels run in bf16, interpreted). Each
VJP is compared given the same residuals: the port's forward outputs go
into JAX's own backward function (``gnnome_tpu/ops/segment.py``
``_gate_front_bwd``, ``_fused_gate_gather_bwd``, ``_rev_unsorted_bwd``),
so the backward is held on its own and not through a forward rounding
difference.

Tolerances, and why:
  * ``ulp(x) = 2^(⌊log2|x|⌋ − 7)``, the spacing of bf16 at x. A bf16
    output that both sides compute from the same inputs in f32 and round
    once may differ by one ulp of the larger magnitude: the f32 value
    before the rounding differs by a few f32 ulps (sum order, a fused
    multiply-add) and can fall on either side of a rounding boundary. A
    bf16 output rounded from an f32 sum over edges (``d_W3``, the segment
    sums) adds 1e-5·max|ref| for the sum's f32 rounding, as the f32 tests do.
  * f32 outputs (the aggregation sums, ``d_affine``): rtol = atol = 1e-5, as
    in f32, against the backend that rounds as the port does: the summands
    are the same values, only their order differs. JAX's Pallas kernels
    round each summand σ·v and σ to bf16 before their f32 sum
    (``spmm_pallas.py:2358-2360, 2953-2956``), where its xla composition
    sums f32 products (``segment.py:245-246``). The port's rows 2 and 3
    round as the Pallas kernels do and are held strictly to
    ``pallas_interpret``. The Pallas gate epilog (row 2) also takes σ of
    the f32 e_new, as the port does, where the xla composition takes it of
    the stored bf16 e_new (``segment.py:786-787``). Against ``xla`` the sums
    are held to the sum over their edges of those two roundings' effects:
    half a bf16 ulp of each summand (≤ 2⁻⁸ of it) and σ(1 − σ)·|v| times
    half an ulp of e_new, plus 1e-5.
  * the gate (row 1): the port rounds where the TPU kernel rounds (proj to
    bf16, ``+ b3`` in bf16, the endpoint rows added in f32,
    ``spmm_pallas.py:2619-2645``). JAX's xla composition rounds
    ``b1h[src] + b2h[dst]`` to bf16 first, and its interpreted Pallas
    kernel keeps ``proj + b3`` in f32 on the CPU (XLA's excess precision).
    Each such rounding moves the gate by at most one ulp of a partial sum,
    ≤ 2⁻⁷ of its magnitude, and the product's own rounding may flip with
    the order of its f32 sum: the gate is held to 2⁻⁷·(|b1h[src]| +
    |b2h[dst]| + |proj + b3|) plus one ulp of itself, and exactly to the
    port's contract computed in f64 (but where the product's rounding
    flips, at most 1% of the elements, within one ulp of proj, of
    proj + b3 and of the gate). The moments are held to 1e-5 of the f32 moments of each
    package's own bf16 gate, and to each other within Σ|Δgate|.
  * the model (2 layers, D = 128, banded graph) and a training step: JAX's
    two backends disagree with each other by about as much as bf16 and f32
    differ (a few 1e-2 in a logit). The port is held to each JAX backend
    within twice that spread, measured in the test: logits, probabilities,
    each leaf's gradient. The loss is held to the bound the logits imply
    (BCE is max(1, pos_weight)-Lipschitz per edge). The biases that feed a
    BatchNorm have an exact gradient of zero; in bf16 theirs is rounding
    noise on both sides, far above f32's, and is held to twice JAX's own
    in norm (relative to the whole gradient).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.config import ModelConfig as JaxModelConfig
from gnnome_tpu.core.graph import PAD_SEGMENT as JAX_PAD
from gnnome_tpu.core.graph import build_graph as jax_build_graph
from gnnome_tpu.core.graph import pad_features as jax_pad_features
from gnnome_tpu.core.graph import prepare_edge_features as jax_prepare
from gnnome_tpu.evaluation.metrics import bce_with_logits as jax_bce
from gnnome_tpu.models.model import init_model_params as jax_init
from gnnome_tpu.models.model import model_forward as jax_forward
from gnnome_tpu.ops.banded import take_rows as jax_take_rows
from gnnome_tpu.ops.segment import (
    _fused_gate_gather_bwd,
    _fused_sigma_reverse_unsorted,
    _gate_front_bwd,
    _rev_unsorted_bwd,
    fused_gate_front as jax_gate_front,
    fused_gate_sigma_gather as jax_gate_sigma_gather,
    gather_by_endpoint as jax_gather,
    segment_sum_csr,
)
from gnnome_tpu.train import checkpoint as jax_ckpt
from gnnome_tpu.train import loop as jax_loop
from gnnome_tpu.train.checkpoint import _flatten
from gnnome_tpu_torch.config import Config, TrainConfig
from gnnome_tpu_torch.core.graph import pad_features, prepare_edge_features
from gnnome_tpu_torch.evaluation.metrics import bce_with_logits
from gnnome_tpu_torch.models.model import model_forward
from gnnome_tpu_torch.ops.gate_epilog import GateSigmaGather
from gnnome_tpu_torch.ops.gate_front import GateFront
from gnnome_tpu_torch.ops.reverse_sum import SigmaReverseSum
from gnnome_tpu_torch.ops.segment_sum import segment_sum
from gnnome_tpu_torch.ops.take import TakeRows, take_rows
from gnnome_tpu_torch.train import checkpoint as ckpt
from gnnome_tpu_torch.train import loop
from gnnome_tpu_torch.train.checkpoint import iter_leaves, params_from_jax
from test_torch_ops import D, banded_edges, both_graphs, random_edges
from test_torch_train import BN_CANCELLED, LR, genome_root  # noqa: F401 (fixture)

TOL = dict(rtol=1e-5, atol=1e-5)
BF = jnp.bfloat16
EDGE_SUM_ATOL = 1e-5  # of max|ref|: an f32 sum over every edge, then rounded


@pytest.fixture(params=["pallas_interpret", "xla"])
def case(request):
    """(backend, JAX graph, port graph, rng): the banded graph for the
    Pallas kernels, a random graph for XLA; both padded."""
    rng = np.random.default_rng(29)
    make = banded_edges if request.param == "pallas_interpret" else random_edges
    jg, tg = both_graphs(*make(rng))
    return request.param, jg, tg, rng


def bf16(rng, *shape, scale=1.0):
    """Normal values rounded to bf16, as float32 numpy (exact in bf16)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(BF).astype(jnp.float32))


def tb(x):
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)


def jb(x):
    return jnp.asarray(np.asarray(x, np.float32)).astype(BF)


def npf(x):
    """A torch or JAX array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def ulp(x):
    """The spacing of bf16 at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def rb(x):
    """f32/f64 numpy rounded to bf16 (to nearest even), as float32."""
    return npf(jnp.asarray(np.asarray(x, np.float32)).astype(BF))


def assert_bf16_close(got, want, atol=0.0, name=""):
    got, want = npf(got), npf(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want)
    bound = ulp(np.maximum(np.abs(got), np.abs(want))) + atol
    bad = err > bound
    assert not bad.any(), (f"{name}: {int(bad.sum())} of {err.size} beyond one bf16 ulp "
                           f"(+{atol:.1e}); max err {err.max():.3e}")


def assert_sums_close(got, want, backend, bound, name="", strict="xla"):
    """f32 sums: 1e-5 against the ``strict`` backend, which rounds as the
    port does; against the other, ``bound`` (the roundings that backend's
    summands take and the port's do not, or the reverse) plus 1e-5."""
    got, want = npf(got), npf(want)
    if backend == strict:
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    else:
        bad = np.abs(got - want) > npf(bound) + 1e-5 * (1 + np.abs(want))
        assert not bad.any(), f"{name}: {int(bad.sum())} of {bad.size}"


def summand_bound(e_new, v_rows, key, n, sigma_of_rounded=False):
    """Per key node, [Σ b·|v| ‖ Σ b] over its edges, where b bounds how far
    JAX's Pallas σ summand can be from the port's: half a bf16 ulp of the
    rounded summand (≤ 2⁻⁸ of it), and, where the port takes σ of the
    bf16-rounded e_new and the Pallas kernel of the f32 one
    (``sigma_of_rounded``), σ' = σ(1 − σ) times half an ulp of e_new."""
    e = e_new.detach().to(torch.float32)
    sig = torch.sigmoid(e)
    b = 2.0 ** -8 * sig
    if sigma_of_rounded:
        b = b + sig * (1 - sig) * torch.from_numpy(ulp(e.numpy())).to(torch.float32) / 2
    stacked = torch.cat([b * v_rows.detach().to(torch.float32).abs() * (1 + 2.0 ** -8), b], dim=-1)
    valid = key < n
    out = torch.zeros((n, stacked.shape[1]))
    return out.index_add_(0, key[valid].long(), stacked[valid])


# ---------------------------------------------------------------------------
# rows 4, 5/6: the row gather and the segment sums
# ---------------------------------------------------------------------------


def test_take_rows_bf16_matches_jax(case):
    backend, jg, tg, rng = case
    table = bf16(rng, jg.n_nodes_padded, D)
    plan = jg.by_src.key_plan
    got = take_rows(tb(table), tg.src)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(npf(got), npf(jax_take_rows(jb(table), jg.src, plan,
                                                             backend)))
    got = take_rows(tb(table), tg.by_src.key)  # PAD-marked ids: zero rows
    want = jax_take_rows(jb(table), jg.by_src.key_canonical, plan, backend, masked=True)
    np.testing.assert_array_equal(npf(got), npf(want))


def test_segment_sums_bf16_match_jax(case):
    """bf16 data, f32 sums (rows 5/6), and the gather's VJP, which returns
    them rounded to bf16 (``segment.py:_gather_bwd``)."""
    backend, jg, tg, rng = case
    data = bf16(rng, jg.n_edges_padded, D)
    for ours, theirs in ((tg.by_dst, jg.by_dst), (tg.by_src, jg.by_src)):
        got = segment_sum(tb(data), ours)
        assert got.dtype == torch.float32
        want = segment_sum_csr(jb(data), theirs, jg.n_nodes_padded, backend)
        np.testing.assert_allclose(got.numpy(), npf(want), **TOL)
    values = bf16(rng, jg.n_nodes_padded, D)
    for (index, csr), (jindex, jcsr) in (((tg.src, tg.by_src), (jg.src, jg.by_src)),
                                         ((tg.dst, tg.by_dst), (jg.dst, jg.by_dst))):
        leaf = tb(values).requires_grad_(True)
        TakeRows.apply(leaf, index, csr).backward(tb(data))
        _, vjp = jax.vjp(lambda v: jax_gather(v, jindex, jcsr, jg.n_nodes_padded, backend),
                         jb(values))
        (want,) = vjp(jb(data))
        assert leaf.grad.dtype == torch.bfloat16 and want.dtype == BF
        assert_bf16_close(leaf.grad, want, atol=1e-6, name="gather grad")


# ---------------------------------------------------------------------------
# row 1 (gate front) and row 7 (its backward)
# ---------------------------------------------------------------------------


def _front_inputs(jg, rng):
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    return [bf16(rng, n, D), bf16(rng, n, D), bf16(rng, e, D),
            bf16(rng, D, D, scale=D ** -0.5), bf16(rng, D)]


def _moments(gate, n_real):
    g = npf(gate)[:n_real].astype(np.float64)
    return np.stack([g.sum(0), (g * g).sum(0)])


def test_gate_front_bf16_matches_jax(case):
    backend, jg, tg, rng = case
    b1h, b2h, e, w3, b3 = ins = _front_inputs(jg, rng)
    gate, mom = GateFront.apply(*map(tb, ins), tg.src, tg.dst, tg.n_edges, tg.by_src,
                                tg.by_dst)
    assert gate.dtype == torch.bfloat16 and mom.dtype == torch.float32
    jgate, jmom = jax_gate_front(*map(jb, ins), jg.src, jg.dst, (jg.by_src, jg.by_dst),
                                 jg.n_nodes_padded, jg.n_edges, backend)
    src, dst = np.asarray(jg.src), np.asarray(jg.dst)
    x1, x2 = b1h[src], b2h[dst]
    proj64 = e.astype(np.float64) @ w3.astype(np.float64)
    pb = rb(rb(proj64) + b3)
    # the contract, in f64: proj rounded once, + b3 in bf16, the endpoint
    # rows in f32, the gate rounded once
    want = rb((pb.astype(np.float64) + x1) + x2)
    got = npf(gate)
    flips = got != want
    assert flips.mean() <= 1e-2
    assert (np.abs(got - want) <= ulp(proj64) + ulp(pb) + ulp(want))[flips].all()
    # against JAX: one ulp of each partial sum, and of the gate
    err = np.abs(got - npf(jgate))
    assert (err <= 2.0 ** -7 * (np.abs(x1) + np.abs(x2) + np.abs(pb)) + ulp(got)).all()
    # each package's moments are those of its own bf16 gate; and they agree
    # within what the gates' differences allow
    n_real = jg.n_edges
    for m, g in ((mom, gate), (jmom, jgate)):
        np.testing.assert_allclose(npf(m) / n_real, _moments(g, n_real) / n_real, **TOL)
    dg = np.abs(npf(jgate) - got)[:n_real].astype(np.float64)
    g_abs = np.abs(got)[:n_real] + dg
    slack = np.stack([dg.sum(0), (dg * (2 * g_abs)).sum(0)])
    assert (np.abs(npf(mom) - npf(jmom)) <= slack + 1e-5 * (1 + np.abs(npf(jmom)))).all()


def test_gate_front_bf16_vjp_matches_jax(case):
    """The VJP of row 1 (row 7's d_total and d_bias3, rows 5/6's endpoint
    sums, the B3 products), given the port's own gate on both sides."""
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    ins = _front_inputs(jg, rng)
    d_gate, d_mom = bf16(rng, e, D), (rng.standard_normal((2, D)) / jg.n_edges).astype(
        np.float32)
    leaves = [tb(x).requires_grad_(True) for x in ins]
    gate, mom = GateFront.apply(*leaves, tg.src, tg.dst, tg.n_edges, tg.by_src, tg.by_dst)
    torch.autograd.backward([gate, mom], [tb(d_gate), torch.from_numpy(d_mom)])
    protos = tuple(jnp.zeros((0,), BF) for _ in range(3))
    res = (jb(npf(gate)), jb(ins[2]), jb(ins[3]), (jg.by_src, jg.by_dst), protos)
    want = _gate_front_bwd(n, jg.n_edges, backend, res, (jb(d_gate), jnp.asarray(d_mom)))
    names = ("d_b1h", "d_b2h", "d_e", "d_w3", "d_bias3")
    for name, leaf, w in zip(names, leaves, want):
        assert leaf.grad.dtype == torch.bfloat16 and w.dtype == BF, name
        assert_bf16_close(leaf.grad, w, atol=EDGE_SUM_ATOL * float(np.abs(npf(w)).max()),
                          name=name)


# ---------------------------------------------------------------------------
# row 2 (gate epilog + forward aggregation) and row 8 (its backward)
# ---------------------------------------------------------------------------


def test_gate_sigma_gather_bf16_matches_jax(case):
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    affine = np.stack([rng.uniform(0.5, 1.5, D), rng.standard_normal(D)]).astype(np.float32)
    ins = [bf16(rng, e, D), bf16(rng, e, D), bf16(rng, n, D)]
    leaves = [tb(x).requires_grad_(True) for x in ins]
    t_aff = torch.from_numpy(affine).requires_grad_(True)
    sums, e_new = GateSigmaGather.apply(*leaves, t_aff, tg.by_dst, tg.src, tg.by_src)
    assert sums.dtype == torch.float32 and e_new.dtype == torch.bfloat16
    dst_key = jnp.where(jg.edge_mask, jg.dst, JAX_PAD)
    jsums, je_new = jax_gate_sigma_gather(*map(jb, ins), jnp.asarray(affine),
                                          (dst_key, jg.src), jg.by_dst, jg.by_src, n, backend)
    assert_bf16_close(e_new, je_new, name="e_new")
    bound = summand_bound(e_new, leaves[2].detach()[tg.src], tg.by_dst.key, n,
                          sigma_of_rounded=True)
    assert_sums_close(sums, jsums, backend, bound, name="sums", strict="pallas_interpret")

    g_sums, g_enew = rng.standard_normal((n, 2 * D)).astype(np.float32), bf16(rng, e, D)
    torch.autograd.backward([sums, e_new], [torch.from_numpy(g_sums), tb(g_enew)])
    res = (jb(ins[0]), jb(npf(e_new)), jb(ins[2]), jnp.asarray(affine), (dst_key, jg.src),
           jg.by_dst.key_plan, jg.by_src)
    want = _fused_gate_gather_bwd(n, backend, res, (jnp.asarray(g_sums), jb(g_enew)))
    for name, leaf, w in zip(("d_gate_raw", "d_e_in", "d_values"), leaves, want):
        assert leaf.grad.dtype == torch.bfloat16 and w.dtype == BF, name
        assert_bf16_close(leaf.grad, w, atol=EDGE_SUM_ATOL * float(np.abs(npf(w)).max()),
                          name=name)
    w_aff = npf(want[3])
    assert t_aff.grad.dtype == torch.float32
    np.testing.assert_allclose(t_aff.grad.numpy(), w_aff, rtol=1e-5,
                               atol=1e-6 * np.abs(w_aff).max())


# ---------------------------------------------------------------------------
# row 3 (reverse aggregation) and row 9 (its backward)
# ---------------------------------------------------------------------------


def test_reverse_sum_bf16_matches_jax(case):
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    e_new, values = bf16(rng, e, D), bf16(rng, n, D)
    leaves = [tb(e_new).requires_grad_(True), tb(values).requires_grad_(True)]
    sums = SigmaReverseSum.apply(*leaves, tg.by_src, tg.dst, tg.by_dst)
    assert sums.dtype == torch.float32
    jsums = _fused_sigma_reverse_unsorted(jb(values), jb(e_new), jg.by_src.key_canonical,
                                          jg.dst, jg.by_src, jg.by_dst, n, backend)
    # the port rounds each summand to bf16, as interpreted Pallas (the TPU
    # kernel) does; JAX's xla composition sums them unrounded
    bound = summand_bound(tb(e_new), tb(values)[tg.dst], tg.by_src.key, n)
    assert_sums_close(sums, jsums, backend, bound, name="sums", strict="pallas_interpret")

    g = rng.standard_normal((n, 2 * D)).astype(np.float32)
    sums.backward(torch.from_numpy(g))
    res = (jb(values), jb(e_new), jg.by_src.key_canonical, jg.dst, jg.by_src, jg.by_dst)
    d_values, d_e_new = _rev_unsorted_bwd(n, backend, res, jnp.asarray(g))[:2]
    for name, leaf, w in (("d_e_new", leaves[0], d_e_new), ("d_values", leaves[1], d_values)):
        assert leaf.grad.dtype == torch.bfloat16 and w.dtype == BF, name
        assert_bf16_close(leaf.grad, w, atol=EDGE_SUM_ATOL * float(np.abs(npf(w)).max()),
                          name=name)


# ---------------------------------------------------------------------------
# the model and a training step
# ---------------------------------------------------------------------------

BACKENDS = ("xla", "pallas_interpret")


@pytest.fixture(scope="module")
def model_runs():
    """The 2-layer, D = 128 BatchNorm model under bf16 on the banded graph:
    logits, loss and gradients of one JAX parameter set in both JAX
    backends and in the port, and two Adam steps in each."""
    rng = np.random.default_rng(31)
    src, dst, n = banded_edges(rng)
    jg, tg = both_graphs(src, dst, n)
    e_feat = rng.standard_normal((len(src), 2)).astype(np.float32)
    pe = rng.standard_normal((n, 6)).astype(np.float32)
    y = (rng.random(len(src)) < 0.7).astype(np.float32)
    cfg = JaxModelConfig(hidden_features=D, num_gnn_layers=2, nb_pos_enc=4,
                         hidden_edge_scores=16)
    jparams = jax_init(jax.random.PRNGKey(5), cfg)
    start = _flatten(jparams)
    jin = (jax_prepare(jg, e_feat), jnp.asarray(jax_pad_features(pe, jg.n_nodes_padded)),
           jax_prepare(jg, y))
    runs = {}
    for backend in BACKENDS:
        def loss_fn(p):
            logits = jax_forward(p, jg, jin[0], jin[1], backend=backend,
                                 compute_dtype="bfloat16")
            return jax_bce(logits, jin[2], jg.edge_mask, 0.5), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
        # train_step donates its parameters: it gets a copy
        p = jax.tree_util.tree_map(jnp.array, jparams)
        state = jax_loop.set_lr(jax_loop.make_optimizer().init(p), LR)
        losses, stepped = [], []
        for _ in range(2):
            p, state, step_loss, _ = jax_loop.train_step(
                p, state, jg, *jin[:2], jin[2], jnp.float32(0.5), backend=backend,
                compute_dtype="bfloat16")
            losses.append(float(step_loss))
            # copies: the next step donates p's buffers
            stepped.append({k: np.array(v) for k, v in _flatten(p).items()})
        runs[backend] = dict(logits=npf(logits)[: jg.n_edges], loss=float(loss),
                             grads=_flatten(grads), steps=losses, params=stepped)

    pin = (prepare_edge_features(tg, e_feat),
           torch.from_numpy(pad_features(pe, tg.n_nodes_padded)), prepare_edge_features(tg, y))
    params = params_from_jax(start, device="cpu")
    leaves = dict(iter_leaves(params))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    logits = model_forward(params, tg, pin[0], pin[1], compute_dtype="bfloat16")
    assert logits.dtype == torch.float32
    loss = bce_with_logits(logits, pin[2], tg.edge_mask, torch.tensor(0.5))
    loss.backward()
    port = dict(logits=npf(logits)[: tg.n_edges], loss=float(loss.detach()),
                grads={k: leaf.grad.numpy().copy() for k, leaf in leaves.items()},
                steps=[], params=[])
    assert all(leaf.grad.dtype == torch.float32 for leaf in leaves.values())
    params = params_from_jax(start, device="cpu")
    opt = loop.make_optimizer(params, LR)
    for _ in range(2):
        port["steps"].append(float(loop.train_step(params, opt, tg, *pin[:2], pin[2],
                                                   torch.tensor(0.5),
                                                   compute_dtype="bfloat16")[0]))
        # copies: the next step updates the tensors in place
        port["params"].append({k: np.array(v) for k, v in ckpt.flatten_params(params).items()})
    runs["port"] = port
    runs["start"] = start
    return runs


def _leaf_errors(got, want, cancelled=BN_CANCELLED):
    """Per leaf ‖g − g_ref‖ / ‖g_ref‖, but the ``cancelled`` biases (fed to
    a BatchNorm: exact gradient zero), whose norms relative to the whole
    gradient's are returned apart."""
    total = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2)) for w in want.values()))
    rel = {k: float(np.linalg.norm(got[k] - w) / np.linalg.norm(w))
           for k, w in want.items() if not k.endswith(cancelled)}
    noise = {k: float(np.linalg.norm(got[k]) / total) for k in want if k.endswith(cancelled)}
    return rel, noise


def check_logits(runs):
    """The port's logits, probabilities and loss within twice JAX's two
    backends' spread of each (``runs``: ``xla``, ``pallas_interpret`` and
    ``port``, each with ``logits`` and ``loss``)."""
    jx, jp, port = runs["xla"], runs["pallas_interpret"], runs["port"]
    spread = np.abs(jx["logits"] - jp["logits"]).max()
    assert 1e-3 < spread < 0.1  # bf16's own spread: JAX's two backends
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))  # noqa: E731
    p_spread = np.abs(sig(jx["logits"]) - sig(jp["logits"])).max()
    for ref in (jx, jp):
        assert np.abs(port["logits"] - ref["logits"]).max() <= 2 * spread
        assert np.abs(sig(port["logits"]) - sig(ref["logits"])).max() <= 2 * p_spread
        # BCE is max(1, pos_weight)-Lipschitz in each logit; the loss is a mean
        assert abs(port["loss"] - ref["loss"]) <= \
            np.abs(port["logits"] - ref["logits"]).mean() + 1e-6


def check_grads(runs, cancelled=BN_CANCELLED):
    """Each leaf's gradient within twice JAX's two backends' spread; the
    ``cancelled`` leaves, noise, within twice either side's noise."""
    jx, jp, port = runs["xla"], runs["pallas_interpret"], runs["port"]
    assert set(port["grads"]) == set(jx["grads"])
    spread, spread_noise = _leaf_errors(jp["grads"], jx["grads"], cancelled)
    for ref, other in ((jx, jp), (jp, jx)):
        rel, noise = _leaf_errors(port["grads"], ref["grads"], cancelled)
        worst = max(rel, key=rel.get)
        assert rel[worst] <= 2 * max(spread.values()), (worst, rel[worst])
        _, ref_noise = _leaf_errors(ref["grads"], other["grads"], cancelled)
        for k, v in noise.items():
            assert v <= 2 * max(ref_noise[k], spread_noise[k]), (k, v)


def test_model_bf16_logits_match_jax(model_runs):
    check_logits(model_runs)


def test_model_bf16_grads_match_jax(model_runs):
    check_grads(model_runs)


def _apart(a, b, cancelled=BN_CANCELLED):
    """Elements that two Adam steps from the same start moved apart by more
    than lr: their first update (lr·g/(|g| + eps)) took opposite signs."""
    return sum(int((np.abs(a[k] - b[k]) > LR).sum()) for k in b if not k.endswith(cancelled))


def test_train_step_bf16_matches_jax(model_runs):
    """One Adam step: the loss is the forward's, the master weights stay
    f32, every element moves by at most lr, and no more elements move
    against JAX's than JAX's two backends move against each other, twice
    over (a bf16 gradient's sign is noise where |g| is at its rounding).
    The second step's loss is not compared: at the same parameters the two
    packages' bf16 losses agree to 1e-6, but the bf16 loss moves by ~1e-4
    when any element, even a bias a BatchNorm cancels, moves by lr, so it
    measures which noisy signs each side drew, not the step."""
    jx, jp, port = model_runs["xla"], model_runs["pallas_interpret"], model_runs["port"]
    np.testing.assert_allclose(port["steps"][0], port["loss"], rtol=1e-6)
    start = model_runs["start"]
    for run in (jx, jp, port):
        assert run["steps"][1] < run["steps"][0] and np.isfinite(run["steps"]).all()
        for k, p in run["params"][0].items():
            assert p.dtype == np.float32, k
            assert np.abs(p - start[k]).max() <= LR * (1 + 1e-3), k
    spread = _apart(jp["params"][0], jx["params"][0])
    assert 0 < spread
    for ref in (jx, jp):
        assert _apart(port["params"][0], ref["params"][0]) <= 2 * spread


def test_remat_modes_give_the_same_bf16_gradients(model_runs):
    from test_torch_train import _problem

    _, _, port_in = _problem(np.random.default_rng(5), 32, layers=4)
    g, e_feat, pe, y = port_in
    arrays = _flatten(jax_init(jax.random.PRNGKey(2), JaxModelConfig(
        hidden_features=32, num_gnn_layers=4, nb_pos_enc=4, hidden_edge_scores=16)))
    grads = {}
    for remat in ("none", "layer", "group"):
        params = params_from_jax(arrays, device="cpu")
        leaves = dict(iter_leaves(params))
        for leaf in leaves.values():
            leaf.requires_grad_(True)
        logits = model_forward(params, g, e_feat, pe, remat=remat, remat_group=2,
                               compute_dtype="bf16")
        bce_with_logits(logits, y, g.edge_mask, torch.tensor(0.5)).backward()
        grads[remat] = {k: leaf.grad for k, leaf in leaves.items()}
    for remat in ("layer", "group"):
        for k, ref in grads["none"].items():
            assert torch.equal(grads[remat][k], ref), (remat, k)


# ---------------------------------------------------------------------------
# train() under bf16, checkpoints across packages, the narrowed refusal
# ---------------------------------------------------------------------------


def _bf16_cfg(tmp_path, **train_kw):
    """The default Config scaled to the 60 kb genome (as
    tests/test_torch_cluster.py scales it) under bf16."""
    cfg = Config()
    for k, v in dict(hidden_features=32, num_gnn_layers=3, hidden_edge_scores=16).items():
        setattr(cfg.model, k, v)
    kw = dict(num_epochs=1, num_parts_train=16, batch_size_train=4, cluster_jitter=4,
              compute_dtype="bfloat16", checkpoint_dir=str(tmp_path / "ckpt"),
              pretrained_dir=str(tmp_path / "pre"), **train_kw)
    for k, v in kw.items():
        setattr(cfg.train, k, v)
    return cfg


def test_train_bf16_default_config_and_checkpoints(genome_root, tmp_path, monkeypatch):
    from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset

    cfg = _bf16_cfg(tmp_path)
    assert cfg.model.batch_norm and cfg.train.wide_gathers == "auto"
    steps = []
    step = loop.train_step

    def counted(*args, **kw):
        steps.append(kw["compute_dtype"])
        return step(*args, **kw)

    monkeypatch.setattr(loop, "train_step", counted)
    out = loop.train(genome_root, None, out="bf", overfit=True, cfg=cfg,
                     log_fn=lambda m: None, device="cpu")
    assert len(steps) > 1 and set(steps) == {"bfloat16"}
    assert np.isfinite(out["loss_train"]).all() and np.isfinite(out["loss_valid"]).all()
    logs = []
    cfg.train.num_epochs = 2
    again = loop.train(genome_root, None, out="bf", overfit=True, cfg=cfg,
                       log_fn=logs.append, device="cpu")
    assert any(m.startswith("Resumed from") and m.endswith("at epoch 1") for m in logs)
    assert again["loss_train"][:1] == out["loss_train"] and len(again["loss_train"]) == 2

    # the port's checkpoint holds f32 leaves; JAX resumes from it in bf16
    jcfg = JaxModelConfig(hidden_features=32, num_gnn_layers=3, hidden_edge_scores=16,
                          nb_pos_enc=cfg.model.nb_pos_enc)
    template = jax_init(jax.random.PRNGKey(0), jcfg)
    jp, jstate, epoch, meta = jax_ckpt.load_checkpoint(
        out["checkpoint"], template, jax_loop.set_lr(jax_loop.make_optimizer().init(template),
                                                     0.5))
    assert epoch == 1 and all(a.dtype == np.float32 for a in _flatten(jp).values())
    (_, s), = AssemblyGraphDataset(genome_root, nb_pos_enc=cfg.model.nb_pos_enc, device="cpu")
    g = s.graph
    jg = jax_build_graph(g.src[: g.n_edges].numpy(), g.dst[: g.n_edges].numpy(), g.n_nodes)
    jin = (jax_prepare(jg, s.e_feat[: g.n_edges].numpy()),
           jnp.asarray(jax_pad_features(s.pe.numpy(), jg.n_nodes_padded)),
           jax_prepare(jg, s.y[: g.n_edges].numpy()))
    jp, jstate, jloss, _ = jax_loop.train_step(jp, jstate, jg, *jin, jnp.float32(0.5),
                                               backend="xla", compute_dtype="bfloat16")
    assert np.isfinite(float(jloss))
    assert all(np.asarray(a).dtype == np.float32 for a in _flatten(jp).values())
    # ... and the port resumes from JAX's, also in bf16
    jax_ckpt.save_checkpoint(str(tmp_path / "j.npz"), jp, jstate, 3, scalars={"lr": LR})
    params = loop.init_model_params(torch.Generator().manual_seed(1), cfg.model, "cpu")
    opt = loop.make_optimizer(params, 0.5)
    epoch, meta = ckpt.load_checkpoint(str(tmp_path / "j.npz"), params, opt)
    assert (epoch, meta["lr"]) == (3, LR)
    for k, a in _flatten(jp).items():
        np.testing.assert_array_equal(ckpt.flatten_params(params)[k], np.asarray(a), err_msg=k)
    loss, _ = loop.train_step(params, opt, g, s.e_feat, s.pe, s.y, torch.tensor(0.5),
                              compute_dtype="bfloat16")
    assert np.isfinite(float(loss))
    assert all(leaf.dtype == torch.float32 for _, leaf in iter_leaves(params))


@pytest.mark.parametrize("what", [dict(batch_norm=False), dict(wide_gathers=True),
                                  dict(wide_gathers="src")])
def test_bf16_refuses_layernorm_and_wide(genome_root, tmp_path, monkeypatch, what):
    """The LayerNorm model and the wide gathers, once refused under bf16,
    train one bf16 epoch through ``train()`` under the scaled default
    Config (ClusterGCN pieces): every step runs in bf16 on the asked model
    and the losses are finite (their values against JAX:
    tests/test_torch_bf16_wide.py and tests/test_torch_bf16_wide_models.py).
    An unknown dtype name is still refused."""
    cfg = _bf16_cfg(tmp_path)
    if "batch_norm" in what:
        cfg.model.batch_norm = what["batch_norm"]
    else:
        cfg.train.wide_gathers = what["wide_gathers"]
    steps = []
    step = loop.train_step

    def counted(*args, **kw):
        steps.append((kw["compute_dtype"], kw["batch_norm"], kw["wide_gathers"]))
        return step(*args, **kw)

    monkeypatch.setattr(loop, "train_step", counted)
    out = loop.train(genome_root, None, out="bf", overfit=True, cfg=cfg,
                     log_fn=lambda m: None, device="cpu")
    want = ("bfloat16", what.get("batch_norm", True), what.get("wide_gathers", False))
    assert len(steps) > 1 and set(steps) == {want}
    assert np.isfinite(out["loss_train"]).all() and np.isfinite(out["loss_valid"]).all()
    with pytest.raises(ValueError, match="compute_dtype='float16'"):
        model_forward({}, None, torch.zeros(1, 2), torch.zeros(1, 2),
                      compute_dtype="float16", **what)
    assert TrainConfig().compute_dtype == "float32"


def test_bf16_entries_take_only_their_dtype():
    """A tensor reaches the entry of its own dtype or none: no entry is
    reached by a cast, and a bf16 entry takes f32 only for its f32 parts."""
    from gnnome_tpu_torch.ops.cuda_lib import check_cuda_args, entry
    from gnnome_tpu_torch.ops.gate_epilog import EPILOG_BWD, EPILOG_BWD_BF16
    from gnnome_tpu_torch.ops.take import TAKE_ROWS, TAKE_ROWS_BF16

    assert entry(torch.bfloat16, TAKE_ROWS, TAKE_ROWS_BF16) is TAKE_ROWS_BF16
    assert entry(torch.float32, TAKE_ROWS, TAKE_ROWS_BF16) is TAKE_ROWS
    with pytest.raises(ValueError, match="no kernel entry for torch.float16"):
        entry(torch.float16, TAKE_ROWS, TAKE_ROWS_BF16)
    kernel = entry(torch.bfloat16, EPILOG_BWD, EPILOG_BWD_BF16)
    data = torch.zeros(4, 8, dtype=torch.bfloat16)
    g_sums, ids = torch.zeros(2, 16), torch.zeros(4, dtype=torch.int32)
    check_cuda_args(kernel.name, [data], [ids], dtype=kernel.dtype, f32=[g_sums])
    for floats, f32 in (([data.float()], [g_sums]), ([data], [g_sums.to(torch.bfloat16)]),
                        ([data.t()], [g_sums])):
        with pytest.raises(ValueError, match="epilog_bwd_bf16: needs contiguous"):
            check_cuda_args(kernel.name, floats, [ids], dtype=kernel.dtype, f32=f32)
