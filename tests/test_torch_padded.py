"""The port's backward walks on a padded tail and on a hub row, held
against the JAX VJPs on the CPU.

The CUDA kernels behind ``epilog_bwd``, ``rev_bwd``, ``opp_bwd`` and the
σ-aggregate backward walk fixed tiles of edges, so a graph whose padded
edges outnumber its real ones (a ClusterGCN piece padded to its bucket) and
a row with hundreds of edges (a hub) are the shapes they are built for. Here the port's autograd Functions (``GateSigmaGather`` with
and without ``src``, ``SigmaReverseSum``, ``SigmaOpposite`` and the three
``SigmaAggregate`` forms) run their plain versions on two such graphs and
are held, forward and VJP, to ``jax.vjp`` of the JAX package's ops: with
``backend="xla"`` at D = 32 and with ``backend="pallas_interpret"`` at
D = 128 (the Pallas kernels' lane width), where JAX runs
``epilog_bwd_pallas``, ``rev_bwd_pallas``, ``opp_bwd_pallas`` and every
forward's Pallas kernel in interpret mode (both graphs' band plans accept
them; the test asserts it; the σ-aggregate forms' and the pregathered gate
epilog's VJPs are JAX compositions with no Pallas kernel of their own).
Every cotangent is random on pad rows too.

The graphs:
  * ``padded``: a 120-node chain with short skips, 300 real edges padded to
    1,024 rows (724 padded, 71%), 512 node rows;
  * ``hub``: a 250-node chain plus node 125 with 200 in-edges and 200
    out-edges, 649 real edges padded to 1,024.

Tolerances: rtol = atol = 1e-5 per element (f32 sums in other orders);
``d_affine``, summed over every row, to rtol 1e-5 and atol 1e-6·max|ref|
(tests/test_torch_train.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from gnnome_tpu.core.graph import PAD_SEGMENT as JAX_PAD
from gnnome_tpu.ops.segment import (
    _fused_sigma_aggregate,
    _fused_sigma_opposite as jax_fused_sigma_opposite,
    _fused_sigma_reverse_unsorted,
    epilog_gather_supported,
    fused_gate_sigma_aggregate as jax_gate_sigma_aggregate,
    fused_gate_sigma_gather as jax_gate_sigma_gather,
    gather_by_endpoint as jax_gather,
    opposite_megafused_supported,
    reverse_unsorted_supported,
)
from gnnome_tpu_torch.ops.gate_epilog import GateSigmaGather
from gnnome_tpu_torch.ops.reverse_sum import SigmaOpposite, SigmaReverseSum
from gnnome_tpu_torch.ops.sigma_aggregate import SigmaAggregate
from test_torch_ops import both_graphs, f32, t
from test_torch_train import close_all, grads, jax_grads

TOL = dict(rtol=1e-5, atol=1e-5)
WIDTH = {"xla": 32, "pallas_interpret": 128}


def padded_edges():
    rng = np.random.default_rng(5)
    n = 120
    src, dst = list(range(n - 1)), list(range(1, n))
    while len(src) < 300:
        i = int(rng.integers(0, n - 12))
        src.append(i)
        dst.append(i + int(rng.integers(2, 12)))
    return np.array(src, np.int32), np.array(dst, np.int32), n


def hub_edges():
    rng = np.random.default_rng(6)
    n, hub = 250, 125
    others = np.array([v for v in range(n) if v != hub])
    ins = rng.choice(others, 200, replace=False)
    outs = rng.choice(others, 200, replace=False)
    src = np.concatenate([np.arange(n - 1), ins, np.full(200, hub)])
    dst = np.concatenate([np.arange(1, n), np.full(200, hub), outs])
    return src.astype(np.int32), dst.astype(np.int32), n


GRAPHS = {"padded": padded_edges, "hub": hub_edges}
FUNCTIONS = ("gate_sigma_gather", "gate_sigma_aggregate", "sigma_reverse_sum",
             "sigma_opposite", "sigma_aggregate_gather", "sigma_aggregate_by_dst",
             "sigma_aggregate_by_src")


def _graphs(kind, backend):
    jg, tg = both_graphs(*GRAPHS[kind]())
    if kind == "padded":
        assert tg.n_edges == 300 and tg.n_edges_padded == 1024
    else:
        counts = [np.bincount(x[: tg.n_edges].numpy()) for x in (tg.dst, tg.src)]
        assert counts[0][125] >= 200 and counts[1][125] >= 200
    if backend == "pallas_interpret":
        d = WIDTH[backend]
        assert epilog_gather_supported(jg, d, 4, backend)
        assert reverse_unsorted_supported(jg, d, 4, backend)
        assert opposite_megafused_supported(jg.by_src, d, 4, backend)
    return jg, tg


def _cases(fn, jg, tg, backend, rng):
    """(port function, JAX function, inputs, cotangents, indices of the
    outputs summed over every row) of one autograd Function."""
    n, e, d = jg.n_nodes_padded, jg.n_edges_padded, WIDTH[backend]
    dst_key = jnp.where(jg.edge_mask, jg.dst, JAX_PAD)
    src_key = jnp.where(jg.edge_mask, jg.src, JAX_PAD)
    affine = np.stack([rng.uniform(0.5, 1.5, d), rng.standard_normal(d)]).astype(np.float32)
    if fn == "gate_sigma_gather":
        return (lambda *x: GateSigmaGather.apply(*x, tg.by_dst, tg.src, tg.by_src),
                lambda *x: jax_gate_sigma_gather(*x, (dst_key, jg.src), jg.by_dst, jg.by_src,
                                                 n, backend),
                [f32(rng, e, d), f32(rng, e, d), f32(rng, n, d), affine],
                [f32(rng, n, 2 * d), f32(rng, e, d)], (3,))
    if fn == "gate_sigma_aggregate":
        return (lambda *x: GateSigmaGather.apply(*x, tg.by_dst, None, None),
                lambda *x: jax_gate_sigma_aggregate(*x, dst_key, jg.by_dst, n, backend),
                [f32(rng, e, d), f32(rng, e, d), f32(rng, e, d), affine],
                [f32(rng, n, 2 * d), f32(rng, e, d)], (3,))
    if fn == "sigma_reverse_sum":
        return (lambda en, v: SigmaReverseSum.apply(en, v, tg.by_src, tg.dst, tg.by_dst),
                lambda en, v: _fused_sigma_reverse_unsorted(
                    v, en, jg.by_src.key_canonical, jg.dst, jg.by_src, jg.by_dst, n, backend),
                [f32(rng, e, d), f32(rng, n, d)], [f32(rng, n, 2 * d)], ())
    if fn == "sigma_opposite":
        return (lambda v, x: SigmaOpposite.apply(v, x, tg.by_src, tg.by_dst),
                lambda v, x: jax_fused_sigma_opposite(v, x, jg.by_src, jg.by_dst, n, backend),
                [f32(rng, n, d), f32(rng, e, d)], [f32(rng, n, 2 * d)], ())
    if fn == "sigma_aggregate_gather":
        return (lambda x, v: SigmaAggregate.apply(x, v, tg.by_dst, tg.src, tg.by_src),
                lambda x, v: _fused_sigma_aggregate(
                    x, jax_gather(v, jg.src, jg.by_src, n, backend), dst_key, jg.by_dst, n,
                    backend),
                [f32(rng, e, d), f32(rng, n, d)], [f32(rng, n, 2 * d)], ())
    csr, jcsr, key = ((tg.by_dst, jg.by_dst, dst_key) if fn == "sigma_aggregate_by_dst"
                      else (tg.by_src, jg.by_src, src_key))
    return (lambda x, v: SigmaAggregate.apply(x, v, csr, None, None),
            lambda x, v: _fused_sigma_aggregate(x, v, key, jcsr, n, backend),
            [f32(rng, e, d), f32(rng, e, d)], [f32(rng, n, 2 * d)], ())


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("kind", list(GRAPHS))
def test_walks_match_jax_on_padded_tail_and_hub(kind, backend, fn):
    jg, tg = _graphs(kind, backend)
    rng = np.random.default_rng(FUNCTIONS.index(fn))
    ours, theirs, inputs, cot, edge_sums = _cases(fn, jg, tg, backend, rng)
    got_out = ours(*map(t, inputs))
    want_out = theirs(*map(jnp.asarray, inputs))
    got_out = got_out if isinstance(got_out, tuple) else (got_out,)
    want_out = want_out if isinstance(want_out, tuple) else (want_out,)
    for g, w in zip(got_out, want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    close_all(grads(ours, inputs, cot), jax_grads(theirs, inputs, cot), edge_sums)
