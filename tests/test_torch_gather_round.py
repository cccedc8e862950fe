"""Row 2's summands under bf16: ``gate_sigma_gather_plain`` with ``src``
(the CPU form and card reference of ``csrc/gate_epilog.cu``'s gather entry)
takes σ of the f32 e_new and rounds each summand, σ·v[src] and σ, to bf16
before its f32 sum, as the TPU kernel ``fused_gate_sigma_gather_pallas``
does (``gnnome_tpu/ops/spmm_pallas.py:2951-2956``).

Three references:
  * an f64 sum, per destination node in ``np.add.at``'s order, of the
    summands the port forms in f32 (the affine, the ReLU and the residual
    as the plain version computes them, torch's σ of that f32 e_new times
    the stored value), each rounded to bf16: rtol = atol = 1e-5 (the f32
    sum of a few dozen terms against f64). The same sum of the unrounded
    summands of σ of the rounded e_new (the xla composition's) is shown to
    miss that tolerance, so dropping the rounding fails the test;
  * JAX's ``fused_gate_sigma_gather`` under ``pallas_interpret`` on a banded
    graph (its Pallas kernel runs interpreted in bf16): 1e-5, the same
    summands summed in another order;
  * JAX's ``xla`` composition on the same graph: within ``summand_bound``
    (half a bf16 ulp of each summand, and σ(1 − σ)·|v| times half an ulp
    of e_new, summed over each node's edges), plus 1e-5.
float32 inputs keep the unrounded summands.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.core.graph import PAD_SEGMENT as JAX_PAD
from gnnome_tpu.ops.segment import fused_gate_sigma_gather as jax_gate_sigma_gather
from gnnome_tpu_torch.core.graph import build_graph
from gnnome_tpu_torch.ops.gate_epilog import gate_sigma_gather, gate_sigma_gather_plain
from test_torch_bf16 import assert_sums_close, bf16, jb, npf, summand_bound, tb
from test_torch_ops import D, banded_edges, both_graphs

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, n_edges, n_nodes, d):
    affine = np.stack([rng.uniform(0.5, 1.5, d), rng.standard_normal(d)]).astype(np.float32)
    gate, e_in = bf16(rng, n_edges, d), bf16(rng, n_edges, d)
    values = bf16(rng, n_nodes, d, scale=3.0)
    return gate, e_in, values, affine


def _f64_sums(g, gate, e_in, values, affine, rounded=True):
    """Per destination node, the f64 sum of [σ·v[src] ‖ σ] over its real
    in-edges: with ``rounded``, σ of the f32 e_new and each summand rounded
    to bf16; without, σ of the bf16 e_new and the f32 summands."""
    f32, bf = torch.float32, torch.bfloat16
    e32 = torch.relu(gate.to(f32) * affine[0] + affine[1]) + e_in.to(f32)
    sig = torch.sigmoid(e32 if rounded else e32.to(bf).to(f32))
    sv = sig * values[g.src].to(f32)
    if rounded:
        sv, sig = sv.to(bf).to(f32), sig.to(bf).to(f32)
    stacked = torch.cat([sv, sig], dim=-1).double().numpy()
    key = g.by_dst.key.numpy()
    real = key < g.n_nodes_padded
    out = np.zeros((g.n_nodes_padded, stacked.shape[1]))
    np.add.at(out, key[real], stacked[real])
    return out


def _random_graph(seed):
    rng = np.random.default_rng(seed)
    n, e = 200, 3000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = src != dst
    g = build_graph(src[keep], dst[keep], n, node_pad_multiple=64, edge_pad_multiple=256,
                    device="cpu")
    return g, rng


@pytest.mark.parametrize("d", [8, 30, 128])
def test_bf16_gather_rounds_each_summand(d):
    g, rng = _random_graph(3)
    gate, e_in, values, affine = _inputs(rng, g.n_edges_padded, g.n_nodes_padded, d)
    args = (tb(gate), tb(e_in), tb(values), torch.from_numpy(affine))
    sums, e_new = gate_sigma_gather(*args, g.by_dst, g.src)  # CPU tensors: the plain version
    assert sums.dtype == torch.float32 and e_new.dtype == torch.bfloat16
    want = _f64_sums(g, *args)
    np.testing.assert_allclose(sums.numpy(), want, **TOL)
    # σ of the rounded e_new with f32 summands is another function at this tolerance
    unrounded = _f64_sums(g, *args, rounded=False)
    assert (np.abs(unrounded - want) > TOL["atol"] + TOL["rtol"] * np.abs(want)).any()


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
def test_bf16_gather_sums_match_jax(backend):
    """Strict against the Pallas kernel, within the summand bound against
    the xla composition, on the banded graph where the kernel runs."""
    rng = np.random.default_rng(31)
    jg, tg = both_graphs(*banded_edges(rng))
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    gate, e_in, values, affine = _inputs(rng, e, n, D)
    sums, e_new = gate_sigma_gather(tb(gate), tb(e_in), tb(values), torch.from_numpy(affine),
                                    tg.by_dst, tg.src)
    dst_key = jnp.where(jg.edge_mask, jg.dst, JAX_PAD)
    jsums, _ = jax_gate_sigma_gather(jb(gate), jb(e_in), jb(values), jnp.asarray(affine),
                                     (dst_key, jg.src), jg.by_dst, jg.by_src, n, backend)
    bound = summand_bound(e_new, tb(values)[tg.src], tg.by_dst.key, n, sigma_of_rounded=True)
    assert_sums_close(sums, jsums, backend, bound, name="sums", strict="pallas_interpret")
    if backend == "pallas_interpret":
        np.testing.assert_allclose(npf(sums), _f64_sums(tg, tb(gate), tb(e_in), tb(values),
                                                        torch.from_numpy(affine)), **TOL)


def test_f32_gather_keeps_its_summands():
    g, rng = _random_graph(4)
    gate, e_in, values, affine = _inputs(rng, g.n_edges_padded, g.n_nodes_padded, 64)
    args = [torch.tensor(x) for x in (gate, e_in, values, affine)]
    sums, e_new = gate_sigma_gather_plain(*args, g.by_dst, g.src)
    assert e_new.dtype == torch.float32
    e32 = torch.relu(args[0] * args[3][0] + args[3][1]) + args[1]
    assert torch.equal(e_new, e32)
    sig = torch.sigmoid(e32)
    stacked = torch.cat([sig * args[2][g.src], sig], dim=-1).double().numpy()
    key = g.by_dst.key.numpy()
    want = np.zeros((g.n_nodes_padded, stacked.shape[1]))
    np.add.at(want, key[key < g.n_nodes_padded], stacked[key < g.n_nodes_padded])
    np.testing.assert_allclose(sums.numpy(), want, **TOL)
