"""Row 3's summands under bf16: ``sigma_reverse_sum_plain`` (the CPU form
and card reference of ``csrc/reverse_sum.cu``) rounds each summand, σ·v
and σ, to bf16 before its f32 sum, as the TPU kernel
``fused_sigma_unsorted_pallas`` does (``gnnome_tpu/ops/spmm_pallas.py:2358-2360``).

The reference is an f64 sum, per source node in ``np.add.at``'s order, of
the summands the port forms in f32 (torch's σ of the stored e_new times
the stored value), rounded to bf16. The sums are held to it at
rtol = atol = 1e-5 (the f32 sum of a few dozen terms against f64); the
same sum of the unrounded summands is shown to miss that tolerance, so
dropping the rounding fails the test. float32 inputs keep the unrounded
summands.
"""
import numpy as np
import pytest
import torch

from gnnome_tpu_torch.core.graph import build_graph
from gnnome_tpu_torch.ops.reverse_sum import sigma_reverse_sum, sigma_reverse_sum_plain

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, d, dtype):
    rng = np.random.default_rng(seed)
    n, e = 200, 3000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = src != dst
    g = build_graph(src[keep], dst[keep], n, node_pad_multiple=64, edge_pad_multiple=256,
                    device="cpu")
    e_new = torch.from_numpy(rng.standard_normal((g.n_edges_padded, d)).astype(np.float32))
    values = torch.from_numpy(
        (rng.standard_normal((g.n_nodes_padded, d)) * 3).astype(np.float32))
    return g, e_new.to(dtype), values.to(dtype)


def _f64_sums(g, e_new, values, round_to=None):
    """Per source node, the f64 sum of [σ·v ‖ σ] over its real out-edges,
    each summand formed in f32 and rounded to ``round_to`` if given."""
    f32 = torch.float32
    sig = torch.sigmoid(e_new.to(f32))
    sv = sig * values[g.dst].to(f32)
    if round_to is not None:
        sv, sig = sv.to(round_to).to(f32), sig.to(round_to).to(f32)
    stacked = torch.cat([sv, sig], dim=-1).double().numpy()
    key = g.by_src.key.numpy()
    real = key < g.n_nodes_padded
    out = np.zeros((g.n_nodes_padded, stacked.shape[1]))
    np.add.at(out, key[real], stacked[real])
    return out


@pytest.mark.parametrize("d", [8, 30, 128])
def test_bf16_reverse_sum_rounds_each_summand(d):
    g, e_new, values = _case(3, d, torch.bfloat16)
    got = sigma_reverse_sum(e_new, values, g.by_src, g.dst)  # CPU tensors: the plain version
    assert got.dtype == torch.float32
    want = _f64_sums(g, e_new, values, round_to=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the unrounded summands' sum is another function at this tolerance
    unrounded = _f64_sums(g, e_new, values)
    assert (np.abs(unrounded - want) > TOL["atol"] + TOL["rtol"] * np.abs(want)).any()


def test_f32_reverse_sum_keeps_its_summands():
    g, e_new, values = _case(4, 64, torch.float32)
    got = sigma_reverse_sum_plain(e_new, values, g.by_src, g.dst)
    np.testing.assert_allclose(got.numpy(), _f64_sums(g, e_new, values), **TOL)
