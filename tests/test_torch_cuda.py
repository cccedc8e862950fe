"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA card and
skips without one (the CPU tests hold the plain versions against the JAX
package instead: tests/test_torch_ops.py). This file imports no JAX, so it
also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: the kernels sum in f32 in another order than the plain
versions (cuBLAS for ``e·W3``, ``index_add_`` for the segment sums), so
sums carry a few f32 ulps of their magnitude: rtol = atol = 1e-5 on
per-edge and per-node values, and the BatchNorm sums are compared as means
(divided by the edge count). The row gather moves bits and must be exact.
"""
import numpy as np
import pytest
import torch

from gnnome_tpu_torch.core.graph import build_graph
from gnnome_tpu_torch.ops.gate_epilog import gate_sigma_gather, gate_sigma_gather_plain
from gnnome_tpu_torch.ops.gate_front import gate_front, gate_front_plain
from gnnome_tpu_torch.ops.reverse_sum import sigma_reverse_sum, sigma_reverse_sum_plain
from gnnome_tpu_torch.ops.take import TAKE_ROWS, take_rows, take_rows_plain

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _graph(seed, n=300, e=2500, device="cuda"):
    """Random (not banded) graph with trailing pad nodes and PAD edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    keep = src != dst
    g = build_graph(src[keep], dst[keep], n, node_pad_multiple=128,
                    edge_pad_multiple=512, device=device)
    assert g.n_nodes_padded > n and g.n_edges_padded > g.n_edges
    return g, rng


def _randn(rng, *shape, device, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(device)


@pytest.mark.parametrize("d", [30, 64, 256])
def test_take_rows_kernel(cuda, d):
    g, rng = _graph(1, device=cuda)
    table = _randn(rng, g.n_nodes_padded, d, device=cuda)
    for ids in (g.src, g.by_src.key):  # clamped ids, then PAD-marked ids
        before = TAKE_ROWS.launches
        out = take_rows(table, ids)
        torch.cuda.synchronize()
        assert TAKE_ROWS.launches == before + 1
        assert torch.equal(out, take_rows_plain(table, ids))
    assert (take_rows(table, g.by_src.key)[g.n_edges:] == 0).all()


@pytest.mark.parametrize("d", [30, 64, 256])
def test_gate_front_kernel(cuda, d):
    g, rng = _graph(2, device=cuda)
    n = g.n_nodes_padded
    args = (_randn(rng, n, d, device=cuda), _randn(rng, n, d, device=cuda),
            _randn(rng, g.n_edges_padded, d, device=cuda),
            _randn(rng, d, d, device=cuda, scale=d ** -0.5),
            _randn(rng, d, device=cuda), g.src, g.dst, g.n_edges)
    gate, mom = gate_front(*args)
    ref_gate, ref_mom = gate_front_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(gate, ref_gate, **TOL)
    torch.testing.assert_close(mom / g.n_edges, ref_mom / g.n_edges, **TOL)


@pytest.mark.parametrize("d", [30, 64, 256])
def test_gate_sigma_gather_kernel(cuda, d):
    g, rng = _graph(3, device=cuda)
    e_pad = g.n_edges_padded
    affine = torch.stack([
        torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32)),
        torch.from_numpy(rng.standard_normal(d).astype(np.float32))]).to(cuda)
    args = (_randn(rng, e_pad, d, device=cuda), _randn(rng, e_pad, d, device=cuda),
            _randn(rng, g.n_nodes_padded, d, device=cuda), affine, g.by_dst, g.src)
    sums, e_new = gate_sigma_gather(*args)
    ref_sums, ref_e_new = gate_sigma_gather_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(e_new, ref_e_new, **TOL)
    torch.testing.assert_close(sums, ref_sums, **TOL)


@pytest.mark.parametrize("d", [30, 64, 256])
def test_sigma_reverse_sum_kernel(cuda, d):
    g, rng = _graph(4, device=cuda)
    args = (_randn(rng, g.n_edges_padded, d, device=cuda),
            _randn(rng, g.n_nodes_padded, d, device=cuda), g.by_src, g.dst)
    sums = sigma_reverse_sum(*args)
    ref = sigma_reverse_sum_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(sums, ref, **TOL)


def test_kernels_refuse_what_they_cannot_take(cuda):
    g, rng = _graph(5, device=cuda)
    table = _randn(rng, g.n_nodes_padded, 8, device=cuda)
    with pytest.raises(ValueError):
        take_rows(table.double(), g.src)  # no f64 kernel, and no fallback
    with pytest.raises(ValueError):
        take_rows(table, g.src.cpu())  # mixed devices
