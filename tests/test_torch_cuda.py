"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA card and
skips without one (the CPU tests hold the plain versions against the JAX
package instead: tests/test_torch_ops.py). This file imports no JAX, so it
also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: the kernels sum in f32 in another order than the plain
versions (the split-TF32 tensor-core product for ``e·W3`` against cuBLAS
in f32, ``index_add_`` for the segment sums), so
sums carry a few f32 ulps of their magnitude: rtol = atol = 1e-5 on
per-edge and per-node values, and the sums over every edge (the BatchNorm
moments, ``d_bias3``, ``d_affine``) are compared as means (divided by the
row count). The row gather moves bits and must be exact. The model step
compares parameter gradients per leaf as a relative norm (1e-4); a leaf
whose CPU gradient is below 1e-6 of the whole gradient's norm is f32
rounding noise (the biases that feed a BatchNorm, and here A2's and A3's,
since every node has in- and out-edges) and is held to 1e-5 of that norm,
as tests/test_torch_train.py does against JAX.
"""
import numpy as np
import pytest
import torch

from gnnome_tpu_torch.config import ModelConfig
from gnnome_tpu_torch.core.graph import build_graph
from gnnome_tpu_torch.data.pe import pagerank_pe_torch
from gnnome_tpu_torch.data.synthetic import (
    bench_edges, bench_features, bench_labels, build_bench_graph)
from gnnome_tpu_torch.decode import greedy
from gnnome_tpu_torch.decode.device_walker import (
    NO_FLOOR, WALK, PaddedAdjacency, WalkTables, walk_batch, walk_batch_plain, walk_buffers)
from gnnome_tpu_torch.evaluation.metrics import bce_with_logits
from gnnome_tpu_torch.models.model import init_model_params, model_forward
from gnnome_tpu_torch.ops.cuda_lib import KERNELS
from gnnome_tpu_torch.ops.gate_epilog import (
    epilog_bwd, epilog_bwd_plain, gate_sigma_gather, gate_sigma_gather_plain)
from gnnome_tpu_torch.ops.gate_front import (
    _gate_front_bf16, gate_front, gate_front_bwd, gate_front_bwd_plain, gate_front_plain)
from gnnome_tpu_torch.ops.norm import (
    batch_norm_plan, batch_norm_relu_residual, batch_norm_relu_residual_bwd,
    batch_norm_relu_residual_bwd_plain, batch_norm_relu_residual_fwd,
    batch_norm_relu_residual_plain, layer_norm_plan, layer_norm_relu_residual,
    masked_batch_norm, masked_layer_norm, layer_norm_relu_residual_bwd,
    layer_norm_relu_residual_bwd_plain, layer_norm_relu_residual_fwd,
    layer_norm_relu_residual_plain)
from gnnome_tpu_torch.ops.reverse_sum import (
    opp_bwd, opp_bwd_plain, rev_bwd, rev_bwd_plain, sigma_opposite, sigma_opposite_plain,
    sigma_reverse_sum, sigma_reverse_sum_plain)
from gnnome_tpu_torch.ops.segment_sum import segment_sum, segment_sum_plain
from gnnome_tpu_torch.ops.sigma_aggregate import (
    sigma_aggregate, sigma_aggregate_bwd, sigma_aggregate_bwd_plain, sigma_aggregate_plain)
from gnnome_tpu_torch.ops.take import TAKE_ROWS, take_rows, take_rows_plain
from gnnome_tpu_torch.train.checkpoint import iter_leaves

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


@pytest.mark.parametrize("d", [30, 64, 256, 512])
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


@pytest.mark.parametrize("n_rows,n_real,d", [(1037, 1037, 256), (1037, 300, 256),
                                             (1037, 300, 30)])
def test_gate_front_kernel_ragged(cuda, n_rows, n_real, d):
    """Edge rows that do not fill the last 128-row tile, and real rows well
    below the padded count: the ragged tile and the moments' row mask."""
    rng = np.random.default_rng(15)
    n = 300
    ids = [torch.from_numpy(rng.integers(0, n, n_rows).astype(np.int32)).to(cuda)
           for _ in range(2)]
    args = (_randn(rng, n, d, device=cuda), _randn(rng, n, d, device=cuda),
            _randn(rng, n_rows, d, device=cuda),
            _randn(rng, d, d, device=cuda, scale=d ** -0.5),
            _randn(rng, d, device=cuda), *ids, n_real)
    gate, mom = gate_front(*args)
    ref_gate, ref_mom = gate_front_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(gate, ref_gate, **TOL)
    torch.testing.assert_close(mom / n_real, ref_mom / n_real, **TOL)


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


@pytest.mark.parametrize("d", [30, 64, 256])
def test_segment_sum_kernel(cuda, d):
    g, rng = _graph(6, device=cuda)
    data = _randn(rng, g.n_edges_padded, d, device=cuda)
    for csr in (g.by_dst, g.by_src):
        got = segment_sum(data, csr)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, segment_sum_plain(data, csr), **TOL)
        assert (got[g.n_nodes:] == 0).all()  # pad nodes own no edge


@pytest.mark.parametrize("d", [30, 64, 256])
def test_gate_front_bwd_kernel(cuda, d):
    g, rng = _graph(7, device=cuda)
    e_pad = g.n_edges_padded
    args = (_randn(rng, e_pad, d, device=cuda), _randn(rng, e_pad, d, device=cuda),
            _randn(rng, 2, d, device=cuda), g.n_edges)
    d_total, d_bias3 = gate_front_bwd(*args)
    ref_total, ref_bias3 = gate_front_bwd_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(d_total, ref_total, **TOL)
    torch.testing.assert_close(d_bias3 / e_pad, ref_bias3 / e_pad, **TOL)


@pytest.mark.parametrize("d", [30, 64, 256])
def test_epilog_bwd_kernel(cuda, d):
    g, rng = _graph(8, device=cuda)
    e_pad, n = g.n_edges_padded, g.n_nodes_padded
    affine = torch.stack([
        torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32)),
        torch.from_numpy(rng.standard_normal(d).astype(np.float32))]).to(cuda)
    args = (_randn(rng, e_pad, d, device=cuda), _randn(rng, e_pad, d, device=cuda),
            _randn(rng, e_pad, d, device=cuda), _randn(rng, n, 2 * d, device=cuda),
            _randn(rng, n, d, device=cuda), affine, g.by_dst, g.src)
    got = epilog_bwd(*args)
    ref = epilog_bwd_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], ref[:3]):
        torch.testing.assert_close(a, b, **TOL)
    torch.testing.assert_close(got[3] / e_pad, ref[3] / e_pad, **TOL)


@pytest.mark.parametrize("d", [30, 64, 256])
def test_rev_bwd_kernel(cuda, d):
    g, rng = _graph(9, device=cuda)
    args = (_randn(rng, g.n_edges_padded, d, device=cuda),
            _randn(rng, g.n_nodes_padded, 2 * d, device=cuda),
            _randn(rng, g.n_nodes_padded, d, device=cuda), g.by_src, g.dst)
    got = rev_bwd(*args)
    ref = rev_bwd_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, **TOL)
    assert (got[0][g.n_edges:] == 0).all() and (got[1][g.n_edges:] == 0).all()


def _affine(rng, d, device):
    return torch.stack([
        torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32)),
        torch.from_numpy(rng.standard_normal(d).astype(np.float32))]).to(device)


@pytest.mark.parametrize("d", [30, 64, 256])
@pytest.mark.parametrize("form", ["gather", "pregathered_by_dst", "pregathered_by_src"])
def test_sigma_aggregate_kernel(cuda, d, form):
    g, rng = _graph(11, device=cuda)
    n, e_pad = g.n_nodes_padded, g.n_edges_padded
    csr = g.by_src if form == "pregathered_by_src" else g.by_dst
    ids = g.src if form == "gather" else None
    e = _randn(rng, e_pad, d, device=cuda)
    values = _randn(rng, n if ids is not None else e_pad, d, device=cuda)
    g_sums = _randn(rng, n, 2 * d, device=cuda)
    sums = sigma_aggregate(e, values, csr, ids)
    got = sigma_aggregate_bwd(e, g_sums, values, csr, ids)
    torch.cuda.synchronize()
    torch.testing.assert_close(sums, sigma_aggregate_plain(e, values, csr, ids), **TOL)
    for a, b in zip(got, sigma_aggregate_bwd_plain(e, g_sums, values, csr, ids)):
        torch.testing.assert_close(a, b, **TOL)
    assert (got[0][g.n_edges:] == 0).all() and (got[1][g.n_edges:] == 0).all()


@pytest.mark.parametrize("d", [30, 64, 256])
def test_gate_sigma_aggregate_kernel(cuda, d):
    g, rng = _graph(12, device=cuda)
    e_pad, n = g.n_edges_padded, g.n_nodes_padded
    affine = _affine(rng, d, cuda)
    gate, e_in, vals = (_randn(rng, e_pad, d, device=cuda) for _ in range(3))
    sums, e_new = gate_sigma_gather(gate, e_in, vals, affine, g.by_dst)
    ref_sums, ref_e_new = gate_sigma_gather_plain(gate, e_in, vals, affine, g.by_dst)
    args = (gate, e_new, _randn(rng, e_pad, d, device=cuda),
            _randn(rng, n, 2 * d, device=cuda), vals, affine, g.by_dst)
    got, ref = epilog_bwd(*args), epilog_bwd_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(e_new, ref_e_new, **TOL)  # padded edges included
    torch.testing.assert_close(sums, ref_sums, **TOL)
    for a, b in zip(got[:3], ref[:3]):
        torch.testing.assert_close(a, b, **TOL)
    torch.testing.assert_close(got[3] / e_pad, ref[3] / e_pad, **TOL)


@pytest.mark.parametrize("d", [30, 64, 256])
def test_sigma_opposite_kernel(cuda, d):
    g, rng = _graph(13, device=cuda)
    n, e_pad = g.n_nodes_padded, g.n_edges_padded
    e_new, values = _randn(rng, e_pad, d, device=cuda), _randn(rng, n, d, device=cuda)
    g_sums = _randn(rng, n, 2 * d, device=cuda)
    sums = sigma_opposite(e_new, values, g.by_src)
    got = opp_bwd(e_new, g_sums, values, g.by_src)
    torch.cuda.synchronize()
    torch.testing.assert_close(sums, sigma_opposite_plain(e_new, values, g.by_src), **TOL)
    torch.testing.assert_close(sums, sigma_reverse_sum(e_new, values, g.by_src, g.dst),
                               **TOL)
    for a, b in zip(got, opp_bwd_plain(e_new, g_sums, values, g.by_src)):
        torch.testing.assert_close(a, b, **TOL)
    assert (got[0][g.n_edges:] == 0).all() and (got[1][g.n_edges:] == 0).all()


def _padded_graph(device):
    """A ClusterGCN-piece-like graph: 15,000 real edges padded to 40,000
    rows (25,000 padded, 62% of all rows), 3,000 nodes padded to 4,096."""
    rng = np.random.default_rng(21)
    src, dst = (rng.integers(0, 3000, 15_000).astype(np.int32) for _ in range(2))
    g = build_graph(src, dst, 3000, node_pad_multiple=4096, edge_pad_multiple=40_000,
                    device=device)
    assert g.n_edges_padded - g.n_edges >= 20_000
    assert g.n_edges_padded - g.n_edges > 0.25 * g.n_edges_padded
    return g, rng


def _hub_graph(device):
    """A hub node with 6,000 in-edges and 6,000 out-edges among 10,000
    random edges on 2,000 nodes, padded to a multiple of 512 edges."""
    rng = np.random.default_rng(22)
    n, hub = 2000, 777
    src = np.concatenate([rng.integers(0, n, 6000), np.full(6000, hub),
                          rng.integers(0, n, 10_000)]).astype(np.int32)
    dst = np.concatenate([np.full(6000, hub), rng.integers(0, n, 6000),
                          rng.integers(0, n, 10_000)]).astype(np.int32)
    g = build_graph(src, dst, n, edge_pad_multiple=512, device=device)
    offsets = [c.offsets.cpu().numpy() for c in (g.by_dst, g.by_src)]
    assert all(o[hub + 1] - o[hub] >= 5000 for o in offsets)
    return g, rng


WALK_ENTRIES = ("epilog_bwd", "epilog_bwd_pregathered", "rev_bwd", "opp_bwd",
                "sigma_aggregate_bwd_gather", "sigma_aggregate_bwd",
                "sigma_aggregate_bwd_by_src")


def _walk_call(entry, g, rng, d, device):
    """(kernel call, plain call) of one entry that walks edges, on random
    inputs of graph ``g``."""
    n, e = g.n_nodes_padded, g.n_edges_padded
    e_new, g_sums = _randn(rng, e, d, device=device), _randn(rng, n, 2 * d, device=device)
    table, rows = _randn(rng, n, d, device=device), _randn(rng, e, d, device=device)
    if entry.startswith("epilog_bwd"):
        src = g.src if entry == "epilog_bwd" else None
        args = (_randn(rng, e, d, device=device), e_new, _randn(rng, e, d, device=device),
                g_sums, table if src is not None else rows, _affine(rng, d, device),
                g.by_dst, src)
        return (lambda: epilog_bwd(*args)), (lambda: epilog_bwd_plain(*args))
    if entry == "rev_bwd":
        args = (e_new, g_sums, table, g.by_src, g.dst)
        return (lambda: rev_bwd(*args)), (lambda: rev_bwd_plain(*args))
    if entry == "opp_bwd":
        args = (e_new, g_sums, table, g.by_src)
        return (lambda: opp_bwd(*args)), (lambda: opp_bwd_plain(*args))
    csr, values, ids = {"sigma_aggregate_bwd_gather": (g.by_dst, table, g.src),
                        "sigma_aggregate_bwd": (g.by_dst, rows, None),
                        "sigma_aggregate_bwd_by_src": (g.by_src, rows, None)}[entry]
    args = (e_new, g_sums, values, csr, ids)
    return (lambda: sigma_aggregate_bwd(*args)), (lambda: sigma_aggregate_bwd_plain(*args))


@pytest.mark.parametrize("d", [30, 64, 256])
@pytest.mark.parametrize("entry", WALK_ENTRIES)
@pytest.mark.parametrize("shape", ["padded", "hub"])
def test_edge_walks_on_padded_tail_and_hub(cuda, shape, entry, d):
    """The entries that walk fixed tiles of edges, on a graph whose padded
    tail outnumbers its real edges and on one with a hub row of 6,000 in-
    and out-edges: each against its plain version (d_affine as a mean), the
    launch counted once, the value cotangent (and rev_bwd's and the
    σ-aggregate's edge cotangent) zero on padded edges, and two calls alike
    bit for bit (d_affine among them)."""
    g, rng = (_padded_graph if shape == "padded" else _hub_graph)(cuda)
    fn, plain = _walk_call(entry, g, rng, d, cuda)
    before = KERNELS[entry].launches
    got = fn()
    torch.cuda.synchronize()
    assert KERNELS[entry].launches == before + 1
    ref = plain()
    per_edge = got[:3] if entry.startswith("epilog_bwd") else got
    for a, b in zip(per_edge, ref):
        torch.testing.assert_close(a, b, **TOL)
    # padding is last in canonical and in sorted order
    zero_on_pad = got[2:3] if entry.startswith("epilog_bwd") else got
    assert all((x[g.n_edges:] == 0).all() for x in zero_on_pad)
    again = fn()
    if entry.startswith("epilog_bwd"):
        rows = g.n_edges_padded
        torch.testing.assert_close(got[3] / rows, ref[3] / rows, **TOL)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# launches of one 2-layer autograd step under remat="layer" (forward twice;
# the LayerNorm's entry twice a layer forward: the edge and the node norm;
# the BatchNorm's two forward and two backward entries once a layer each:
# the node norm; the gate front on both narrow paths, its backward entry on
# the BatchNorm's alone, which reads the moments; take_rows: the score head)
BN_NODE_NORM = {"batch_norm_moments": 4, "batch_norm_relu_residual": 4,
                "batch_norm_relu_residual_bwd_sums": 2, "batch_norm_relu_residual_bwd": 2}
STEP_LAUNCHES = {
    "batchnorm": {"take_rows": 2, "gate_front": 4, "gate_sigma_gather": 4,
                  "sigma_reverse_sum": 4, "segment_sum_by_dst": 5, "segment_sum_by_src": 5,
                  "gate_front_bwd": 2, "epilog_bwd": 2, "rev_bwd": 2, **BN_NODE_NORM},
    "layernorm": {"take_rows": 2, "gate_front": 4, "sigma_aggregate_gather": 4,
                  "sigma_reverse_sum": 4, "segment_sum_by_dst": 5, "segment_sum_by_src": 5,
                  "sigma_aggregate_bwd_gather": 2, "rev_bwd": 2,
                  "layer_norm_relu_residual": 8, "layer_norm_relu_residual_bwd": 4},
    "wide": {"take_rows": 10, "gate_sigma_aggregate": 4, "sigma_aggregate_by_src": 4,
             "segment_sum_by_dst": 3, "segment_sum_by_src": 3, "epilog_bwd_pregathered": 2,
             "sigma_aggregate_bwd_by_src": 2, **BN_NODE_NORM},
    "wide_src": {"take_rows": 10, "gate_sigma_aggregate": 4, "sigma_reverse_sum": 4,
                 "segment_sum_by_dst": 5, "segment_sum_by_src": 3,
                 "epilog_bwd_pregathered": 2, "rev_bwd": 2, **BN_NODE_NORM},
    "layernorm_wide": {"take_rows": 10, "sigma_aggregate": 4, "sigma_aggregate_by_src": 4,
                       "segment_sum_by_dst": 3, "segment_sum_by_src": 3,
                       "sigma_aggregate_bwd": 2, "sigma_aggregate_bwd_by_src": 2,
                       "layer_norm_relu_residual": 8, "layer_norm_relu_residual_bwd": 4},
}
VARIANTS = {"batchnorm": (True, False), "layernorm": (False, False), "wide": (True, True),
            "wide_src": (True, "src"), "layernorm_wide": (False, True)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_step_kernels_match_plain(cuda, variant):
    """One autograd step of a 2-layer model of each variant: every gradient
    through the kernels on the card against the plain versions on the CPU,
    the launch counts, and two forwards on the card bit for bit alike."""
    batch_norm, wide = VARIANTS[variant]
    g_cpu, rng = _graph(14, device="cpu")
    g = _graph(14, device=cuda)[0]
    cfg = ModelConfig(hidden_features=64, num_gnn_layers=2, nb_pos_enc=4)
    e_feat = rng.standard_normal((g.n_edges_padded, 2)).astype(np.float32)
    pe = rng.standard_normal((g.n_nodes_padded, 6)).astype(np.float32)
    y = (rng.random(g.n_edges_padded) < 0.7).astype(np.float32)
    grads = []
    for graph, dev in ((g, cuda), (g_cpu, torch.device("cpu"))):
        params = init_model_params(torch.Generator().manual_seed(0), cfg, dev)
        leaves = dict(iter_leaves(params))
        inputs = (graph, torch.from_numpy(e_feat).to(dev), torch.from_numpy(pe).to(dev))
        kw = dict(batch_norm=batch_norm, wide_gathers=wide)
        if dev.type == "cuda":
            with torch.no_grad():
                assert torch.equal(model_forward(params, *inputs, **kw),
                                   model_forward(params, *inputs, **kw))
        for leaf in leaves.values():
            leaf.requires_grad_(True)
        for k in KERNELS.values():
            k.launches = 0
        logits = model_forward(params, *inputs, remat="layer", **kw)
        bce_with_logits(logits, torch.from_numpy(y).to(dev), graph.edge_mask,
                        torch.tensor(0.5, device=dev)).backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launches = {name: k.launches for name, k in KERNELS.items() if k.launches}
            assert launches == STEP_LAUNCHES[variant], launches
        grads.append({k: v.grad.cpu() for k, v in leaves.items()})
    got, ref = grads
    total = torch.sqrt(sum((v.double() ** 2).sum() for v in ref.values()))
    for k, r in ref.items():
        if r.norm() <= 1e-6 * total:
            assert got[k].norm() <= 1e-5 * total, k
        else:
            assert (got[k] - r).norm() <= 1e-4 * r.norm(), k


def _ln_gate_inputs(rng, n, e, d, dtype, device):
    """b1h, b2h, e, W3, b3 of a D-wide gate, in ``dtype``."""
    return [_randn(rng, *shape, device=device, scale=scale).to(dtype) for shape, scale in
            (((n, d), 1.0), ((n, d), 1.0), ((e, d), 1.0), ((d, d), d ** -0.5), ((d,), 1.0))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_gate_front_at_bench_size(cuda, dtype):
    """The LayerNorm layer's gate at [150k, 1M], D = 256, through the
    moments-free gate front (the f32 split-TF32 entry, or the bf16 TMA
    entry), against the layer's old expression on the card (two row gathers
    and ``linear(B3, e)``, cuBLAS): the forward launches only the gate
    front, the backward only the two segment sums (no ``gate_front_bwd``);
    the gate to TOL in f32, and in bf16 within one rounding of each partial
    sum (the gate front rounds the endpoint rows' sum once where the
    expression rounds twice) and of the product; the gradients to TOL (the
    sums over every edge as means) in f32, one bf16 ulp in bf16."""
    from gnnome_tpu_torch.models.common import linear
    from gnnome_tpu_torch.ops.segment import fused_gate_front, gather_by_endpoint

    g, _ = build_bench_graph(150_000, 1_000_000, seed=5, frac_long=0.1193, device=cuda)
    rng = np.random.default_rng(27)
    dt = getattr(torch, dtype)
    tail = "_bf16" if dtype == "bfloat16" else ""
    ins = _ln_gate_inputs(rng, g.n_nodes_padded, g.n_edges_padded, 256, dt, cuda)
    d_gate = _randn(rng, g.n_edges_padded, 256, device=cuda).to(dt)

    def run(fn):
        leaves = [x.clone().requires_grad_(True) for x in ins]
        gate = fn(*leaves)
        gate.backward(d_gate)
        torch.cuda.synchronize()
        return gate.detach(), [x.grad for x in leaves]

    before = {k: v.launches for k, v in KERNELS.items()}
    gate, got = run(lambda b1h, b2h, e, w3, b3: fused_gate_front(b1h, b2h, e, w3, b3, g,
                                                                 moments=False)[0])
    grew = {k: v.launches - before[k] for k, v in KERNELS.items() if v.launches != before[k]}
    assert grew == {"gate_front" + tail: 1, "segment_sum_by_src" + tail: 1,
                    "segment_sum_by_dst" + tail: 1}, grew
    ref_gate, ref = run(lambda b1h, b2h, e, w3, b3: (
        gather_by_endpoint(b1h, g.src, g.by_src) + gather_by_endpoint(b2h, g.dst, g.by_dst)
        + linear({"w": w3, "b": b3}, e)))
    rows = g.n_edges_padded
    if dtype == "float32":
        torch.testing.assert_close(gate, ref_gate, **TOL)
        for i, (a, b) in enumerate(zip(got, ref)):
            scale = rows if i >= 3 else 1
            torch.testing.assert_close(a / scale, b / scale, **TOL)
        return
    b1h, b2h, e, w3, b3 = (x.float() for x in ins)
    x1, x2 = b1h[g.src.long()], b2h[g.dst.long()]
    proj = e @ w3
    pb = proj.to(torch.bfloat16).float() + b3
    gf, rf = gate.float(), ref_gate.float()
    bound = (2.0 ** -7 * (x1.abs() + x2.abs() + pb.abs()) + _bf16_ulp(proj) + _bf16_ulp(pb)
             + _bf16_ulp(torch.maximum(gf.abs(), rf.abs())))
    assert bool(((gf - rf).abs() <= bound).all()), float((gf - rf).abs().max())
    for i, (a, b) in enumerate(zip(got, ref)):
        _assert_bf16_close(a, b, atol=1e-5 * float(b.float().abs().max()) if i == 4 else 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch_norm", [False, True])
def test_16_layer_step_gate_front_launches(cuda, batch_norm, dtype):
    """One ``"layer"``-remat training step of the 16-layer, D = 256 model:
    32 gate-front launches (forward and recompute) on both norm branches,
    16 of its backward entry on the BatchNorm's alone, two row gathers (the
    score head's), and every gate-front and gate-front-backward launch with
    the integer arguments its shape gives (``ops/gate_front.py``)."""
    from benchmark.trace import Recorder
    from gnnome_tpu_torch.ops.gate_front import gate_front_bf16_plan

    g, rng = _graph(17, n=3000, e=20000, device=cuda)
    cfg = ModelConfig()
    params = init_model_params(torch.Generator().manual_seed(0), cfg, cuda)
    for leaf in dict(iter_leaves(params)).values():
        leaf.requires_grad_(True)
    e_feat = _randn(rng, g.n_edges_padded, 2, device=cuda)
    pe = _randn(rng, g.n_nodes_padded, cfg.nb_pos_enc + 2, device=cuda)
    y = torch.from_numpy((rng.random(g.n_edges_padded) < 0.7).astype(np.float32)).to(cuda)
    rec = Recorder(profiling=False)
    with rec.launch_log():
        logits = model_forward(params, g, e_feat, pe, batch_norm=batch_norm, remat="layer",
                               compute_dtype=dtype)
        bce_with_logits(logits, y, g.edge_mask, torch.tensor(0.5, device=cuda)).backward()
        torch.cuda.synchronize()
    tail = "_bf16" if dtype == "bfloat16" else ""
    count = {}
    for name, _, _ in rec.launches:
        count[name] = count.get(name, 0) + 1
    assert count.get("gate_front" + tail) == 32
    assert count.get("gate_front_bwd" + tail, 0) == (16 if batch_norm else 0)
    assert count.get("take_rows" + tail) == 2
    assert all(n.endswith("_bf16") == bool(tail) for n in count), sorted(count)
    rows, real, d = g.n_edges_padded, g.n_edges, 256
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if tail:
        plan = gate_front_bf16_plan(d, rows, sms, True)
        front = (rows, real, d, plan.grid[0], plan.bn, plan.stages)
    else:
        front = (rows, real, d, min(sms, -(-rows // 128)), 1)
    back = (rows, real, d, min(1024, -(-rows // 64)), 1)
    for name, ints, _ in rec.launches:
        if name == "gate_front" + tail:
            assert ints == front, ints
        elif name == "gate_front_bwd" + tail:
            assert ints == back, ints


def _step_spans(cuda, batch_norm: bool):
    """Two 150k-node / 1M-edge steps of the 16-layer model (remat
    ``"layer"``) under the profiler: ``benchmark/spans.py``'s reduction and
    the device seconds of every kernel."""
    from benchmark import spans
    from gnnome_tpu_torch.train.loop import make_optimizer, train_step

    graph, _ = build_bench_graph(150_000, 1_000_000, seed=5, frac_long=0.1193, device=cuda)
    cfg = ModelConfig()
    e_feat, pe = bench_features(graph, 5, cfg.nb_pos_enc)
    y = bench_labels(graph, 5)
    params = init_model_params(torch.Generator().manual_seed(5), cfg, cuda)
    opt = make_optimizer(params, 1e-3)
    pos_weight = torch.tensor(0.5, device=cuda)
    kw = dict(batch_norm=batch_norm)
    train_step(params, opt, graph, e_feat, pe, y, pos_weight, **kw)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            train_step(params, opt, graph, e_feat, pe, y, pos_weight, **kw)
        torch.cuda.synchronize()
    events = prof.events()
    out = spans.reduce(events)
    kernel_s = sum((e.time_range.end - e.time_range.start) / 1e6 for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    print({k: round(v * 1e3 / 2, 3) if isinstance(v, float) else v for k, v in out.items()},
          f"kernels {kernel_s * 1e3 / 2:.3f} ms a step")
    assert out["steps"] == 2 and spans.unlinked_seconds(events) == 0.0
    return out, kernel_s


def test_step_spans_account_for_the_step(cuda):
    """Two 150k-node / 1M-edge BatchNorm steps (the shipped model, remat
    ``"layer"``) under the profiler: the phases that ``benchmark/spans.py``
    reads from the program's spans sum to within 2% of the steps' device
    time, and the norms' backward (autograd's device thread, linked by
    sequence number to the forward) and the recompute both read above
    zero."""
    from benchmark import spans

    out, kernel_s = _step_spans(cuda, batch_norm=True)
    phases = sum(out[k] for k in spans.KINDS)
    assert abs(phases - kernel_s) <= 0.02 * kernel_s
    assert out["norm_backward"] > 0 and out["norm_forward"] > 0
    assert out["recompute"] > 0 and out["optimizer"] > 0


def test_layernorm_step_spans_hold_the_norm_kernels(cuda):
    """The same on the LayerNorm model: the phases account for the step, and
    the norm spans hold the fused norm's kernels in all three phases and
    not the layer's recompute, which its backward's first read of a saved
    tensor runs (outside its span)."""
    from benchmark import spans

    out, kernel_s = _step_spans(cuda, batch_norm=False)
    phases = sum(out[k] for k in spans.KINDS)
    assert abs(phases - kernel_s) <= 0.02 * kernel_s
    assert out["norm_forward"] > 0 and out["norm_backward"] > 0 and out["norm_recompute"] > 0
    # the recompute runs the forward's norm kernels again, and no more
    assert out["norm_recompute"] <= 1.5 * out["norm_forward"]


# kernels each layer span has to hold (names as the device trace gives them,
# templated): the forward's and its backward's
LAYER_SPAN_KERNELS = {
    "layernorm": {"gate": ("gate_front", "segment_sum_kernel"),
                  "aggregate": ("sigma_aggregate_gather_kernel",
                                "sigma_aggregate_bwd_gather_kernel", "sigma_reverse_sum_kernel",
                                "rev_bwd_kernel", "segment_sum_kernel")},
    "batchnorm": {"gate": ("gate_front_kernel", "gate_front_bwd_kernel"),
                  "aggregate": ("gate_sigma_gather_kernel", "epilog_bwd_kernel",
                                "sigma_reverse_sum_kernel", "rev_bwd_kernel")},
}


@pytest.mark.parametrize("variant,dtype", [("layernorm", "float32"), ("layernorm", "bfloat16"),
                                           ("batchnorm", "float32")])
def test_layer_spans_hold_their_kernels(cuda, variant, dtype):
    """One step of a 2-layer model (remat ``"layer"``) under the profiler,
    each kernel put down to the program's spans as ``benchmark/spans.py``
    puts it: the ``gate`` and ``aggregate`` spans hold their kernels, in
    the forward, the recompute and the backward, and no norm kernel;
    every LayerNorm and BatchNorm kernel lies under ``norm``; no launch lies under two of
    the three; and together they hold no more than the step's forward,
    recompute and backward."""
    from benchmark import spans
    from gnnome_tpu_torch.train.loop import make_optimizer, train_step

    g, rng = _graph(16, device=cuda)
    cfg = ModelConfig(hidden_features=64, num_gnn_layers=2, nb_pos_enc=4)
    params = init_model_params(torch.Generator().manual_seed(0), cfg, cuda)
    opt = make_optimizer(params, 1e-3)
    inputs = (g, _randn(rng, g.n_edges_padded, 2, device=cuda),
              _randn(rng, g.n_nodes_padded, 6, device=cuda),
              torch.from_numpy((rng.random(g.n_edges_padded) < 0.7).astype(np.float32)).to(cuda),
              torch.tensor(0.5, device=cuda))
    kw = dict(batch_norm=variant == "batchnorm", compute_dtype=dtype)
    train_step(params, opt, *inputs, **kw)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        train_step(params, opt, *inputs, **kw)
        torch.cuda.synchronize()
    events = prof.events()
    calls = {e.id: e for e in events
             if e.device_type == torch.autograd.DeviceType.CPU and spans.CUDA_CALL.match(e.name)}
    work = [(k, s) for k, s in spans._device_work(events) if k.id in calls]
    kernel_of = {id(calls[k.id]): k.name for k, _ in work}
    held = {name: {} for name in ("gate", "aggregate", "norm")}
    training = 0.0
    for op, seconds, phase, mods in spans.attribute(events, [(calls[k.id], s) for k, s in work]):
        if phase not in ("forward", "recompute", "backward"):
            continue
        training += seconds
        # a nested norm (BatchNorm's moments) is one span here
        under = sorted({m[len(spans.PREFIX):] for m in mods} & set(held))
        assert len(under) <= 1, (kernel_of[id(op)], under)
        if "layer_norm" in kernel_of[id(op)] or "batch_norm" in kernel_of[id(op)]:
            assert under == ["norm"], (kernel_of[id(op)], phase, under)
        for name in under:
            held[name].setdefault(phase, []).append((kernel_of[id(op)], seconds))
    for name, want in LAYER_SPAN_KERNELS[variant].items():
        assert set(held[name]) == {"forward", "recompute", "backward"}, (name, set(held[name]))
        names = [k for launches in held[name].values() for k, _ in launches]
        for kernel in want:
            assert any(kernel in k for k in names), (name, kernel)
    total = sum(s for launches in held.values() for ls in launches.values() for _, s in ls)
    assert 0.0 < total <= training


def test_kernels_refuse_what_they_cannot_take(cuda):
    g, rng = _graph(5, device=cuda)
    table = _randn(rng, g.n_nodes_padded, 8, device=cuda)
    with pytest.raises(ValueError):
        take_rows(table.double(), g.src)  # no f64 kernel, and no fallback
    with pytest.raises(ValueError):
        take_rows(table, g.src.cpu())  # mixed devices
    sb = torch.ones(8, device=cuda)
    with pytest.raises(ValueError):
        layer_norm_relu_residual_fwd(table.double(), sb.double(), sb.double(), table.double())
    with pytest.raises(ValueError):
        layer_norm_relu_residual_fwd(table, sb, sb, table.bfloat16())  # one dtype for all
    with pytest.raises(ValueError):
        layer_norm_relu_residual_bwd(table, table[:, :4].contiguous(), sb, sb)
    mask = g.node_mask
    with pytest.raises(ValueError):
        batch_norm_relu_residual_fwd(table.double(), mask, sb.double(), sb.double(),
                                     table.double())
    with pytest.raises(ValueError):
        batch_norm_relu_residual_fwd(table, mask, sb, sb, table.bfloat16())  # one dtype
    with pytest.raises(ValueError):
        batch_norm_relu_residual_fwd(table, mask.to(torch.uint8), sb, sb, table)  # bool mask
    with pytest.raises(ValueError):
        batch_norm_relu_residual_fwd(table, mask[:-1], sb, sb, table)  # a mask a row
    with pytest.raises(ValueError):
        batch_norm_relu_residual_fwd(table, mask.cpu(), sb, sb, table)  # mixed devices
    _, sums = batch_norm_relu_residual_fwd(table, mask, sb, sb, table)
    with pytest.raises(ValueError):
        batch_norm_relu_residual_bwd(table, table[:, :4].contiguous(), mask, sums, sb, sb)
    with pytest.raises(ValueError):
        batch_norm_relu_residual_bwd(table, table, mask, sums[1:], sb, sb)  # [1 + 2D] sums
    with pytest.raises(ValueError):
        batch_norm_relu_residual_bwd(table, table, mask, sums.double(), sb, sb)  # f32 sums


# ---------------------------------------------------------------------------
# the bf16 entries (compute_dtype="bfloat16"): bf16 data, f32 sums
# ---------------------------------------------------------------------------
# A bf16 output is held to one bf16 ulp of the larger magnitude plus 1e-5:
# kernel and plain version round the same f32 value, which differs by a few
# f32 ulps (sum order, a fused multiply-add). f32 outputs keep TOL.


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().float().clamp_min(2.0 ** -126))) - 7)


def _assert_bf16_close(got, ref, atol=1e-5):
    assert got.dtype == ref.dtype == torch.bfloat16
    g, r = got.float(), ref.float()
    bound = _bf16_ulp(torch.maximum(g.abs(), r.abs())) + atol
    assert bool(((g - r).abs() <= bound).all()), float((g - r).abs().max())


def _bf(rng, *shape, device, scale=1.0):
    return _randn(rng, *shape, device=device, scale=scale).to(torch.bfloat16)


def _launched(name):
    """The launches of entry ``name`` in the block, and of no other entry."""
    class Count:
        def __enter__(self):
            self.before = {k: v.launches for k, v in KERNELS.items()}
            return self

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            grew = {k for k, v in KERNELS.items() if v.launches != self.before[k]}
            assert grew == {name}, grew
    return Count()


def _gate_front_bf16_case(cuda, rng, n, n_rows, n_real, d, src, dst):
    args = (_bf(rng, n, d, device=cuda), _bf(rng, n, d, device=cuda),
            _bf(rng, n_rows, d, device=cuda), _bf(rng, d, d, device=cuda, scale=d ** -0.5),
            _bf(rng, d, device=cuda), src, dst, n_real)
    with _launched("gate_front_bf16"):
        gate, mom = gate_front(*args)
    ref_gate, ref_mom = gate_front_plain(*args)
    # where the product's f32 sum order flips its rounding, proj + b3 and
    # the gate may move by an ulp each
    proj = args[2].float() @ args[3].float()
    pb = proj.to(torch.bfloat16).float() + args[4].float()
    g, r = gate.float(), ref_gate.float()
    err = (g - r).abs()
    assert bool((err <= _bf16_ulp(proj) + _bf16_ulp(pb)
                 + _bf16_ulp(torch.maximum(g.abs(), r.abs()))).all())
    assert float((err > 0).float().mean()) <= 1e-2
    # the moments of the kernel's own rounded gate
    real = g[:n_real].double()
    own = torch.stack([real.sum(0), (real * real).sum(0)]).float()
    torch.testing.assert_close(mom / n_real, own / n_real, **TOL)
    return gate, mom, args


@pytest.mark.parametrize("d", [30, 64, 256])
def test_bf16_forward_kernels(cuda, d):
    g, rng = _graph(21, device=cuda)
    n, e_pad = g.n_nodes_padded, g.n_edges_padded
    table = _bf(rng, n, d, device=cuda)
    for ids in (g.src, g.by_src.key):
        with _launched("take_rows_bf16"):
            out = take_rows(table, ids)
        assert torch.equal(out, take_rows_plain(table, ids))
    gate = _gate_front_bf16_case(cuda, rng, n, e_pad, g.n_edges, d, g.src, g.dst)[0]
    affine = torch.stack([
        torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32)),
        torch.from_numpy(rng.standard_normal(d).astype(np.float32))]).to(cuda)
    args = (gate, _bf(rng, e_pad, d, device=cuda), table, affine, g.by_dst, g.src)
    with _launched("gate_sigma_gather_bf16"):
        sums, e_new = gate_sigma_gather(*args)
    ref_sums, ref_e_new = gate_sigma_gather_plain(*args)
    _assert_bf16_close(e_new, ref_e_new)
    torch.testing.assert_close(sums, ref_sums, **TOL)
    args = (e_new, table, g.by_src, g.dst)
    with _launched("sigma_reverse_sum_bf16"):
        sums = sigma_reverse_sum(*args)
    torch.testing.assert_close(sums, sigma_reverse_sum_plain(*args), **TOL)


@pytest.mark.parametrize("n_rows,n_real,d", [(1037, 300, 256), (1037, 1037, 512),
                                             (1037, 300, 30), (1037, 300, 640),
                                             (1037, 1037, 1030), (1037, 300, 8),
                                             (1000, 1000, 64), (1037, 700, 136),
                                             (1037, 300, 384), (70, 70, 1024)])
@pytest.mark.parametrize("ids", ["random", "hub"])
def test_gate_front_bf16_kernel_ragged(cuda, n_rows, n_real, d, ids):
    """A ragged last 64-row tile and real rows below the padded count, at
    widths that take every column-block width of the TMA instance (8 at
    BN = 32, 64 at 64, 136 and 256 at 256, 384 to 640 at 128, 1024 at 64:
    a W3 slice kept resident across 16 K slices) and the element-wise
    instance (30 and 1030: d % 8 != 0; its W3 slice in K tiles above 512);
    endpoint ids at random or on a hub (half of the rows on node 0). Two
    calls give the same bits, and the gate keeps its bits under other grids
    (the moments, summed over other partial rows, within 1e-5)."""
    rng = np.random.default_rng(25)
    n = 300
    pair = [rng.integers(0, n, n_rows) for _ in range(2)]
    if ids == "hub":
        for x in pair:
            x[rng.random(n_rows) < 0.5] = 0
    pair = [torch.from_numpy(x.astype(np.int32)).to(cuda) for x in pair]
    gate, mom, args = _gate_front_bf16_case(cuda, rng, n, n_rows, n_real, d, *pair)
    again, mom_again = gate_front(*args)
    assert torch.equal(again.view(torch.int16), gate.view(torch.int16))
    assert torch.equal(mom_again, mom)
    for sms in (3, 9):
        other, mom_other = _gate_front_bf16(*args, sms)
        assert torch.equal(other.view(torch.int16), gate.view(torch.int16)), sms
        torch.testing.assert_close(mom_other / n_real, mom / n_real, **TOL)


@pytest.mark.parametrize("d", [30, 64, 256])
def test_bf16_backward_kernels(cuda, d):
    g, rng = _graph(22, device=cuda)
    n, e_pad = g.n_nodes_padded, g.n_edges_padded
    data = _bf(rng, e_pad, d, device=cuda)
    for csr, name in ((g.by_dst, "segment_sum_by_dst_bf16"),
                      (g.by_src, "segment_sum_by_src_bf16")):
        with _launched(name):
            got = segment_sum(data, csr)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, segment_sum_plain(data, csr), **TOL)
    args = (data, _bf(rng, e_pad, d, device=cuda), _randn(rng, 2, d, device=cuda), g.n_edges)
    with _launched("gate_front_bwd_bf16"):
        d_total, d_bias3 = gate_front_bwd(*args)
    ref_total, ref_bias3 = gate_front_bwd_plain(*args)
    _assert_bf16_close(d_total, ref_total)
    torch.testing.assert_close(d_bias3 / e_pad, ref_bias3 / e_pad, **TOL)
    affine = torch.stack([
        torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32)),
        torch.from_numpy(rng.standard_normal(d).astype(np.float32))]).to(cuda)
    e_new, g_sums = _bf(rng, e_pad, d, device=cuda), _randn(rng, n, 2 * d, device=cuda)
    values = _bf(rng, n, d, device=cuda)
    args = (_bf(rng, e_pad, d, device=cuda), e_new, data, g_sums, values, affine, g.by_dst,
            g.src)
    with _launched("epilog_bwd_bf16"):
        got = epilog_bwd(*args)
    ref = epilog_bwd_plain(*args)
    for a, b in zip(got[:3], ref[:3]):
        _assert_bf16_close(a, b)
    torch.testing.assert_close(got[3] / e_pad, ref[3] / e_pad, **TOL)
    assert all(torch.equal(a, b) for a, b in zip(got, epilog_bwd(*args)))
    args = (e_new, g_sums, values, g.by_src, g.dst)
    with _launched("rev_bwd_bf16"):
        got = rev_bwd(*args)
    for a, b in zip(got, rev_bwd_plain(*args)):
        _assert_bf16_close(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got, rev_bwd(*args)))


def test_bf16_model_step_runs_the_bf16_entries(cuda):
    """One bf16 autograd step of a 2-layer BatchNorm model on the card: the
    launch counts of the bf16 entries (and of no f32 entry), f32 gradients
    on the f32 leaves, and two bf16 forwards bit for bit alike."""
    g, rng = _graph(23, device=cuda)
    cfg = ModelConfig(hidden_features=64, num_gnn_layers=2, nb_pos_enc=4)
    e_feat = torch.from_numpy(rng.standard_normal((g.n_edges_padded, 2)).astype(np.float32))
    pe = torch.from_numpy(rng.standard_normal((g.n_nodes_padded, 6)).astype(np.float32))
    y = torch.from_numpy((rng.random(g.n_edges_padded) < 0.7).astype(np.float32)).to(cuda)
    params = init_model_params(torch.Generator().manual_seed(0), cfg, cuda)
    inputs = (g, e_feat.to(cuda), pe.to(cuda))
    with torch.no_grad():
        assert torch.equal(model_forward(params, *inputs, compute_dtype="bfloat16"),
                           model_forward(params, *inputs, compute_dtype="bfloat16"))
    leaves = dict(iter_leaves(params))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    for k in KERNELS.values():
        k.launches = 0
    logits = model_forward(params, *inputs, remat="layer", compute_dtype="bfloat16")
    bce_with_logits(logits, y, g.edge_mask, torch.tensor(0.5, device=cuda)).backward()
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in KERNELS.items() if k.launches}
    layers = cfg.num_gnn_layers
    assert launches == {"take_rows_bf16": 2, "gate_front_bf16": 2 * layers,
                        "gate_sigma_gather_bf16": 2 * layers,
                        "sigma_reverse_sum_bf16": 2 * layers, "gate_front_bwd_bf16": layers,
                        "epilog_bwd_bf16": layers, "rev_bwd_bf16": layers,
                        "segment_sum_by_dst_bf16": 2 * layers + 1,
                        "segment_sum_by_src_bf16": 2 * layers + 1,
                        "batch_norm_moments_bf16": 2 * layers,
                        "batch_norm_relu_residual_bf16": 2 * layers,
                        "batch_norm_relu_residual_bwd_sums_bf16": layers,
                        "batch_norm_relu_residual_bwd_bf16": layers}, launches
    assert logits.dtype == torch.float32
    assert all(v.grad.dtype == torch.float32 and bool(torch.isfinite(v.grad).all())
               for v in leaves.values())


# ---------------------------------------------------------------------------
# the bf16 entries of rows 10 and 11 (the LayerNorm and wide-gather paths)
# ---------------------------------------------------------------------------

BF16_WIDE_SHAPES = {"random": lambda dev: _graph(24, device=dev), "padded": _padded_graph,
                    "hub": _hub_graph}


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("shape", list(BF16_WIDE_SHAPES))
def test_bf16_wide_kernels(cuda, shape, d):
    """Row 10's three forms and their backward walks, row 11 and its VJP,
    in bf16 against their plain versions on a random graph, on one whose
    padded tail outnumbers its real edges and on one with a hub row: f32
    sums and d_affine (as a mean) to TOL, bf16 outputs to one ulp + 1e-5,
    each launch of only its own entry, the walks alike bit for bit in two
    calls and zero on padded edges."""
    g, rng = BF16_WIDE_SHAPES[shape](cuda)
    n, e_pad = g.n_nodes_padded, g.n_edges_padded
    e, table, rows = (_bf(rng, e_pad, d, device=cuda), _bf(rng, n, d, device=cuda),
                      _bf(rng, e_pad, d, device=cuda))
    g_sums = _randn(rng, n, 2 * d, device=cuda)
    for form, csr, values, ids in (("gather", g.by_dst, table, g.src),
                                   ("", g.by_dst, rows, None), ("by_src", g.by_src, rows, None)):
        tail = f"_{form}_bf16" if form else "_bf16"
        with _launched("sigma_aggregate" + tail):
            sums = sigma_aggregate(e, values, csr, ids)
        torch.testing.assert_close(sums, sigma_aggregate_plain(e, values, csr, ids), **TOL)
        name = ("sigma_aggregate_bwd_" + form if form else "sigma_aggregate_bwd") + "_bf16"
        with _launched(name):
            got = sigma_aggregate_bwd(e, g_sums, values, csr, ids)
        for a, b in zip(got, sigma_aggregate_bwd_plain(e, g_sums, values, csr, ids)):
            _assert_bf16_close(a, b)
        assert all(torch.equal(a, b) for a, b in zip(got, sigma_aggregate_bwd(e, g_sums, values,
                                                                              csr, ids)))
        assert (got[0][g.n_edges:] == 0).all() and (got[1][g.n_edges:] == 0).all()
    affine = _affine(rng, d, cuda)
    gate, e_in = _bf(rng, e_pad, d, device=cuda), _bf(rng, e_pad, d, device=cuda)
    with _launched("gate_sigma_aggregate_bf16"):
        sums, e_new = gate_sigma_gather(gate, e_in, rows, affine, g.by_dst)
    ref_sums, ref_e_new = gate_sigma_gather_plain(gate, e_in, rows, affine, g.by_dst)
    _assert_bf16_close(e_new, ref_e_new)  # padded edges included
    torch.testing.assert_close(sums, ref_sums, **TOL)
    # the VJP takes e_in: it recomputes the f32 e_new
    args = (gate, e_in, _bf(rng, e_pad, d, device=cuda), g_sums, rows, affine, g.by_dst)
    with _launched("epilog_bwd_pregathered_bf16"):
        got = epilog_bwd(*args)
    ref = epilog_bwd_plain(*args)
    for a, b in zip(got[:3], ref[:3]):
        _assert_bf16_close(a, b)
    torch.testing.assert_close(got[3] / e_pad, ref[3] / e_pad, **TOL)
    assert all(torch.equal(a, b) for a, b in zip(got, epilog_bwd(*args)))
    assert (got[2][g.n_edges:] == 0).all()


def _bf16_leaf_errors(got, ref, ref_f32):
    """Per leaf, the card's bf16 gradient against the CPU's bf16 one, and
    the CPU's bf16 against its f32 (bf16's own distance), as relative
    norms; leaves whose f32 gradient is below 1e-6 of the whole's are
    BatchNorm-cancelled noise and left out."""
    total = torch.sqrt(sum((v.double() ** 2).sum() for v in ref_f32.values()))
    out = {}
    for k, r in ref_f32.items():
        if r.norm() > 1e-6 * total:
            out[k] = (float((got[k] - ref[k]).norm() / ref[k].norm()),
                      float((ref[k] - r).norm() / r.norm()))
    return out


def _bf16_step_grads(cfg, g_by_device, rng, kw):
    """Gradients of one ``remat="layer"`` autograd step of the model ``cfg``
    on each (graph, device) of ``g_by_device``: the card in bf16, the CPU in
    bf16 and f32; and the card's launch counts."""
    g0 = next(iter(g_by_device.values()))
    e_feat = rng.standard_normal((g0.n_edges_padded, 2)).astype(np.float32)
    pe = rng.standard_normal((g0.n_nodes_padded, cfg.nb_pos_enc + 2)).astype(np.float32)
    y = (rng.random(g0.n_edges_padded) < 0.7).astype(np.float32)
    out, launches = {}, None
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "bfloat16"), ("cpu", "float32")):
        graph = g_by_device[dev]
        params = init_model_params(torch.Generator().manual_seed(0), cfg, dev)
        leaves = dict(iter_leaves(params))
        for leaf in leaves.values():
            leaf.requires_grad_(True)
        for k in KERNELS.values():
            k.launches = 0
        logits = model_forward(params, graph, torch.from_numpy(e_feat).to(dev),
                               torch.from_numpy(pe).to(dev), remat="layer",
                               compute_dtype=dtype, **kw)
        bce_with_logits(logits, torch.from_numpy(y).to(dev), graph.edge_mask,
                        torch.tensor(0.5, device=dev)).backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {name: k.launches for name, k in KERNELS.items() if k.launches}
            assert bool(torch.isfinite(logits).all())
        out[(dev, dtype)] = {k: v.grad.cpu() for k, v in leaves.items()}
    return out, launches


@pytest.mark.parametrize("variant", ["layernorm", "wide", "wide_src", "layernorm_wide"])
def test_bf16_model_step_kernels_match_plain(cuda, variant):
    """One bf16 autograd step of a 2-layer model of each LayerNorm and wide
    variant on the card: the launches of the bf16 entries only (the f32
    counts of STEP_LAUNCHES, renamed), and each leaf's gradient within twice
    bf16's own distance (the CPU's bf16 against its f32) of the CPU's bf16
    gradient (the plain versions, which round where the kernels round)."""
    batch_norm, wide = VARIANTS[variant]
    g_cpu, rng = _graph(14, device="cpu")
    cfg = ModelConfig(hidden_features=64, num_gnn_layers=2, nb_pos_enc=4)
    grads, launches = _bf16_step_grads(cfg, {"cuda": _graph(14, device=cuda)[0], "cpu": g_cpu},
                                       rng, dict(batch_norm=batch_norm, wide_gathers=wide))
    assert launches == {f"{k}_bf16": v for k, v in STEP_LAUNCHES[variant].items()}, launches
    errs = _bf16_leaf_errors(grads[("cuda", "bfloat16")], grads[("cpu", "bfloat16")],
                             grads[("cpu", "float32")])
    for k, (card, own) in errs.items():
        assert card <= 2 * own + 1e-3, (k, card, own)


def test_bf16_layer_step_at_640(cuda):
    """bf16 above D = 512 (the gate front's W3 slice in K tiles, and
    ``epilog_bwd_bf16``'s instance for rows of 80 chunks, which spills): one
    ``"layer"`` step of a 2-layer, D = 640 BatchNorm model on the card,
    with the bf16 entries' launches and gradients as in
    test_bf16_model_step_kernels_match_plain."""
    g_cpu, rng = _graph(15, device="cpu")
    cfg = ModelConfig(hidden_features=640, num_gnn_layers=2, nb_pos_enc=4)
    grads, launches = _bf16_step_grads(cfg, {"cuda": _graph(15, device=cuda)[0], "cpu": g_cpu},
                                       rng, {})
    assert launches == {f"{k}_bf16": v for k, v in STEP_LAUNCHES["batchnorm"].items()}, launches
    errs = _bf16_leaf_errors(grads[("cuda", "bfloat16")], grads[("cpu", "bfloat16")],
                             grads[("cpu", "float32")])
    for k, (card, own) in errs.items():
        assert card <= 2 * own + 1e-3, (k, card, own)


@pytest.mark.parametrize("variant", ["batchnorm", "wide"])
def test_bf16_weight_grads_take_an_f32_result(cuda, variant, monkeypatch):
    """Every weight-gradient product of one bf16 step of a 2-layer, D = 256
    model on the 150k-node / 1M-edge bench graph (the gate front's d_W3, the
    wide path's B3 product and the dense layers' d_w, reduction lengths 1M
    and 150k) is the f32-result product rounded once
    (``torch.mm(..., out_dtype=torch.float32)``), bit for bit; against the
    f64 product rounded once, it has at most 1% of its elements more than
    one bf16 ulp off, and no more than a bf16-output product of the same
    operands (which reduces in bf16 where PyTorch lets cuBLAS)."""
    from gnnome_tpu_torch.data.synthetic import bench_features, bench_labels, build_bench_graph
    from gnnome_tpu_torch.ops import dense, gate_front as gate_front_mod

    graph, _ = build_bench_graph(150_000, 1_000_000, seed=0, device=cuda)
    orig, seen = dense.weight_grad, []

    def weight_grad(x, g):
        out = orig(x, g)
        seen.append((x.detach(), g.detach(), out))
        return out

    monkeypatch.setattr(dense, "weight_grad", weight_grad)
    monkeypatch.setattr(gate_front_mod, "weight_grad", weight_grad)
    cfg = ModelConfig(num_gnn_layers=2)
    params = init_model_params(torch.Generator().manual_seed(0), cfg, cuda)
    for leaf in dict(iter_leaves(params)).values():
        leaf.requires_grad_(True)
    e_feat, pe = bench_features(graph, 0, cfg.nb_pos_enc)
    logits = model_forward(params, graph, e_feat, pe, remat="layer", compute_dtype="bfloat16",
                           wide_gathers=variant == "wide")
    bce_with_logits(logits, bench_labels(graph, 0), graph.edge_mask,
                    torch.tensor(0.5, device=cuda)).backward()
    torch.cuda.synchronize()
    assert max(x.shape[0] for x, _, _ in seen) >= 999_995
    for x, g, out in seen:
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, torch.mm(x.t(), g, out_dtype=torch.float32).to(torch.bfloat16))
        ref = (x.double().t() @ g.double()).to(torch.bfloat16).double()
        ulp = _bf16_ulp(ref)  # a power of two: exact in f32
        over = int(((out.double() - ref).abs() > ulp).sum())
        over_bf16 = int(((x.t().mm(g).double() - ref).abs() > ulp).sum())
        print(f"K={x.shape[0]} [{x.shape[1]}, {g.shape[1]}]: {over} of {ref.numel()} beyond one "
              f"ulp (bf16-output product: {over_bf16})")
        assert over <= 0.01 * ref.numel() and over <= over_bf16, (x.shape, over, over_bf16)


# ---------------------------------------------------------------------------
# decode: the walk kernel (csrc/walk.cu) and the device engine
# ---------------------------------------------------------------------------
# The builders below also serve the CPU tests against the JAX package
# (tests/test_torch_decode_device.py, tests/test_torch_decode_leftovers.py):
# this file imports no JAX.


def decode_problem(seed: int, n: int = 1500):
    """A bench-like graph (two strand chains, short skips) with random
    scores, lengths and overlap features: the decode arguments."""
    src, dst = bench_edges(n, 6 * n, seed)
    pairs = dict.fromkeys(zip(src.tolist(), dst.tolist()))  # distinct, in order
    src = np.array([u for u, _ in pairs], dtype=np.int64)
    dst = np.array([v for _, v in pairs], dtype=np.int64)
    edges = {(u, v): i for i, (u, v) in enumerate(pairs)}
    succs = {i: [] for i in range(n)}
    preds = {i: [] for i in range(n)}
    for u, v in pairs:
        succs[u].append(v)
        preds[v].append(u)
    rng = np.random.default_rng(seed)
    read_length = rng.integers(5_000, 20_000, n)
    return dict(src=src, dst=dst, scores=rng.standard_normal(len(src)) * 2.0,
                succs=succs, preds=preds, edges=edges,
                prefix_length=rng.integers(100, 4_000, len(src)), read_length=read_length,
                overlap_length=rng.integers(1_000, 15_000, len(src)),
                overlap_similarity=rng.uniform(0.9, 1.0, len(src)))


def hand_graph():
    """Odd node count, a 40-successor and a 40-predecessor hub, tied
    scores, a single-successor cycle; the decode arguments with f32
    scores."""
    rng = np.random.default_rng(17)
    n = 101
    pairs = [(0, v) for v in range(1, 41)]  # hubs: 40 successors, 40 predecessors
    pairs += [(v, 2) for v in range(50, 90)]
    pairs += [(v, v + 2) for v in range(41, 95)]  # a chain
    pairs += [(94, 96), (96, 94)]  # 94 <-> 96 below: single successors both ways
    pairs += [(int(u), int(v)) for u, v in rng.integers(0, 94, (150, 2)) if u != v]
    edges, src, dst = {}, [], []
    for u, v in pairs:
        cycle = (u, v) in ((94, 96), (96, 94))
        if (u, v) not in edges and (cycle or u not in (94, 96)):
            edges[(u, v)] = len(src)
            src.append(u)
            dst.append(v)
    succs = {i: [] for i in range(n)}
    preds = {i: [] for i in range(n)}
    for u, v in zip(src, dst):
        succs[u].append(v)
        preds[v].append(u)
    assert succs[94] == [96] and succs[96] == [94]
    assert len(succs[0]) > 32 and len(preds[2]) > 32
    src, dst = np.array(src), np.array(dst)
    scores = (rng.integers(0, 4, len(src)) * 0.5 - 0.5).astype(np.float32)
    return dict(src=src, dst=dst, scores=scores, succs=succs, preds=preds, edges=edges,
                prefix_length=rng.integers(1, 1000, len(src)),
                read_length=rng.integers(1000, 2000, n))


def tiny_tables():
    """Eight nodes (odd ones are the strand mates): 0 -> {2, 4, 6} with 4
    and 6 tied, 2 -> 0 its single neighbor, 4 -> {0, 6} tied, 6 -> {4, 0}."""
    nbr = torch.tensor([[2, 4, 6], [-1] * 3, [0, -1, -1], [-1] * 3, [0, 6, -1], [-1] * 3,
                        [4, 0, -1], [-1] * 3], dtype=torch.int32)
    score = torch.tensor([[0.5, 2.0, 2.0], [-torch.inf] * 3, [1.0, -torch.inf, -torch.inf],
                          [-torch.inf] * 3, [3.0, 3.0, -torch.inf], [-torch.inf] * 3,
                          [1.0, 1.0, -torch.inf], [-torch.inf] * 3])
    prefix = torch.tensor([[10, 20, 30], [0] * 3, [40, 0, 0], [0] * 3, [50, 60, 0], [0] * 3,
                           [70, 80, 0], [0] * 3], dtype=torch.int32)
    deg = torch.tensor([3, 0, 1, 0, 2, 0, 2, 0], dtype=torch.int32)
    return WalkTables(nbr, score, prefix, deg)


def _leg_cases(g, device):
    """(tables, starts, visited_global, frozen_extra, min_score, max_steps)
    of a forward leg from every node (against a random global visited set)
    and of a backward leg frozen on marks drawn at random, each without a
    floor and with one."""
    n = len(g["read_length"])
    n_pad, max_steps = n + (n & 1), n + 2
    rng = np.random.default_rng(n)
    vg = torch.from_numpy((rng.random(n_pad) < 0.1).astype(np.uint8)).to(device)
    frozen = torch.from_numpy((rng.random((n, n_pad)) < 0.05).astype(np.uint8)).to(device)
    starts = torch.arange(n, dtype=torch.int32, device=device)
    for reverse, extra in ((False, None), (True, frozen)):
        tables = PaddedAdjacency(g["preds"] if reverse else g["succs"], g["edges"],
                                 g["scores"].astype(np.float64), g["prefix_length"], n_pad,
                                 reverse=reverse).tensors(device)
        for floor in (NO_FLOOR, 0.25):
            yield tables, starts, vg, extra, floor, max_steps


@pytest.mark.parametrize("which", ["hand", "bench"])
def test_walk_kernel_matches_plain(cuda, which):
    """Walks, lengths, base counts and visited rows equal bit for bit, on
    the hand-built graph (K = 48 > 32, ties, a single-successor cycle to
    the step cap) and a bench-like one; each call is one launch, and one
    set of buffers serves every call (the kernel clears it)."""
    g = hand_graph() if which == "hand" else decode_problem(9, n=4000)
    out = None
    for tables, starts, vg, extra, floor, max_steps in _leg_cases(g, cuda):
        if out is None:
            out = walk_buffers(starts.shape[0], vg.shape[0], max_steps, cuda)
        before = WALK.launches
        got = walk_batch(tables, starts, vg, extra, floor, max_steps, out=out)
        torch.cuda.synchronize()
        assert WALK.launches == before + 1 and got is out
        ref = walk_batch_plain(tables, starts, vg, extra, floor, max_steps)
        for name, a, b in zip(got._fields, got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert tables.nbr.shape[1] > 32 or which == "bench"


def test_walk_kernel_first_max_and_single_hops(cuda):
    tables = WalkTables(*(t.to(cuda) for t in tiny_tables()))
    starts = torch.tensor([0, 2], dtype=torch.int32, device=cuda)
    vg = torch.zeros(8, dtype=torch.uint8, device=cuda)
    for floor in (NO_FLOOR, 2.5, 1.0):
        got = walk_batch(tables, starts, vg, None, floor, 6)
        ref = walk_batch_plain(tables, starts, vg, None, floor, 6)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    got = walk_batch(tables, starts, vg, None, NO_FLOOR, 6)
    assert got.walks.tolist() == [[0, 4, 6, -1, -1, -1], [2, 0, 4, 6, -1, -1]]
    assert got.bp.tolist() == [80, 120]


def test_walk_kernel_refuses_what_it_cannot_take(cuda):
    tables = WalkTables(*(t.to(cuda) for t in tiny_tables()))
    starts = torch.tensor([0, 2], dtype=torch.int32, device=cuda)
    vg = torch.zeros(8, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        walk_batch(tables, starts.long(), vg, None, NO_FLOOR, 6)
    with pytest.raises(ValueError):
        walk_batch(tables, torch.tensor([0, 8], dtype=torch.int32, device=cuda), vg, None,
                   NO_FLOOR, 6)
    with pytest.raises(ValueError):
        walk_batch(tables._replace(score=tables.score.t().contiguous().t()), starts, vg, None,
                   NO_FLOOR, 6)
    with pytest.raises(ValueError):
        walk_batch(tables, starts.cpu(), vg, None, NO_FLOOR, 6)


@pytest.mark.parametrize("min_prob", [0.0, 0.4])
def test_device_engine_equals_batched_on_the_card(cuda, min_prob):
    p = decode_problem(11, n=6000)
    args = (p["src"], p["dst"], p["scores"].astype(np.float32), p["succs"], p["preds"],
            p["edges"], p["prefix_length"], p["read_length"])
    kwargs = dict(nb_paths=20, len_threshold=5, min_prob=min_prob, seed=5)
    before = WALK.launches
    got = greedy.get_contigs(*args, engine="device", **kwargs)
    # two legs an iteration; the last iteration ends the loop (its best
    # walk too short) or finds no seed edge left
    assert got and WALK.launches - before in (2 * len(got), 2 * len(got) + 2)
    assert got == greedy.get_contigs(*args, engine="batched", **kwargs)


def test_pagerank_pe_torch_on_the_card(cuda):
    g, _ = _graph(8, device=cuda)
    args = (g.src, g.dst, g.edge_mask, g.n_nodes_padded, 16, g.n_nodes)
    got = pagerank_pe_torch(*args)
    assert torch.equal(got, pagerank_pe_torch(*args))  # no float atomics
    ref = pagerank_pe_torch(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", [64, 256])
def test_gate_sigma_gather_bf16_kernel_rounds_its_summands(cuda, d):
    """The bf16 gather entry against its plain version (σ of the f32 e_new,
    each summand rounded to bf16), which the sum of the unrounded summands
    misses."""
    g, rng = _graph(23, device=cuda)
    affine = torch.stack([
        torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32)),
        torch.from_numpy(rng.standard_normal(d).astype(np.float32))]).to(cuda)
    args = (_bf(rng, g.n_edges_padded, d, device=cuda), _bf(rng, g.n_edges_padded, d, device=cuda),
            _bf(rng, g.n_nodes_padded, d, device=cuda, scale=3.0), affine, g.by_dst, g.src)
    with _launched("gate_sigma_gather_bf16"):
        sums, e_new = gate_sigma_gather(*args)
    ref_sums, ref_e_new = gate_sigma_gather_plain(*args)
    _assert_bf16_close(e_new, ref_e_new)
    torch.testing.assert_close(sums, ref_sums, **TOL)
    f32 = torch.float32
    sig = torch.sigmoid(e_new.float())
    unrounded = torch.zeros_like(sums).index_add_(
        0, g.dst[: g.n_edges].long(),
        torch.cat([sig * args[2].float()[g.src], sig], dim=-1)[: g.n_edges].to(f32))
    assert not torch.allclose(sums, unrounded, **TOL)


# ---------------------------------------------------------------------------
# value tables whose row count is not the segment count (the sharded
# layer's combined [N_local + P·H] tables, parallel/sharded.py)
# ---------------------------------------------------------------------------


def _keyed_csr(keys, n_rows, device):
    """The CSR over ``n_rows`` rows keyed by ``keys`` (canonical order,
    ``PAD_SEGMENT`` or any id past the rows on padded slots)."""
    from gnnome_tpu_torch.core.graph import CSR, PAD_SEGMENT

    keys = np.where(keys < n_rows, keys, PAD_SEGMENT).astype(np.int64)
    order = np.argsort(keys, kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    srt = keys[order]
    offsets = np.searchsorted(srt, np.arange(n_rows + 1))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(device)

    return CSR(key=t(keys), order=t(order), segment_ids=t(srt), offsets=t(offsets),
               inv_order=t(inv))


def value_table_case(seed, n_seg, n_val, device, e=700, e_pad=1024):
    """``e`` edges (``e_pad`` rows) summed into ``n_seg`` segments, each
    reading a row of an ``n_val``-row value table: ``by_key`` the identity
    layout (canonical order sorted by key), ``by_rkey`` a layout keyed
    elsewhere (the reverse aggregation's), ``ids`` the value rows (padding
    clamped to 0) and ``by_ids`` the CSR over the ``n_val`` rows keyed by
    them, whose segment sum is the value gradient."""
    from gnnome_tpu_torch.core.graph import CSR, PAD_SEGMENT

    rng = np.random.default_rng(seed)
    pad = np.full(e_pad - e, PAD_SEGMENT)
    key = np.concatenate([np.sort(rng.integers(0, n_seg, e)), pad])
    ids = rng.integers(0, n_val, e)
    k = torch.from_numpy(key.astype(np.int32)).to(device)
    by_key = CSR(key=k, order=None, segment_ids=k,
                 offsets=torch.from_numpy(np.searchsorted(key, np.arange(n_seg + 1))
                                          .astype(np.int32)).to(device))
    return dict(
        rng=rng, by_key=by_key,
        by_rkey=_keyed_csr(np.concatenate([rng.integers(0, n_seg, e), pad]), n_seg, device),
        ids=torch.from_numpy(np.concatenate([ids, np.zeros(e_pad - e, np.int64)])
                             .astype(np.int32)).to(device),
        by_ids=_keyed_csr(np.concatenate([ids, pad]), n_val, device))


VALUE_ROWS = [40, 160]  # fewer rows than the 96 segments, and more


@pytest.mark.parametrize("n_val", VALUE_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_value_table_rows_apart_from_segments(cuda, n_val, dtype):
    """Rows 2, 3 and 10 with their gathers (gate_sigma_gather,
    sigma_reverse_sum, sigma_aggregate's gather form) and their backwards
    (epilog_bwd, rev_bwd, sigma_aggregate_bwd_gather) on a value table of
    40 or 160 rows keyed into 96 segments: each kernel against its plain
    version, the output rows those of the segments."""
    d, n_seg = 64, 96
    c = value_table_case(31, n_seg, n_val, cuda)
    rng = c["rng"]
    e_pad = c["ids"].shape[0]
    tail = "" if dtype == torch.float32 else "_bf16"

    def data(*shape):
        return _randn(rng, *shape, device=cuda).to(dtype)

    def close(got, ref):
        if got.dtype == torch.bfloat16:
            _assert_bf16_close(got, ref)
        else:
            torch.testing.assert_close(got, ref, **TOL)

    values, affine = data(n_val, d), _affine(rng, d, cuda)
    gate, e_in, g_enew = data(e_pad, d), data(e_pad, d), data(e_pad, d)
    g_sums = _randn(rng, n_seg, 2 * d, device=cuda)
    args = (gate, e_in, values, affine, c["by_key"], c["ids"])
    with _launched("gate_sigma_gather" + tail):
        sums, e_new = gate_sigma_gather(*args)
    ref_sums, ref_e_new = gate_sigma_gather_plain(*args)
    assert sums.shape == (n_seg, 2 * d)
    torch.testing.assert_close(sums, ref_sums, **TOL)
    close(e_new, ref_e_new)
    args = (gate, e_new, g_enew, g_sums, values, affine, c["by_key"], c["ids"])
    with _launched("epilog_bwd" + tail):
        got = epilog_bwd(*args)
    ref = epilog_bwd_plain(*args)
    for a, b in zip(got[:3], ref[:3]):
        close(a, b)
    torch.testing.assert_close(got[3] / e_pad, ref[3] / e_pad, **TOL)

    args = (e_new, values, c["by_rkey"], c["ids"])
    with _launched("sigma_reverse_sum" + tail):
        sums = sigma_reverse_sum(*args)
    assert sums.shape == (n_seg, 2 * d)
    torch.testing.assert_close(sums, sigma_reverse_sum_plain(*args), **TOL)
    args = (e_new, g_sums, values, c["by_rkey"], c["ids"])
    with _launched("rev_bwd" + tail):
        got = rev_bwd(*args)
    for a, b in zip(got, rev_bwd_plain(*args)):
        close(a, b)

    args = (e_new, values, c["by_key"], c["ids"])
    with _launched("sigma_aggregate_gather" + tail):
        sums = sigma_aggregate(*args)
    assert sums.shape == (n_seg, 2 * d)
    torch.testing.assert_close(sums, sigma_aggregate_plain(*args), **TOL)
    args = (e_new, g_sums, values, c["by_key"], c["ids"])
    with _launched("sigma_aggregate_bwd_gather" + tail):
        got = sigma_aggregate_bwd(*args)
    for a, b in zip(got, sigma_aggregate_bwd_plain(*args)):
        close(a, b)


def test_halo_pair_on_the_card_at_world_size_1(cuda):
    """The halo exchange and reduce of rank 0 of a 2-shard layout on the
    card with no process group (an all-to-all over no group is the
    identity): the send gather and the send CSR's segment sum run their
    kernels, agree with the CPU, and form an exact adjoint pair on small
    integers."""
    from gnnome_tpu_torch.parallel.mesh import Mesh
    from gnnome_tpu_torch.parallel.sharded import (
        halo_exchange, halo_reduce, prepare_batch, shard_batch)

    g, rng = _graph(41, n=1500, e=8000, device="cpu")  # nodes on both shards
    sample = type("Sample", (), dict(
        graph=g, e_feat=torch.zeros(g.n_edges_padded, 2), y=torch.zeros(g.n_edges_padded),
        pe=torch.zeros(g.n_nodes_padded, 6)))
    batch = prepare_batch([sample], Mesh(1, 2))
    out = {}
    for dev in ("cpu", cuda):
        mesh = Mesh(1, 2, 0, torch.device(dev))
        shard = shard_batch(batch, mesh)
        assert (shard.by_send.key < shard.n_local).any()  # rows to send
        r = np.random.default_rng(5)
        x = torch.from_numpy(r.integers(-4, 5, (shard.n_local, 64)).astype(np.float32)).to(dev)
        y = torch.from_numpy(r.integers(-4, 5, (shard.n_local + shard.n_halo, 64))
                             .astype(np.float32)).to(dev)
        if dev != "cpu":
            with _launched("take_rows"):
                (ex,) = halo_exchange([x], shard, mesh)
            with _launched("segment_sum_by_src"):
                red = halo_reduce(y, shard, mesh)
        else:
            (ex,) = halo_exchange([x], shard, mesh)
            red = halo_reduce(y, shard, mesh)
        out[str(dev)] = (ex.cpu(), red.cpu(), float((ex * y).sum()), float((x * red).sum()))
    (ex, red, lhs, rhs), (ex_c, red_c, _, _) = out["cuda"], out["cpu"]
    assert torch.equal(ex, ex_c) and torch.equal(red, red_c)
    assert lhs == rhs != 0.0


@pytest.mark.parametrize("batch_norm", [True, False])
def test_sharded_step_at_world_size_1_is_train_step(cuda, batch_norm):
    """The sharded step at world size 1 (no process group) on the card:
    loss and gradients bit for bit those of the single-card step on the
    graph padded as the sharded batch pads it (the same kernels on the
    same layouts)."""
    from gnnome_tpu_torch.data.dataset import GraphSample
    from gnnome_tpu_torch.parallel.mesh import make_mesh
    from gnnome_tpu_torch.parallel.sharded import make_sharded_loss, prepare_batch, shard_batch
    from gnnome_tpu_torch.train.checkpoint import params_from_jax

    rng = np.random.default_rng(42)
    n, e = 300, 2500
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = src != dst
    g = build_graph(src[keep], dst[keep], n, node_pad_multiple=512, edge_pad_multiple=1024,
                    device=cuda)
    s = GraphSample(idx=0, graph=g,
                    e_feat=_randn(rng, g.n_edges_padded, 2, device=cuda),
                    pe=_randn(rng, g.n_nodes_padded, 6, device=cuda),
                    y=torch.from_numpy((rng.random(g.n_edges_padded) < 0.7)
                                       .astype(np.float32)).to(cuda),
                    prefix_length=None, read_length=None, overlap_length=None,
                    overlap_similarity=None, src=None, dst=None)
    cfg = ModelConfig(hidden_features=64, num_gnn_layers=2, nb_pos_enc=4)
    arrays = {k: v.cpu().numpy() for k, v in iter_leaves(
        init_model_params(torch.Generator().manual_seed(3), cfg, "cpu"))}
    mesh = make_mesh(device=cuda)
    shard = shard_batch(prepare_batch([s], mesh), mesh)

    def grads_of(loss_fn):
        params = params_from_jax(arrays, device=cuda)
        for _, leaf in iter_leaves(params):
            leaf.requires_grad_(True)
        loss = loss_fn(params)
        loss.backward()
        return loss.detach(), {k: v.grad for k, v in iter_leaves(params)}

    sharded_loss = make_sharded_loss(mesh, batch_norm=batch_norm)
    loss, grads = grads_of(lambda p: sharded_loss(p, shard, 0.5)[1])
    ref, ref_grads = grads_of(lambda p: bce_with_logits(
        model_forward(p, g, s.e_feat, s.pe, batch_norm=batch_norm), s.y, g.edge_mask, 0.5))
    assert torch.equal(loss, ref)
    for k, w in ref_grads.items():
        assert torch.equal(grads[k], w), k


# ---------------------------------------------------------------------------
# the LayerNorm -> ReLU -> residual row kernel (csrc/layer_norm.cu)
# ---------------------------------------------------------------------------

# (rows, D): the edge norm's full size; the tests' small and ragged widths
# (16-byte rows of 1, 2 and 9 chunks a group; D = 6 of single elements);
# the looped instance past 32 values a lane (D = 1100, 4096)
LN_SHAPES = [(1_000_000, 256), (999, 8), (999, 72), (999, 264), (333, 6), (257, 1100),
             (65, 4096)]


def _ln_case(cuda, rows, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(rows * 7919 + d)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=cuda) * scale + shift).to(dtype)

    # rows centred at 0.5 with spread 2, so the mean is not zero
    return (randn(rows, d, scale=2.0, shift=0.5), randn(d, scale=0.5, shift=1.0),
            randn(d, scale=0.5), randn(rows, d), randn(rows, d))


def _ln_truth(x, scale, bias, res, g, keep):
    """f64 forward output, the LayerNorm's output y and xh, the backward
    under the ReLU mask ``keep``, and the sums of |terms| each column sum
    adds."""
    x64, s64, b64 = x.double(), scale.double(), bias.double()
    mean = x64.mean(-1, keepdim=True)
    xh = (x64 - mean) * torch.rsqrt(((x64 - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
    y = xh * s64 + b64
    dx, d_aff = layer_norm_relu_residual_bwd_plain(x64, g.double(), s64, b64, keep=keep)
    gy = torch.where(keep, g.double(), 0.0)
    mag = torch.stack([(gy * xh).abs().sum(0), gy.abs().sum(0)])
    return torch.relu(y) + res.double(), y, xh, dx, d_aff, mag


def _ln_layer_norm_bound(x, scale, bias, eps=1e-5):
    """tests/test_torch_bf16_wide.py's ``layer_norm_bound`` in torch: per
    element, twice the effect on the LayerNorm's output of rounding each of
    the plain bf16 chain's intermediates."""
    def ulp(t):
        return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126))) - 7)

    x, s, b = x.double(), scale.double(), bias.double()
    mu = x.mean(-1, keepdim=True)
    a = x - mu
    r = 1.0 / torch.sqrt((a * a).mean(-1, keepdim=True) + eps)
    ar, ars = a * r, a * r * s
    out = ars + b
    terms = (ulp(mu) / 2 * (r * s).abs() + ulp(a) / 2 * (r * s).abs()
             + (2.0 ** -9 + 2.0 ** -8 + 2.0 ** -9 + 2.0 ** -9) * ars.abs()
             + ulp(ar) / 2 * s.abs() + ulp(ars) / 2 + ulp(out) / 2)
    return 2 * terms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,d", LN_SHAPES)
def test_layer_norm_relu_residual_kernel(cuda, rows, d, dtype):
    """The forward and backward entries of one dtype against the f64 formula
    under the kernel's own ReLU mask (tight) and against the plain
    composition under autograd (where the two masks agree); the forward and
    the backward alike bit for bit in two calls (the recompute reproduces
    the forward); through autograd one launch of each entry and the
    residual's gradient the cotangent itself."""
    bf16 = dtype == torch.bfloat16
    tail = "_bf16" if bf16 else ""
    x, scale, bias, res, g = _ln_case(cuda, rows, d, dtype)
    with _launched("layer_norm_relu_residual" + tail):
        out = layer_norm_relu_residual_fwd(x, scale, bias, res)
    with _launched("layer_norm_relu_residual_bwd" + tail):
        dx, d_aff = layer_norm_relu_residual_bwd(x, g, scale, bias)
    assert out.dtype == dx.dtype == dtype and d_aff.dtype == torch.float32
    assert torch.equal(out, layer_norm_relu_residual_fwd(x, scale, bias, res))
    again = layer_norm_relu_residual_bwd(x, g, scale, bias)
    assert torch.equal(dx, again[0]) and torch.equal(d_aff, again[1])
    # with a zero residual the forward is relu(y) alone: the kernel's mask
    keep = layer_norm_relu_residual_fwd(x, scale, bias, torch.zeros_like(res)) > 0
    want_out, y, xh, want_dx, want_aff, mag = _ln_truth(x, scale, bias, res, g, keep)
    o, dxd = out.double(), dx.double()
    if bf16:
        ulp = lambda t: _bf16_ulp(t).double()  # noqa: E731
        assert bool(((o - want_out).abs() <= ulp(want_out) + ulp(y) + 1e-5).all())
        assert bool(((dxd - want_dx).abs() <= ulp(want_dx) + 1e-5).all())
    else:
        assert bool(((o - want_out).abs() <= 1e-5 * (1 + want_out.abs())).all())
        assert bool(((dxd - want_dx).abs() <= 1e-5 * (1 + want_dx.abs())).all())
    assert bool(((d_aff.double() - want_aff).abs() <= 1e-5 * (1 + mag)).all())

    # the plain composition under autograd
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, res)]
    plain = layer_norm_relu_residual_plain(*leaves)
    p_dx, p_ds, p_db, p_dr = torch.autograd.grad(plain, leaves, g)
    assert torch.equal(p_dr, g)
    if bf16:
        # the plain chain rounds each step to bf16: the output within its
        # rounding bound, the gradients within twice its own distance from
        # the f64 formula
        err = (o - plain.detach().double()).abs()
        bound = _ln_layer_norm_bound(x, scale, bias) + _bf16_ulp(o).double() * 2
        assert bool((err <= bound).all()), float((err - bound).max())
        for got_t, p_t, w_t in ((dxd, p_dx.double(), want_dx),
                                (d_aff[0].double(), p_ds.double(), want_aff[0]),
                                (d_aff[1].double(), p_db.double(), want_aff[1])):
            assert (got_t - p_t).norm() <= 2 * (p_t - w_t).norm() + 1e-3 * w_t.norm()
    else:
        torch.testing.assert_close(out, plain.detach(), **TOL)
        # elements whose y the two compute on other sides of 0 (rounding of
        # the statistics); their rows' dx and their column-sum terms apart
        flip = keep != (masked_layer_norm(x, scale, bias) > 0)  # the plain chain's mask
        assert int(flip.sum()) <= max(8, flip.numel() // 1_000_000), int(flip.sum())
        rows_ok = ~flip.any(-1)
        torch.testing.assert_close(dx[rows_ok], p_dx[rows_ok], **TOL)
        gd = g.double()
        slack = torch.stack([(gd * xh).abs().mul(flip).sum(0), gd.abs().mul(flip).sum(0)])
        p_aff = torch.stack([p_ds, p_db]).double()
        assert bool(((d_aff.double() - p_aff).abs() <= 1e-5 * (1 + mag) + slack).all())

    # through autograd: one launch of each entry, d_residual is g
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, res)]
    before = {k: v.launches for k, v in KERNELS.items()}
    out2 = layer_norm_relu_residual(*leaves)
    grads = torch.autograd.grad(out2, leaves, g)
    torch.cuda.synchronize()
    grew = {k: v.launches - before[k] for k, v in KERNELS.items() if v.launches != before[k]}
    assert grew == {"layer_norm_relu_residual" + tail: 1,
                    "layer_norm_relu_residual_bwd" + tail: 1}, grew
    assert grads[3] is g
    assert torch.equal(out2, out) and torch.equal(grads[0], dx)
    assert torch.equal(grads[1], d_aff[0].to(dtype)) and torch.equal(grads[2], d_aff[1].to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [72, 256, 4096])
def test_layer_norm_relu_residual_kernel_misaligned(cuda, d, dtype):
    """Bases off 16-byte alignment load element by element the same chunks
    the aligned call loads as 16-byte accesses: the same bits."""
    rows = 513
    x, scale, bias, res, g = _ln_case(cuda, rows, d, dtype)
    assert layer_norm_plan(d, dtype).vec > 1

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 != 0 and out.is_contiguous()
        return out

    args = (x, scale, bias, res)
    out = layer_norm_relu_residual_fwd(*args)
    assert torch.equal(layer_norm_relu_residual_fwd(*map(shifted, args)), out)
    dx, d_aff = layer_norm_relu_residual_bwd(x, g, scale, bias)
    dx2, d_aff2 = layer_norm_relu_residual_bwd(*map(shifted, (x, g, scale, bias)))
    assert torch.equal(dx2, dx) and torch.equal(d_aff2, d_aff)


# ---------------------------------------------------------------------------
# the BatchNorm -> ReLU -> residual kernels (csrc/batch_norm.cu)
# ---------------------------------------------------------------------------

# (rows, D, mask): the node norm's full size, padded to 128 rows as
# node_pad_multiple pads it; the tests' small and ragged widths (16-byte
# rows of 2, 18 and 66 chunks; D = 6 of single elements), with a mask that
# is not a prefix; two column tiles (D = 1100 of single elements, D = 4104
# of 16-byte chunks)
BN_SHAPES = [(150_016, 256, "trailing"), (999, 8, "scattered"), (999, 72, "scattered"),
             (999, 264, "trailing"), (333, 6, "scattered"), (257, 1100, "scattered"),
             (65, 4104, "trailing")]


def _bn_mask(rows, kind, device):
    if kind == "trailing":
        keep = np.arange(rows) < rows - (16 if rows > 1000 else rows // 4)
    else:
        keep = np.ones(rows, dtype=bool)
        keep[::3] = False
        keep[-10:] = False
    return torch.from_numpy(keep).to(device)


def _bn_truth(x, mask, scale, bias, res, g, keep):
    """f64 forward output, the BatchNorm's output y and xh, the backward
    under the ReLU mask ``keep``, and the sums of |terms| each column sum
    adds."""
    x64, s64, b64 = x.double(), scale.double(), bias.double()
    m = mask.double()[:, None]
    n = m.sum().clamp(min=1.0)
    mean = (x64 * m).sum(0) / n
    var = ((x64 * x64 * m).sum(0) / n - mean * mean).clamp(min=0.0)
    xh = (x64 - mean) * torch.rsqrt(var + 1e-5)
    y = xh * s64 + b64
    dx, d_aff = batch_norm_relu_residual_bwd_plain(x64, g.double(), mask, s64, b64, keep=keep)
    gy = torch.where(keep, g.double(), 0.0)
    mag = torch.stack([(gy * xh).abs().sum(0), gy.abs().sum(0)])
    return torch.relu(y) + res.double(), y, xh, dx, d_aff, mag


BN_ENTRIES = ("batch_norm_moments", "batch_norm_relu_residual",
              "batch_norm_relu_residual_bwd_sums", "batch_norm_relu_residual_bwd")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,d,kind", BN_SHAPES)
def test_batch_norm_relu_residual_kernel(cuda, rows, d, kind, dtype):
    """The forward and backward entries of one dtype against the f64 formula
    under the kernels' own ReLU mask (tight) and against the plain
    composition under autograd (where the two masks agree); the forward
    and the backward alike bit for bit in two calls (the recompute
    reproduces the forward); through autograd one launch of each entry and
    the residual's gradient the cotangent itself."""
    bf16 = dtype == torch.bfloat16
    tail = "_bf16" if bf16 else ""
    x, scale, bias, res, g = _ln_case(cuda, rows, d, dtype)
    mask = _bn_mask(rows, kind, cuda)
    before = {k: v.launches for k, v in KERNELS.items()}
    out, sums = batch_norm_relu_residual_fwd(x, mask, scale, bias, res)
    dx, d_aff = batch_norm_relu_residual_bwd(x, g, mask, sums, scale, bias)
    torch.cuda.synchronize()
    grew = {k: v.launches - before[k] for k, v in KERNELS.items() if v.launches != before[k]}
    assert grew == {k + tail: 1 for k in BN_ENTRIES}, grew
    assert out.dtype == dx.dtype == dtype and sums.dtype == d_aff.dtype == torch.float32
    again, sums2 = batch_norm_relu_residual_fwd(x, mask, scale, bias, res)
    assert torch.equal(out, again) and torch.equal(sums, sums2)
    dx2, d_aff2 = batch_norm_relu_residual_bwd(x, g, mask, sums, scale, bias)
    assert torch.equal(dx, dx2) and torch.equal(d_aff, d_aff2)
    # the sums: the count exactly, the column sums of the real rows
    real = x[mask].double()
    assert float(sums[0]) == float(mask.sum())
    col_mag = real.abs().sum(0)
    assert bool(((sums[1:1 + d].double() - real.sum(0)).abs() <= 1e-5 * (1 + col_mag)).all())
    assert bool(((sums[1 + d:].double() - (real * real).sum(0)).abs()
                 <= 1e-5 * (1 + (real * real).sum(0))).all())
    # with a zero residual the forward is relu(y) alone: the kernels' mask
    keep = batch_norm_relu_residual_fwd(x, mask, scale, bias, torch.zeros_like(res))[0] > 0
    want_out, y, xh, want_dx, want_aff, mag = _bn_truth(x, mask, scale, bias, res, g, keep)
    o, dxd = out.double(), dx.double()
    if bf16:
        ulp = lambda t: _bf16_ulp(t).double()  # noqa: E731
        assert bool(((o - want_out).abs() <= ulp(want_out) + ulp(y) + 1e-5).all())
        assert bool(((dxd - want_dx).abs() <= ulp(want_dx) + 1e-5).all())
    else:
        assert bool(((o - want_out).abs() <= 1e-5 * (1 + want_out.abs())).all())
        assert bool(((dxd - want_dx).abs() <= 1e-5 * (1 + want_dx.abs())).all())
    assert bool(((d_aff.double() - want_aff).abs() <= 1e-5 * (1 + mag)).all())

    # the plain composition under autograd
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, res)]
    plain = batch_norm_relu_residual_plain(leaves[0], mask, *leaves[1:])
    p_dx, p_ds, p_db, p_dr = torch.autograd.grad(plain, leaves, g)
    assert torch.equal(p_dr, g)
    if bf16:
        # the plain chain rounds where the kernels round (the BatchNorm's
        # output, then the sum): within an ulp of each; the gradients within
        # twice its own distance from the f64 formula
        _assert_bf16_close(out, plain.detach(), atol=1e-5 + float(ulp(y).max()))
        for got_t, p_t, w_t in ((dxd, p_dx.double(), want_dx),
                                (d_aff[0].double(), p_ds.double(), want_aff[0]),
                                (d_aff[1].double(), p_db.double(), want_aff[1])):
            assert (got_t - p_t).norm() <= 2 * (p_t - w_t).norm() + 1e-3 * w_t.norm()
    else:
        torch.testing.assert_close(out, plain.detach(), **TOL)
        # elements whose y the two compute on other sides of 0 (rounding of
        # the statistics); their dx and their column-sum terms apart
        flip = keep != (masked_batch_norm(x, mask, scale, bias) > 0)  # the plain chain's mask
        assert int(flip.sum()) <= max(8, flip.numel() // 1_000_000), int(flip.sum())
        torch.testing.assert_close(dx[~flip], p_dx[~flip], **TOL)
        gd = g.double()
        slack = torch.stack([(gd * xh).abs().mul(flip).sum(0), gd.abs().mul(flip).sum(0)])
        p_aff = torch.stack([p_ds, p_db]).double()
        assert bool(((d_aff.double() - p_aff).abs() <= 1e-5 * (1 + mag) + slack).all())

    # through autograd: one launch of each entry, d_residual is g
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, res)]
    before = {k: v.launches for k, v in KERNELS.items()}
    out2 = batch_norm_relu_residual(leaves[0], mask, *leaves[1:])
    grads = torch.autograd.grad(out2, leaves, g)
    torch.cuda.synchronize()
    grew = {k: v.launches - before[k] for k, v in KERNELS.items() if v.launches != before[k]}
    assert grew == {k + tail: 1 for k in BN_ENTRIES}, grew
    assert grads[3] is g
    assert torch.equal(out2, out) and torch.equal(grads[0], dx)
    assert torch.equal(grads[1], d_aff[0].to(dtype)) and torch.equal(grads[2], d_aff[1].to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [72, 256, 4104])
def test_batch_norm_relu_residual_kernel_misaligned(cuda, d, dtype):
    """Bases off 16-byte alignment load element by element the same chunks
    the aligned call loads as 16-byte accesses: the same bits."""
    rows = 513
    x, scale, bias, res, g = _ln_case(cuda, rows, d, dtype)
    mask = _bn_mask(rows, "scattered", cuda)
    assert batch_norm_plan(d).vec > 1

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 != 0 and out.is_contiguous()
        return out

    out, sums = batch_norm_relu_residual_fwd(x, mask, scale, bias, res)
    xs, ss, bs, rs = map(shifted, (x, scale, bias, res))
    out2, sums2 = batch_norm_relu_residual_fwd(xs, mask, ss, bs, rs)
    assert torch.equal(out2, out) and torch.equal(sums2, sums)
    dx, d_aff = batch_norm_relu_residual_bwd(x, g, mask, sums, scale, bias)
    dx2, d_aff2 = batch_norm_relu_residual_bwd(xs, shifted(g), mask, sums, ss, bs)
    assert torch.equal(dx2, dx) and torch.equal(d_aff2, d_aff)
