"""The BatchNorm → ReLU → residual of the BatchNorm branch on the CPU
(``ops/norm.py`` ``batch_norm_relu_residual``; its kernels,
``csrc/batch_norm.cu``, run on the card only: tests/test_torch_cuda.py).

* The plain function and its autograd gradients against the JAX package's
  ``relu(masked_batch_norm(x, mask)) + residual`` through ``jax.vjp``, with
  padded rows (trailing, and a mask that is not a prefix), in f32:
  rtol = atol = 1e-5 (the column sums run in another order).
* The kernels' backward formula, transcribed op by op
  (``batch_norm_relu_residual_bwd_plain``, the card tests' second
  reference), against autograd of the plain composition: 1e-12 in f64,
  where the two differ only by rounding; 1e-5 in f32.
* The launch plan at every width up to 4096, and the benchmark's cost of
  each new entry worked by hand at benchmark/tests/test_bench_costs.py's
  shape.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import costs
from benchmark.peaks import FP32_OPS_PER_S
from gnnome_tpu.ops.norm import masked_batch_norm as jax_batch_norm
from gnnome_tpu_torch.config import ModelConfig
from gnnome_tpu_torch.core.graph import build_graph
from gnnome_tpu_torch.models import gated_gcn
from gnnome_tpu_torch.models.model import init_model_params, model_forward
from gnnome_tpu_torch.ops.norm import (
    BN_THREADS, BN_VALUES_PER_LANE, batch_norm_plan,
    batch_norm_relu_residual, batch_norm_relu_residual_bwd, batch_norm_relu_residual_bwd_plain,
    batch_norm_relu_residual_fwd, masked_batch_norm, masked_moments)

ROOT = Path(__file__).resolve().parent.parent


def _inputs(rows, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * 2.0 + 0.5).astype(dtype)
    scale = (rng.standard_normal(d) * 0.5 + 1.0).astype(dtype)
    bias = (rng.standard_normal(d) * 0.5).astype(dtype)
    res, g = (rng.standard_normal((rows, d)).astype(dtype) for _ in range(2))
    return x, scale, bias, res, g


def _mask(rows, kind, seed=0):
    """Trailing padding (``node_pad_multiple`` > 1), or a mask that is not a
    prefix (every third row padded, and the last ten)."""
    if kind == "trailing":
        return np.arange(rows) < rows - rows // 4
    keep = np.ones(rows, dtype=bool)
    keep[::3] = False
    keep[-10:] = False
    return keep


@pytest.mark.parametrize("kind", ["trailing", "scattered"])
@pytest.mark.parametrize("d", [6, 8, 72, 256, 264])
def test_batch_norm_relu_residual_matches_jax_and_its_vjp(d, kind):
    x, scale, bias, res, g = _inputs(300, d, seed=d)
    mask = _mask(300, kind)

    def jax_fn(x, scale, bias, res):
        return jax.nn.relu(jax_batch_norm(x, jnp.asarray(mask), scale, bias)) + res

    want, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (x, scale, bias, res)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias, res)]
    got = batch_norm_relu_residual(leaves[0], torch.from_numpy(mask), *leaves[1:])
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for name, leaf, w in zip(("dx", "d_scale", "d_bias", "d_residual"), leaves, want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=name)


def _batch_norm(x, mask, scale, bias, eps=1e-5):
    """``masked_batch_norm`` in x's own dtype (it takes the moments in f32,
    which would hide an f64 formula's error under f32 rounding)."""
    m = mask.to(x.dtype)[:, None]
    n = torch.clamp(m.sum(), min=1.0)
    mean = (x * m).sum(0) / n
    var = torch.clamp((x * x * m).sum(0) / n - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["trailing", "scattered"])
@pytest.mark.parametrize("d", [8, 72, 264])
def test_kernel_backward_formula_matches_autograd(d, kind, dtype):
    """dx = rstd·(gy·scale) − m·(rstd/n)·(A + xh·B), A = scale·Σ gy,
    B = scale·Σ gy·xh, gy = g·[y > 0], and the column sums over every row,
    against autograd of the op-by-op chain, padded rows included; the CPU
    wrappers of the two entries run the plain forward and this formula."""
    x, scale, bias, res, g = (torch.from_numpy(a).to(dtype)
                              for a in _inputs(200, d, seed=7 + d))
    mask = torch.from_numpy(_mask(200, kind))
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, res)]
    out = torch.relu(_batch_norm(leaves[0], mask, *leaves[1:3])) + leaves[3]
    want = torch.autograd.grad(out, leaves, g)
    dx, d_affine = batch_norm_relu_residual_bwd_plain(x, g, mask, scale, bias)
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == torch.float64 else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx, want[0], **tol)
    torch.testing.assert_close(d_affine[0].to(dtype), want[1], **tol)
    torch.testing.assert_close(d_affine[1].to(dtype), want[2], **tol)
    assert torch.equal(want[3], g)  # the residual's gradient: the cotangent itself
    fwd, sums = batch_norm_relu_residual_fwd(x, mask, scale, bias, res)
    got = batch_norm_relu_residual_bwd(x, g, mask, sums, scale, bias)
    assert torch.equal(got[0], dx) and torch.equal(got[1], d_affine)
    # the forward entry's CPU form is the plain composition, and its sums
    # give masked_moments' statistics
    plain = torch.relu(masked_batch_norm(x, mask, scale, bias)) + res
    assert torch.equal(fwd, plain)
    n = sums[0].clamp(min=1.0)
    mean, var = masked_moments(x, mask)
    torch.testing.assert_close(sums[1:1 + d] / n, mean)
    torch.testing.assert_close(torch.clamp(sums[1 + d:] / n - mean * mean, min=0.0), var)


def test_kernel_backward_formula_where_the_variance_clamps():
    """A column constant over the real rows: its variance rounds below zero
    and is clamped, and no gradient passes the clamp; the
    formula drops B there, as autograd does."""
    x, scale, bias, res, g = (torch.from_numpy(a).double() for a in _inputs(60, 8, seed=5))
    mask = torch.from_numpy(_mask(60, "scattered"))
    x[mask, 3] = 0.7  # Σx²/n − mean² reads −4.4e-16 in f64
    m = mask.double()[:, None]
    assert float((x[:, 3:4] * x[:, 3:4] * m).sum() / m.sum()
                 - ((x[:, 3:4] * m).sum() / m.sum()) ** 2) < 0
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, res)]
    out = torch.relu(_batch_norm(leaves[0], mask, *leaves[1:3])) + leaves[3]
    want = torch.autograd.grad(out, leaves, g)
    dx, d_affine = batch_norm_relu_residual_bwd_plain(x, g, mask, scale, bias)
    torch.testing.assert_close(dx, want[0], rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(d_affine, torch.stack(want[1:3]), rtol=1e-9, atol=1e-9)


def test_kernel_backward_formula_takes_a_given_mask():
    """``keep`` replaces the ReLU's mask (the card tests pass the kernel's
    own): with every element kept, the formula is BatchNorm's gradient."""
    x, scale, bias, _, g = (torch.from_numpy(a).double() for a in _inputs(50, 16, seed=3))
    mask = torch.from_numpy(_mask(50, "trailing"))
    xl = x.clone().requires_grad_(True)
    sl, bl = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    want = torch.autograd.grad(_batch_norm(xl, mask, sl, bl), (xl, sl, bl), g)
    dx, d_affine = batch_norm_relu_residual_bwd_plain(
        x, g, mask, scale, bias, keep=torch.ones_like(x, dtype=torch.bool))
    torch.testing.assert_close(dx, want[0], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(d_affine, torch.stack(want[1:]), rtol=1e-12, atol=1e-12)


def batch_norm_col_tiles(d, plan):
    """Column tiles of the plan's layout over a row of ``d``, as
    csrc/batch_norm.cu ``col_tiles`` counts them."""
    return -(-d // ((plan.chunks << plan.lanes_log2) * plan.vec))


def test_batch_norm_plan_at_every_width():
    """From 1 to 4096: chunks of 4 elements exactly where the row is a
    multiple of 4 (16-byte accesses in f32, 8-byte in bf16); the fewest
    lanes (a power of two up to the block's 256) that cover the row, then
    the fewest chunks (1, 2, 4) within 16 values a lane; several column
    tiles only where the widest tile is too narrow."""
    for d in range(1, 4097):
        vec, lanes_log2, chunks = plan = batch_norm_plan(d)
        assert vec == (4 if d % 4 == 0 else 1), d
        per_row = d // vec
        lanes = 1 << lanes_log2
        fits = [c for c in (1, 2, 4) if c * vec <= BN_VALUES_PER_LANE]
        assert chunks in fits and lanes <= BN_THREADS, d
        assert lanes == 1 or lanes // 2 < min(per_row, BN_THREADS), d  # no fewer lanes
        tiles = batch_norm_col_tiles(d, plan)
        if tiles == 1:
            assert chunks * lanes >= per_row, d  # one tile covers the row
            assert chunks == 1 or (chunks // 2) * lanes < per_row, d
        else:
            assert lanes == BN_THREADS and chunks == max(fits), d
            assert (tiles - 1) * chunks * lanes < per_row <= tiles * chunks * lanes, d
    assert batch_norm_plan(256) == (4, 6, 1)  # the model's rows: 64 lanes, 4 rows a block
    assert batch_norm_col_tiles(4096, batch_norm_plan(4096)) == 1
    assert batch_norm_col_tiles(4095, batch_norm_plan(4095)) == 4  # single elements
    assert batch_norm_col_tiles(4104, batch_norm_plan(4104)) == 2
    with pytest.raises(ValueError):
        batch_norm_plan(0)


# benchmark/tests/test_bench_costs.py's shape: N = 10 nodes, D = 8; and the
# same graph with 6 padded nodes
G = dict(n=10, e=40, nr=10, er=30, u_src=10, u_dst=10)
G_PAD = dict(G, n=16)
PARTS = 1056
# entry: (graph, integer arguments, bytes, operations) worked by hand
COSTS = {
    # x on the 10 real rows (80 * 4), the mask (10), the partial rows and
    # the sums ((1056 + 1) * 17 * 4); 3 an element
    "batch_norm_moments": (G, (10, 8, 4, 1, 1, 1, PARTS), 320 + 10 + 71876, 240),
    # on the padded graph: x still of the 10 real rows, the mask of 16
    "batch_norm_moments_bf16": (G_PAD, (16, 8, 8, 0, 1, 1, PARTS), 160 + 16 + 71876, 240),
    # x, residual, out (3 * 80), scale and bias (16), the sums (17); 6 an element
    "batch_norm_relu_residual": (G, (10, 8, 1e-5, 4, 1, 1, 1), (240 + 16 + 17) * 4, 480),
    "batch_norm_relu_residual_bf16": (G, (10, 8, 1e-5, 8, 0, 1, 1), (240 + 16) * 2 + 17 * 4,
                                      480),
    # x and g (2 * 80), scale and bias (16), the sums (17), the partial rows
    # and the two gradients ((1056 + 1) * 16); 8 an element
    "batch_norm_relu_residual_bwd_sums": (G, (10, 8, 1e-5, 4, 1, 1, 1, PARTS),
                                          (160 + 16 + 17 + 16912) * 4, 640),
    "batch_norm_relu_residual_bwd_sums_bf16": (G, (10, 8, 1e-5, 8, 0, 1, 1, PARTS),
                                               (160 + 16) * 2 + (17 + 16912) * 4, 640),
    # x, g, dx (3 * 80), scale and bias (16), the sums (17) and the column
    # sums (16); the mask (10); 12 an element
    "batch_norm_relu_residual_bwd": (G, (10, 8, 1e-5, 4, 1, 1, 1), (240 + 16 + 17 + 16) * 4 + 10,
                                     960),
    "batch_norm_relu_residual_bwd_bf16": (G, (10, 8, 1e-5, 8, 0, 1, 1),
                                          (240 + 16) * 2 + (17 + 16) * 4 + 10, 960),
}


@pytest.mark.parametrize("entry", list(COSTS))
def test_cost_by_hand(entry):
    g, ints, n_bytes, n_ops = COSTS[entry]
    assert costs.load(entry)(ints, g) == (n_bytes, n_ops, FP32_OPS_PER_S)


def test_kernel_source_has_no_atomics():
    """Every sum of csrc/batch_norm.cu is a fixed-order sum (a launch repeats
    bit for bit); its device kernels are named ``*_kernel``, as the
    benchmark finds the program's kernels."""
    src = (ROOT / "gnnome_tpu_torch" / "csrc" / "batch_norm.cu").read_text()
    assert not re.search(r"\batomic\w*\s*\(", src)  # atomicAdd(...) and the like
    kernels = re.findall(r"__global__ void __launch_bounds__\([\w *]+\) (\w+)\(", src)
    assert len(kernels) == 5 and all(k.endswith("_kernel") for k in kernels), kernels


@pytest.mark.parametrize("batch_norm", [True, False], ids=["batchnorm", "layernorm"])
def test_model_takes_the_fused_node_norm_on_the_batchnorm_branch(batch_norm, monkeypatch):
    """The BatchNorm model calls ``batch_norm_relu_residual`` once a layer
    (the node norm, with the graph's node mask and the layer's input as the
    residual); the LayerNorm model never does."""
    calls = []
    real = gated_gcn.batch_norm_relu_residual

    def counted(x, mask, scale, bias, residual, eps=1e-5, group=None):
        calls.append((x.shape, mask.dtype, residual.shape))
        return real(x, mask, scale, bias, residual, eps, group)

    monkeypatch.setattr(gated_gcn, "batch_norm_relu_residual", counted)
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 60, 300), rng.integers(0, 60, 300)
    keep = src != dst
    g = build_graph(src[keep], dst[keep], 60, device="cpu")
    cfg = ModelConfig(hidden_features=16, num_gnn_layers=3, nb_pos_enc=4)
    params = init_model_params(torch.Generator().manual_seed(0), cfg, "cpu")
    e_feat = torch.from_numpy(rng.standard_normal((g.n_edges_padded, 2)).astype(np.float32))
    pe = torch.from_numpy(rng.standard_normal((g.n_nodes_padded, 6)).astype(np.float32))
    model_forward(params, g, e_feat, pe, batch_norm=batch_norm)
    rows = (g.n_nodes_padded, 16)
    assert calls == ([(rows, torch.bool, rows)] * 3 if batch_norm else [])
