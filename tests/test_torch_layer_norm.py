"""The LayerNorm → ReLU → residual of the LayerNorm branch on the CPU
(``ops/norm.py`` ``layer_norm_relu_residual``; its kernel,
``csrc/layer_norm.cu``, runs on the card only: tests/test_torch_cuda.py).

* The plain function and its autograd gradients against the JAX package's
  ``relu(masked_layer_norm(x)) + residual`` through ``jax.vjp``, in f32:
  rtol = atol = 1e-5 (the row sums run in another order).
* The kernel's backward formula, transcribed op by op
  (``layer_norm_relu_residual_bwd_plain``, the card tests' second
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
from gnnome_tpu.ops.norm import masked_layer_norm as jax_layer_norm
from gnnome_tpu_torch.config import ModelConfig
from gnnome_tpu_torch.core.graph import build_graph
from gnnome_tpu_torch.models import gated_gcn
from gnnome_tpu_torch.models.model import init_model_params, model_forward
from gnnome_tpu_torch.ops.norm import (
    LN_LOOP_MAX_D, LN_VALUES_PER_LANE, layer_norm_plan, layer_norm_relu_residual,
    layer_norm_relu_residual_bwd, layer_norm_relu_residual_bwd_plain,
    layer_norm_relu_residual_fwd, masked_layer_norm)

ROOT = Path(__file__).resolve().parent.parent


def _inputs(rows, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * 2.0 + 0.5).astype(dtype)
    scale = (rng.standard_normal(d) * 0.5 + 1.0).astype(dtype)
    bias = (rng.standard_normal(d) * 0.5).astype(dtype)
    res, g = (rng.standard_normal((rows, d)).astype(dtype) for _ in range(2))
    return x, scale, bias, res, g


@pytest.mark.parametrize("d", [6, 8, 72, 256, 264])
def test_layer_norm_relu_residual_matches_jax_and_its_vjp(d):
    x, scale, bias, res, g = _inputs(300, d, seed=d)

    def jax_fn(x, scale, bias, res):
        return jax.nn.relu(jax_layer_norm(x, scale, bias)) + res

    want, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (x, scale, bias, res)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias, res)]
    got = layer_norm_relu_residual(*leaves)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for name, leaf, w in zip(("dx", "d_scale", "d_bias", "d_residual"), leaves, want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("d", [8, 72, 264])
def test_kernel_backward_formula_matches_autograd(d, dtype):
    """dx = rstd·(gx − mean(gx) − xh·mean(gx·xh)), gx = g·[y > 0]·scale, and
    the column sums, against autograd of the op-by-op chain; the CPU
    wrapper of the backward entry runs the same formula."""
    x, scale, bias, res, g = (torch.from_numpy(a).to(dtype) for a in _inputs(200, d, seed=7 + d))
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, res)]
    out = torch.relu(masked_layer_norm(*leaves[:3])) + leaves[3]
    want = torch.autograd.grad(out, leaves, g)
    dx, d_affine = layer_norm_relu_residual_bwd_plain(x, g, scale, bias)
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == torch.float64 else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx, want[0], **tol)
    torch.testing.assert_close(d_affine[0].to(dtype), want[1], **tol)
    torch.testing.assert_close(d_affine[1].to(dtype), want[2], **tol)
    assert torch.equal(want[3], g)  # the residual's gradient: the cotangent itself
    got = layer_norm_relu_residual_bwd(x, g, scale, bias)
    assert torch.equal(got[0], dx) and torch.equal(got[1], d_affine)
    # the forward entry's CPU form is the plain composition
    assert torch.equal(layer_norm_relu_residual_fwd(x, scale, bias, res), out.detach())


def test_kernel_backward_formula_takes_a_given_mask():
    """``keep`` replaces the ReLU's mask (the card tests pass the kernel's
    own): with every element kept, the formula is LayerNorm's gradient."""
    x, scale, bias, _, g = (torch.from_numpy(a).double() for a in _inputs(50, 16, seed=3))
    xl = x.clone().requires_grad_(True)
    sl, bl = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    want = torch.autograd.grad(masked_layer_norm(xl, sl, bl), (xl, sl, bl), g)
    dx, d_affine = layer_norm_relu_residual_bwd_plain(x, g, scale, bias,
                                                      keep=torch.ones_like(x, dtype=torch.bool))
    torch.testing.assert_close(dx, want[0], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(d_affine, torch.stack(want[1:]), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_layer_norm_plan_at_every_width(dtype):
    """From 1 to 4096: 16-byte chunks exactly where a row is a multiple of
    16 bytes; in registers, the fewest lanes (8 to 32) and then the fewest
    chunks (1, 2, 4, 8) that cover the row within 32 values a lane; the
    looped instance (a warp a row) only where no such layout fits."""
    size = 4 if dtype == torch.float32 else 2
    for d in range(1, 4097):
        vec, lanes_log2, chunks = layer_norm_plan(d, dtype)
        assert vec == (16 // size if (d * size) % 16 == 0 else 1) and d % vec == 0, d
        per_row = d // vec
        lanes = 1 << lanes_log2
        fits = [c for c in (1, 2, 4, 8) if c * vec <= LN_VALUES_PER_LANE]
        if chunks:
            assert lanes_log2 in (3, 4, 5) and chunks in fits, d
            assert chunks * lanes >= per_row, d  # the row is covered
            assert lanes == 8 or lanes // 2 < per_row, d  # no fewer lanes would do
            assert chunks == 1 or (chunks // 2) * lanes < per_row, d
        else:
            assert lanes_log2 == 5 and max(fits) * 32 < per_row, d
    assert layer_norm_plan(256, torch.float32) == (4, 5, 2)  # the model's rows
    assert layer_norm_plan(256, torch.bfloat16) == (8, 5, 1)
    assert layer_norm_plan(LN_LOOP_MAX_D, dtype).chunks == 0
    for d in (0, LN_LOOP_MAX_D + 1):
        with pytest.raises(ValueError):
            layer_norm_plan(d, dtype)


# benchmark/tests/test_bench_costs.py's shape: E = 40 edge rows, D = 8
G = dict(n=10, e=40, nr=10, er=30, u_src=10, u_dst=10)


def test_cost_of_the_forward_by_hand():
    # x, residual and out (3 * 40 * 8), scale and bias (2 * 8); 10 operations
    # an element
    ints = (40, 8, 1e-5, 4, 3, 1, 1)
    assert costs.load("layer_norm_relu_residual")(ints, G) == (
        (960 + 16) * 4, 10 * 320, FP32_OPS_PER_S)


def test_cost_of_the_backward_by_hand():
    # x, g and dx (3 * 40 * 8), scale, bias and the two gradients (4 * 8),
    # 1056 partial rows of both gradients (2 * 1056 * 8); 20 an element
    ints = (40, 8, 1e-5, 4, 3, 1, 1, 1056)
    assert costs.load("layer_norm_relu_residual_bwd")(ints, G) == (
        (960 + 32 + 16896) * 4, 20 * 320, FP32_OPS_PER_S)


def test_kernel_source_has_no_float_atomics():
    """Every sum of csrc/layer_norm.cu is a fixed-order sum (a launch repeats
    bit for bit); its device kernels are named ``*_kernel``, as the
    benchmark finds the program's kernels."""
    src = (ROOT / "gnnome_tpu_torch" / "csrc" / "layer_norm.cu").read_text()
    assert not re.search(r"\batomic\w*\s*\(", src)  # atomicAdd(...) and the like
    kernels = re.findall(r"__global__ void __launch_bounds__\(\w+\) (\w+)\(", src)
    assert len(kernels) == 5 and all(k.endswith("_kernel") for k in kernels), kernels


@pytest.mark.parametrize("batch_norm", [False, True], ids=["layernorm", "batchnorm"])
def test_model_takes_the_fused_norm_on_the_layernorm_branch(batch_norm, monkeypatch):
    """The LayerNorm model calls ``layer_norm_relu_residual`` twice a layer
    (the edge and the node norm, each with its residual); the BatchNorm
    model never does."""
    calls = []
    real = gated_gcn.layer_norm_relu_residual

    def counted(x, scale, bias, residual, eps=1e-5):
        calls.append(x.shape)
        return real(x, scale, bias, residual, eps)

    monkeypatch.setattr(gated_gcn, "layer_norm_relu_residual", counted)
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 60, 300), rng.integers(0, 60, 300)
    keep = src != dst
    g = build_graph(src[keep], dst[keep], 60, device="cpu")
    cfg = ModelConfig(hidden_features=16, num_gnn_layers=3, nb_pos_enc=4)
    params = init_model_params(torch.Generator().manual_seed(0), cfg, "cpu")
    e_feat = torch.from_numpy(rng.standard_normal((g.n_edges_padded, 2)).astype(np.float32))
    pe = torch.from_numpy(rng.standard_normal((g.n_nodes_padded, 6)).astype(np.float32))
    model_forward(params, g, e_feat, pe, batch_norm=batch_norm)
    want = [] if batch_norm else [(g.n_edges_padded, 16), (g.n_nodes_padded, 16)] * 3
    assert calls == want
