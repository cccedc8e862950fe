"""Masked normalization layers (counterpart of ``gnnome_tpu/ops/norm.py``).

The reference uses ``nn.BatchNorm1d(..., track_running_stats=False)``
(``layers/gated_gcn_full.py:55-56``): statistics come from the current
batch in train and eval mode alike. Rows may be padded, so the moments are
taken over valid rows only, always in f32.

Where the rows are sharded over ranks (``parallel/sharded.py``), a process
group takes the place of JAX's ``axis_name``: the count, Σx and Σx² are
all-reduced over it in f32 (one differentiable all-reduce), so every rank
sees the statistics of the whole row set.

The LayerNorm branch takes its norm with the ReLU and the residual add
that follow it as one function, :func:`layer_norm_relu_residual`
(``relu(LN(x)·scale + bias) + residual``). On the card it runs the row
kernel of ``csrc/layer_norm.cu``, forward and backward; on CPU tensors, the
plain composition. The JAX package has no kernel here (XLA fuses its
``masked_layer_norm``, ``gnnome_tpu/ops/norm.py:58``, with what surrounds it).

Each function runs inside a ``norm`` span (``utils/profiling.py``), the
LayerNorm's backward too.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gnnome_tpu_torch.core.collectives import all_reduce_sum
from gnnome_tpu_torch.ops.cuda_lib import (
    F32, I32, I64, P, Kernel, check_cuda_args, entry, on_cpu, register)
from gnnome_tpu_torch.utils.profiling import span

_LN_REPLACES = "none: XLA fuses gnnome_tpu/ops/norm.py:58 masked_layer_norm"
_LN_FWD_ARGS = [P, P, P, P, P, I64, I32, F32, I32, I32, I32, I32]
_LN_BWD_ARGS = [P, P, P, P, P, P, P, I64, I32, F32, I32, I32, I32, I32, I32]
LAYER_NORM = register(Kernel(
    "layer_norm_relu_residual", "gnnome_layer_norm_relu_residual_f32", _LN_FWD_ARGS,
    source="gnnome_tpu_torch/csrc/layer_norm.cu", replaces=_LN_REPLACES))
LAYER_NORM_BF16 = register(Kernel(
    "layer_norm_relu_residual_bf16", "gnnome_layer_norm_relu_residual_bf16", _LN_FWD_ARGS,
    source="gnnome_tpu_torch/csrc/layer_norm.cu", replaces=_LN_REPLACES,
    dtype=torch.bfloat16))
LAYER_NORM_BWD = register(Kernel(
    "layer_norm_relu_residual_bwd", "gnnome_layer_norm_relu_residual_bwd_f32", _LN_BWD_ARGS,
    source="gnnome_tpu_torch/csrc/layer_norm.cu", replaces=_LN_REPLACES))
LAYER_NORM_BWD_BF16 = register(Kernel(
    "layer_norm_relu_residual_bwd_bf16", "gnnome_layer_norm_relu_residual_bwd_bf16",
    _LN_BWD_ARGS, source="gnnome_tpu_torch/csrc/layer_norm.cu", replaces=_LN_REPLACES,
    dtype=torch.bfloat16))

# the row kernels hold at most this many values of a row a lane; wider rows
# loop, with a shared row of 2·D column sums for each of 4 warps a block
LN_VALUES_PER_LANE = 32
LN_LOOP_MAX_D = 232448 // (2 * 4 * 4)
# backward partial rows: at most 8 blocks of 256 threads an SM
_LN_BLOCKS_PER_SM = 8


def masked_moments(x: torch.Tensor, mask: torch.Tensor, group=None):
    """Per-feature mean and (biased) variance over rows where ``mask``,
    over the rows of every rank of ``group`` when one is given."""
    with span("norm"):
        x = x.to(torch.float32)
        m = mask.to(torch.float32)[:, None]
        count, s, ss = m.sum(), (x * m).sum(0), (x * x * m).sum(0)
        if group is not None:
            d = s.shape[0]
            count, s, ss = all_reduce_sum(torch.cat([count[None], s, ss]), group).split(
                [1, d, d])
            count = count[0]
        count = torch.clamp(count, min=1.0)
        mean = s / count
        var = ss / count - mean * mean
        return mean, torch.clamp(var, min=0.0)


def masked_batch_norm(x, mask, scale, bias, eps: float = 1e-5, group=None):
    """BatchNorm1d with per-batch statistics (track_running_stats=False);
    ``group``: the process group the rows are sharded over."""
    with span("norm"):
        mean, var = masked_moments(x, mask, group)
        out = (x.to(torch.float32) - mean) * torch.rsqrt(var + eps) * scale.to(torch.float32)
        return (out + bias.to(torch.float32)).to(x.dtype)


def masked_layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the feature axis (the ``batch_norm=False`` branch,
    ``layers/gated_gcn_full.py:57-59``). Row-wise, so padding is harmless."""
    with span("norm"):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * scale + bias


# ---------------------------------------------------------------------------
# LayerNorm -> ReLU -> residual
# ---------------------------------------------------------------------------


class LayerNormPlan(NamedTuple):
    """How ``csrc/layer_norm.cu`` lays out a row of ``d`` elements: chunks
    of ``vec`` elements (16 bytes where the row is a multiple of 16 bytes,
    else 1), a group of ``2**lanes_log2`` lanes a row (8, 16 or 32), and
    ``chunks`` chunks a lane in registers (1, 2, 4 or 8, at most
    :data:`LN_VALUES_PER_LANE` values); ``chunks`` 0: the looped instance,
    a warp a row. From ``d`` and the dtype alone, so the forward, its
    recompute and the backward sum a row in the same order."""
    vec: int
    lanes_log2: int
    chunks: int


def layer_norm_plan(d: int, dtype: torch.dtype) -> LayerNormPlan:
    if not 1 <= d <= LN_LOOP_MAX_D:
        raise ValueError(f"layer_norm_relu_residual: no plan for rows of {d}")
    size = torch.finfo(dtype).bits // 8
    vec = 16 // size if (d * size) % 16 == 0 else 1
    per_row = d // vec
    lanes_log2 = 3
    while lanes_log2 < 5 and (1 << lanes_log2) < per_row:
        lanes_log2 += 1
    per_lane = -(-per_row // (1 << lanes_log2))
    for chunks in (1, 2, 4, 8):
        if chunks >= per_lane and chunks * vec <= LN_VALUES_PER_LANE:
            return LayerNormPlan(vec, lanes_log2, chunks)
    return LayerNormPlan(vec, 5, 0)


def layer_norm_relu_residual_plain(x, scale, bias, residual, eps: float = 1e-5):
    return torch.relu(masked_layer_norm(x, scale, bias, eps)) + residual


def layer_norm_relu_residual_bwd_plain(x, g, scale, bias, eps: float = 1e-5, keep=None):
    """The kernel's backward formula, op by op: ``(dx, [d_scale, d_bias])``
    with ``xh = (x - mean)·rstd``, ``gy = g·keep``, ``gx = gy·scale``,
    ``dx = rstd·(gx - mean(gx) - xh·mean(gx·xh))``, ``d_scale = Σ gy·xh``,
    ``d_bias = Σ gy`` over every row. ``keep``: the ReLU's mask, by default
    ``LN(x)·scale + bias > 0`` as x's dtype holds it. Computed in f32 (f64
    for f64 inputs); dx returned in x's dtype."""
    dtype = x.dtype
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    x, g, scale, bias = (t.to(wide) for t in (x, g, scale, bias))
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps)
    xh = (x - mean) * rstd
    if keep is None:
        keep = ~((xh * scale + bias).to(dtype) <= 0)
    gy = torch.where(keep, g, 0.0)
    gx = gy * scale
    dx = rstd * (gx - gx.mean(-1, keepdim=True) - xh * (gx * xh).mean(-1, keepdim=True))
    return dx.to(dtype), torch.stack([(gy * xh).sum(0), gy.sum(0)])


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def layer_norm_relu_residual_fwd(x, scale, bias, residual, eps: float = 1e-5):
    """``relu(LN(x)·scale + bias) + residual`` over the rows of ``x``
    ([R, D]; scale, bias [D]; residual [R, D]), all float32 or all
    bfloat16, with no gradient: the kernel on the card, the plain
    composition on the CPU. bf16 runs in f32 and rounds where the plain bf16
    chain's output rounds: the LayerNorm's output before the ReLU, then the
    sum with the residual."""
    if on_cpu(x, scale, bias, residual):
        return layer_norm_relu_residual_plain(x, scale, bias, residual, eps)
    kernel = entry(x.dtype, LAYER_NORM, LAYER_NORM_BF16)
    check_cuda_args(kernel.name, [x, scale, bias, residual], [], dtype=kernel.dtype)
    n_rows, d = x.shape
    if residual.shape != x.shape or scale.shape != (d,) or bias.shape != (d,):
        raise ValueError("layer_norm_relu_residual: shape mismatch")
    out = torch.empty_like(x)
    kernel(x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(), residual.data_ptr(),
           out.data_ptr(), n_rows, d, eps, *layer_norm_plan(d, x.dtype),
           int(_aligned(x, scale, bias, residual, out)))
    return out


def layer_norm_relu_residual_bwd(x, g, scale, bias, eps: float = 1e-5):
    """``(dx, d_affine)``: the gradient of :func:`layer_norm_relu_residual_fwd`
    for the cotangent ``g`` with respect to x (x's dtype) and
    ``[d_scale, d_bias]`` (f32 [2, D], summed over every row in a fixed
    order). The kernel recomputes the statistics and the ReLU mask from x
    as the forward computes them; on the CPU,
    :func:`layer_norm_relu_residual_bwd_plain`."""
    if on_cpu(x, g, scale, bias):
        return layer_norm_relu_residual_bwd_plain(x, g, scale, bias, eps)
    kernel = entry(x.dtype, LAYER_NORM_BWD, LAYER_NORM_BWD_BF16)
    check_cuda_args(kernel.name, [x, g, scale, bias], [], dtype=kernel.dtype)
    n_rows, d = x.shape
    if g.shape != x.shape or scale.shape != (d,) or bias.shape != (d,):
        raise ValueError("layer_norm_relu_residual_bwd: shape mismatch")
    max_parts = _LN_BLOCKS_PER_SM * torch.cuda.get_device_properties(
        x.device).multi_processor_count
    dx = torch.empty_like(x)
    partial = torch.empty((max_parts, 2, d), dtype=torch.float32, device=x.device)
    d_affine = torch.empty((2, d), dtype=torch.float32, device=x.device)
    kernel(x.device, x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
           dx.data_ptr(), partial.data_ptr(), d_affine.data_ptr(), n_rows, d, eps,
           *layer_norm_plan(d, x.dtype), int(_aligned(x, g, scale, bias, dx)), max_parts)
    return dx, d_affine


class LayerNormReluResidual(torch.autograd.Function):
    """:func:`layer_norm_relu_residual_fwd` with the kernel's backward.
    Saves x, scale and bias only (no statistics, no intermediate); the
    residual's gradient is the cotangent itself."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, eps: float):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return layer_norm_relu_residual_fwd(x, scale, bias, residual, eps)

    @staticmethod
    def backward(ctx, g):
        # outside the span: under remat the first read of a saved tensor of
        # the layer runs the layer's recompute, which is not the norm's
        x, scale, bias = ctx.saved_tensors
        with span("norm"):
            dx, d_affine = layer_norm_relu_residual_bwd(x, g.contiguous(), scale, bias,
                                                        ctx.eps)
            return dx, d_affine[0].to(scale.dtype), d_affine[1].to(bias.dtype), g, None


def layer_norm_relu_residual(x, scale, bias, residual, eps: float = 1e-5):
    """``relu(masked_layer_norm(x, scale, bias)) + residual``, differentiable:
    the LayerNorm branch's edge and node norms with their ReLU and residual
    (``models/gated_gcn.py``, ``parallel/sharded.py``). On the card the
    ``csrc/layer_norm.cu`` entries of x's dtype, forward and backward; on
    CPU tensors the plain composition under autograd."""
    with span("norm"):
        if on_cpu(x, scale, bias, residual):
            return layer_norm_relu_residual_plain(x, scale, bias, residual, eps)
        return LayerNormReluResidual.apply(x, scale, bias, residual, eps)
