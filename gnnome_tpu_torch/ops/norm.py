"""Masked normalization layers (counterpart of ``gnnome_tpu/ops/norm.py``).

The reference uses ``nn.BatchNorm1d(..., track_running_stats=False)``
(``layers/gated_gcn_full.py:55-56``): statistics come from the current
batch in train and eval mode alike. Rows may be padded, so the moments are
taken over valid rows only, always in f32.

Where the rows are sharded over ranks (``parallel/sharded.py``), a process
group takes the place of JAX's ``axis_name``: the count, Σx and Σx² are
all-reduced over it in f32 (one differentiable all-reduce), so every rank
sees the statistics of the whole row set.

Each node norm takes its ReLU and the residual add that follow it as one
function: :func:`layer_norm_relu_residual` (``relu(LN(x)·scale + bias) +
residual``, the LayerNorm branch's edge norm too) and
:func:`batch_norm_relu_residual` (``relu(masked_batch_norm(x)) +
residual``). On the card they run the kernels of ``csrc/layer_norm.cu`` and
``csrc/batch_norm.cu``, forward and backward; on CPU tensors, the plain
composition. The JAX package has no kernel here (XLA fuses its
``masked_layer_norm`` and ``masked_batch_norm``, ``gnnome_tpu/ops/norm.py:58``
and ``:43``, with what surrounds them).

Each function runs inside a ``norm`` span (``utils/profiling.py``), the
backwards of the two fused ones too.
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


# ---------------------------------------------------------------------------
# BatchNorm -> ReLU -> residual
# ---------------------------------------------------------------------------

_BN_PLAN = [I32, I32, I32, I32]  # vec, lanes_log2, chunks, aligned


def _bn_entries(name: str, argtypes) -> tuple:
    """The f32 and bf16 entries ``name`` and ``name_bf16`` of
    ``csrc/batch_norm.cu``."""
    return tuple(register(Kernel(
        name + tail, f"gnnome_{name}_{sym}", argtypes,
        source="gnnome_tpu_torch/csrc/batch_norm.cu",
        replaces="none: XLA fuses gnnome_tpu/ops/norm.py:43 masked_batch_norm", dtype=dtype))
        for tail, sym, dtype in (("", "f32", torch.float32), ("_bf16", "bf16", torch.bfloat16)))


BN_MOMENTS, BN_MOMENTS_BF16 = _bn_entries("batch_norm_moments",
                                          [P, P, P, P, I64, I32, *_BN_PLAN, I32])
BATCH_NORM, BATCH_NORM_BF16 = _bn_entries("batch_norm_relu_residual",
                                          [P, P, P, P, P, P, I64, I32, F32, *_BN_PLAN])
BATCH_NORM_BWD_SUMS, BATCH_NORM_BWD_SUMS_BF16 = _bn_entries(
    "batch_norm_relu_residual_bwd_sums", [P, P, P, P, P, P, P, I64, I32, F32, *_BN_PLAN, I32])
BATCH_NORM_BWD, BATCH_NORM_BWD_BF16 = _bn_entries(
    "batch_norm_relu_residual_bwd", [P, P, P, P, P, P, P, P, I64, I32, F32, *_BN_PLAN])

# threads of a block of csrc/batch_norm.cu; at most this many values of a
# row a lane (the chunks of a lane times their elements)
BN_THREADS = 256
BN_VALUES_PER_LANE = 16
# partial rows of the column sums: at most 8 blocks an SM
_BN_BLOCKS_PER_SM = 8


class BatchNormPlan(NamedTuple):
    """How ``csrc/batch_norm.cu`` lays out the columns of a row of ``d``
    elements: chunks of ``vec`` elements (4 where ``d`` is a multiple of 4:
    16-byte accesses in f32, 8-byte in bf16; else 1), a group of
    ``2**lanes_log2`` lanes a row (1 to 256: :data:`BN_THREADS` / lanes
    rows of a block at once), and
    ``chunks`` chunks a lane (1, 2 or 4, at most :data:`BN_VALUES_PER_LANE`
    values), lane ``l`` holding chunks ``l``, ``l + lanes``, ... of its
    column tile. Rows wider than a tile (``lanes·chunks`` chunks) take
    several tiles, one a block column. From ``d`` alone, so forward,
    recompute and backward sum in one order."""
    vec: int
    lanes_log2: int
    chunks: int


def batch_norm_plan(d: int) -> BatchNormPlan:
    if d < 1:
        raise ValueError(f"batch_norm_relu_residual: no plan for rows of {d}")
    vec = 4 if d % 4 == 0 else 1
    per_row = d // vec
    lanes_log2 = 0
    while (1 << lanes_log2) < min(per_row, BN_THREADS):
        lanes_log2 += 1
    fits = [c for c in (1, 2, 4) if c * vec <= BN_VALUES_PER_LANE]
    chunks = next((c for c in fits if c << lanes_log2 >= per_row), fits[-1])
    return BatchNormPlan(vec, lanes_log2, chunks)


def batch_norm_relu_residual_plain(x, mask, scale, bias, residual, eps: float = 1e-5,
                                   group=None):
    return torch.relu(masked_batch_norm(x, mask, scale, bias, eps, group)) + residual


def batch_norm_moments_plain(x, mask, group=None):
    """``[count, Σx·m, Σx²·m]`` in f32 over the rows where ``mask`` (of
    every rank of ``group``), as :func:`masked_moments` sums them."""
    x = x.to(torch.float32)
    m = mask.to(torch.float32)[:, None]
    return all_reduce_sum(torch.cat([m.sum()[None], (x * m).sum(0), (x * x * m).sum(0)]),
                          group)


def batch_norm_relu_residual_bwd_plain(x, g, mask, scale, bias, eps: float = 1e-5,
                                       keep=None):
    """The kernels' backward formula, op by op: ``(dx, [d_scale, d_bias])``
    with the statistics of the rows where ``mask`` (n of them, mean, var),
    ``xh = (x - mean)·rstd``, ``gy = g·keep``, ``d_scale = Σ gy·xh`` and
    ``d_bias = Σ gy`` over every row (padded rows too), ``A = scale·d_bias``,
    ``B = scale·d_scale`` (0 where the variance was clamped at 0) and
    ``dx = rstd·(gy·scale) − m·(rstd/n)·(A + xh·B)``. ``keep``: the ReLU's
    mask, by default ``BN(x)·scale + bias > 0`` as x's dtype holds it.
    Computed in f32 (f64 for f64 inputs); dx returned in x's dtype."""
    dtype = x.dtype
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    x, g, scale, bias = (t.to(wide) for t in (x, g, scale, bias))
    m = mask.to(wide)[:, None]
    n = torch.clamp(m.sum(), min=1.0)
    mean = (x * m).sum(0) / n
    var_raw = (x * x * m).sum(0) / n - mean * mean
    rstd = torch.rsqrt(torch.clamp(var_raw, min=0.0) + eps)
    xh = (x - mean) * rstd
    if keep is None:
        keep = ~((xh * scale + bias).to(dtype) <= 0)
    gy = torch.where(keep, g, 0.0)
    d_scale, d_bias = (gy * xh).sum(0), gy.sum(0)
    a = scale * d_bias
    b = torch.where(var_raw < 0, 0.0, scale * d_scale)
    dx = rstd * (gy * scale) - m * (rstd / n) * (a + xh * b)
    return dx.to(dtype), torch.stack([d_scale, d_bias])


def _check_bn_args(kernel, x, mask, floats, f32):
    check_cuda_args(kernel.name, [x, *floats], [], dtype=kernel.dtype, f32=f32)
    n_rows, d = x.shape
    if any(t.shape != x.shape for t in floats if t.dim() == 2) or any(
            t.shape != (d,) for t in floats if t.dim() == 1):
        raise ValueError(f"{kernel.name}: shape mismatch")
    if mask.dtype != torch.bool or mask.shape != (n_rows,) or not mask.is_contiguous():
        raise ValueError(f"{kernel.name}: needs a contiguous bool mask of {n_rows} rows")


def _bn_max_parts(x) -> int:
    return _BN_BLOCKS_PER_SM * torch.cuda.get_device_properties(
        x.device).multi_processor_count


# the four entries, one launch each (CUDA tensors, checked by the callers)


def batch_norm_moments(x, mask):
    """``[count | Σx·m | Σx²·m]`` (f32 [1 + 2D]) over the rows of ``x``
    where ``mask``: the forward's first kernel."""
    kernel = entry(x.dtype, BN_MOMENTS, BN_MOMENTS_BF16)
    n_rows, d = x.shape
    max_parts = _bn_max_parts(x)
    partial = torch.empty((max_parts, 1 + 2 * d), dtype=torch.float32, device=x.device)
    sums = torch.empty(1 + 2 * d, dtype=torch.float32, device=x.device)
    kernel(x.device, x.data_ptr(), mask.data_ptr(), partial.data_ptr(), sums.data_ptr(),
           n_rows, d, *batch_norm_plan(d), int(_aligned(x)), max_parts)
    return sums


def batch_norm_apply(x, sums, scale, bias, residual, eps: float = 1e-5):
    """``relu(BN(x)·scale + bias) + residual`` over every row, the statistics
    from ``sums``: the forward's second kernel."""
    kernel = entry(x.dtype, BATCH_NORM, BATCH_NORM_BF16)
    n_rows, d = x.shape
    out = torch.empty_like(x)
    kernel(x.device, x.data_ptr(), sums.data_ptr(), scale.data_ptr(), bias.data_ptr(),
           residual.data_ptr(), out.data_ptr(), n_rows, d, eps, *batch_norm_plan(d),
           int(_aligned(x, scale, bias, residual, out)))
    return out


def batch_norm_bwd_sums(x, g, sums, scale, bias, eps: float = 1e-5):
    """``[Σ gy·xh | Σ gy]`` (f32 [2, D]) over every row: the backward's
    first kernel."""
    kernel = entry(x.dtype, BATCH_NORM_BWD_SUMS, BATCH_NORM_BWD_SUMS_BF16)
    n_rows, d = x.shape
    max_parts = _bn_max_parts(x)
    partial = torch.empty((max_parts, 2 * d), dtype=torch.float32, device=x.device)
    d_affine = torch.empty((2, d), dtype=torch.float32, device=x.device)
    kernel(x.device, x.data_ptr(), g.data_ptr(), sums.data_ptr(), scale.data_ptr(),
           bias.data_ptr(), partial.data_ptr(), d_affine.data_ptr(), n_rows, d, eps,
           *batch_norm_plan(d), int(_aligned(x, g, scale, bias)), max_parts)
    return d_affine


def batch_norm_bwd_dx(x, g, mask, sums, scale, bias, total, eps: float = 1e-5):
    """dx over every row from the column sums ``total`` (all-reduced where
    the rows are sharded): the backward's second kernel."""
    kernel = entry(x.dtype, BATCH_NORM_BWD, BATCH_NORM_BWD_BF16)
    n_rows, d = x.shape
    dx = torch.empty_like(x)
    kernel(x.device, x.data_ptr(), g.data_ptr(), mask.data_ptr(), sums.data_ptr(),
           scale.data_ptr(), bias.data_ptr(), total.data_ptr(), dx.data_ptr(), n_rows, d, eps,
           *batch_norm_plan(d), int(_aligned(x, g, scale, bias, dx)))
    return dx


def batch_norm_relu_residual_fwd(x, mask, scale, bias, residual, eps: float = 1e-5,
                                 group=None):
    """``(out, sums)``: ``out = relu(masked_batch_norm(x, mask, scale, bias)) +
    residual`` over the rows of ``x`` ([R, D]; mask bool [R]; scale, bias
    [D]; residual [R, D]; all float32 or all bfloat16) with no gradient, and
    ``sums = [count, Σx·m, Σx²·m]`` (f32 [1 + 2D], all-reduced over
    ``group``), from which the statistics come. On the card two kernels:
    the column sums over the real rows (the all-reduce between the two
    launches where ``group`` is given), then the normalisation, the ReLU and
    the residual; on the CPU the plain composition. bf16 runs in f32 and
    rounds where the plain bf16 chain's output rounds: the BatchNorm's
    output, then the sum with the residual."""
    if on_cpu(x, mask, scale, bias, residual):
        return (batch_norm_relu_residual_plain(x, mask, scale, bias, residual, eps, group),
                batch_norm_moments_plain(x, mask, group))
    kernel = entry(x.dtype, BATCH_NORM, BATCH_NORM_BF16)
    _check_bn_args(kernel, x, mask, [scale, bias, residual], [])
    sums = all_reduce_sum(batch_norm_moments(x, mask), group)
    return batch_norm_apply(x, sums, scale, bias, residual, eps), sums


def batch_norm_relu_residual_bwd(x, g, mask, sums, scale, bias, eps: float = 1e-5,
                                 group=None):
    """``(dx, d_affine)``: the gradient of :func:`batch_norm_relu_residual_fwd`
    for the cotangent ``g`` with respect to x (x's dtype) and ``[d_scale,
    d_bias]`` (f32 [2, D], this rank's rows summed in a fixed order), from
    the forward's ``sums``. On the card two kernels: the column sums, whose
    copy is all-reduced over ``group`` where one is given, then dx; each
    recomputes the normalisation and the ReLU mask as the forward computes
    them. On the CPU, :func:`batch_norm_relu_residual_bwd_plain` (one
    process: ``group`` must be None)."""
    if on_cpu(x, g, mask, sums, scale, bias):
        if group is not None:
            raise ValueError("batch_norm_relu_residual_bwd: no process group on the CPU")
        return batch_norm_relu_residual_bwd_plain(x, g, mask, scale, bias, eps)
    kernel = entry(x.dtype, BATCH_NORM_BWD, BATCH_NORM_BWD_BF16)
    _check_bn_args(kernel, x, mask, [g, scale, bias], [sums])
    d = x.shape[1]
    if sums.shape != (1 + 2 * d,):
        raise ValueError(f"{kernel.name}: sums of {tuple(sums.shape)}, want ({1 + 2 * d},)")
    d_affine = batch_norm_bwd_sums(x, g, sums, scale, bias, eps)
    total = all_reduce_sum(d_affine, group)
    return batch_norm_bwd_dx(x, g, mask, sums, scale, bias, total, eps), d_affine


class BatchNormReluResidual(torch.autograd.Function):
    """:func:`batch_norm_relu_residual_fwd` with the kernels' backward.
    Saves x, the mask, scale, bias and the f32 sums only (no [R, D]
    intermediate); the residual's gradient is the cotangent itself."""

    @staticmethod
    def forward(ctx, x, mask, scale, bias, residual, eps: float, group):
        out, sums = batch_norm_relu_residual_fwd(x, mask, scale, bias, residual, eps, group)
        ctx.save_for_backward(x, mask, scale, bias, sums)
        ctx.eps, ctx.group = eps, group
        return out

    @staticmethod
    def backward(ctx, g):
        # outside the span: under remat the first read of a saved tensor of
        # the layer runs the layer's recompute, which is not the norm's
        x, mask, scale, bias, sums = ctx.saved_tensors
        with span("norm"):
            dx, d_affine = batch_norm_relu_residual_bwd(x, g.contiguous(), mask, sums, scale,
                                                        bias, ctx.eps, ctx.group)
            return (dx, None, d_affine[0].to(scale.dtype), d_affine[1].to(bias.dtype), g,
                    None, None)


def batch_norm_relu_residual(x, mask, scale, bias, residual, eps: float = 1e-5, group=None):
    """``relu(masked_batch_norm(x, mask, scale, bias)) + residual``,
    differentiable: the BatchNorm branch's node norm with its ReLU and
    residual (``models/gated_gcn.py``, ``parallel/sharded.py``); ``group``:
    the process group the rows are sharded over. On the card the
    ``csrc/batch_norm.cu`` entries of x's dtype, forward and backward; on
    CPU tensors the plain composition under autograd."""
    with span("norm"):
        if on_cpu(x, mask, scale, bias, residual):
            return batch_norm_relu_residual_plain(x, mask, scale, bias, residual, eps, group)
        return BatchNormReluResidual.apply(x, mask, scale, bias, residual, eps, group)
