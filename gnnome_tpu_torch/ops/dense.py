"""Dense products whose weight gradient keeps an f32 result under bf16.

JAX takes a bf16 model's weight gradients with an f32 accumulator and
rounds them once: ``d_W3 = jnp.dot(e.T, d_total,
preferred_element_type=float32)`` (``gnnome_tpu/ops/segment.py:973-974``),
and the MXU sums a bf16 ``linear``'s transposed product in f32 before its
one rounding. A bf16-output cuBLAS product of the same operands on the H100
is further off: over one bf16 BatchNorm step of the 16-layer, D = 256 model
on the 150k / 1M bench graph, 257,036 of the ``linear`` weight gradients'
5.2M elements lie more than one bf16 ulp from the f64 product rounded once,
against 426 for the f32-result product (``scripts/torch_wgrad_check.py``,
H100 80GB HBM3, 700 W). So :func:`weight_grad` asks for an f32 result
(``torch.mm(..., out_dtype=torch.float32)``) and rounds once; PyTorch's
process-wide reduced-precision flags are left as the caller set them.
float32 products are PyTorch's own, unchanged.
"""
from __future__ import annotations

import torch


def weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``xᵀ·g`` ([K, M]ᵀ·[K, N]), the weight gradient of ``x @ w``: for
    bf16 operands an f32 result rounded once to bf16 (on the CPU, which has
    no such kernel, the f32 product of the bf16 values, rounded once)."""
    if x.dtype == torch.float32:
        return x.T @ g
    if x.is_cuda:
        return torch.mm(x.t(), g, out_dtype=torch.float32).to(x.dtype)
    return (x.to(torch.float32).T @ g.to(torch.float32)).to(x.dtype)


class _LowPrecisionProduct(torch.autograd.Function):
    """``x @ w`` whose ``d_w`` is :func:`weight_grad`; ``d_x = g·wᵀ`` in the
    data dtype, as autograd's own."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d_x = g @ w.T if ctx.needs_input_grad[0] else None
        d_w = weight_grad(x, g) if ctx.needs_input_grad[1] else None
        return d_x, d_w


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` ([M, K]·[K, N]); for bf16 operands the weight gradient is
    :func:`weight_grad`'s."""
    if x.dtype == torch.float32:
        return x @ w
    return _LowPrecisionProduct.apply(x, w)
