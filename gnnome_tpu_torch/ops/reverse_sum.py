"""GatedGCN reverse (by-source) σ-weighted aggregation.

Counterpart of ``gnnome_tpu/ops/spmm_pallas.py:fused_sigma_unsorted_pallas``.
The CUDA kernel is ``csrc/reverse_sum.cu``; the plain version below is its
CPU form and its reference on the card. Its backward
(:class:`SigmaReverseSum`, the JAX ``_rev_unsorted_bwd``) runs
``csrc/rev_bwd.cu`` (``rev_bwd_pallas``) and the by_dst segment sum.
"""
from __future__ import annotations

import torch

from gnnome_tpu_torch.core.graph import CSR
from gnnome_tpu_torch.ops.cuda_lib import (
    I32, I64, P, Kernel, check_cuda_args, on_cpu, register, vec4_ok)
from gnnome_tpu_torch.ops.segment_sum import segment_sum
from gnnome_tpu_torch.ops.take import take_rows_plain

SIGMA_REVERSE_SUM = register(Kernel(
    "sigma_reverse_sum", "gnnome_sigma_reverse_sum_f32",
    [P, P, P, P, P, P, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/reverse_sum.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:2446 fused_sigma_unsorted_pallas"))
REV_BWD = register(Kernel(
    "rev_bwd", "gnnome_rev_bwd_f32", [P, P, P, P, P, P, P, P, I64, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/rev_bwd.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:1746 rev_bwd_pallas"))


def sigma_reverse_sum_plain(e_new, values, by_src: CSR, dst):
    n, d = values.shape
    sigma = torch.sigmoid(e_new)
    stacked = torch.cat([sigma * values[dst], sigma], dim=-1)
    valid = by_src.key < n
    sums = torch.zeros((n, 2 * d), dtype=torch.float32, device=values.device)
    sums.index_add_(0, by_src.key[valid], stacked[valid])
    return sums


def sigma_reverse_sum(e_new: torch.Tensor, values: torch.Tensor,
                      by_src: CSR, dst: torch.Tensor) -> torch.Tensor:
    """Per source node ``[Σ σ(e_new)·values[dst] ‖ Σ σ(e_new)]`` (f32
    [N, 2D]) over its out-edges. ``e_new`` and ``dst`` are in canonical
    order; padded edges (key ``PAD_SEGMENT``) join no sum."""
    if by_src.identity:
        raise ValueError("sigma_reverse_sum needs the by_src layout")
    if on_cpu(e_new, values, by_src.key, by_src.offsets, by_src.order, dst):
        return sigma_reverse_sum_plain(e_new, values, by_src, dst)
    check_cuda_args("sigma_reverse_sum", [e_new, values],
                    [by_src.offsets, by_src.order, dst])
    n, d = values.shape
    if by_src.offsets.shape[0] != n + 1 or e_new.shape[1] != d:
        raise ValueError("sigma_reverse_sum: shape mismatch")
    sums = torch.empty((n, 2 * d), dtype=torch.float32, device=e_new.device)
    vec4 = vec4_ok(d, e_new, values, sums)
    SIGMA_REVERSE_SUM(e_new.device, e_new.data_ptr(), values.data_ptr(),
                      by_src.offsets.data_ptr(), by_src.order.data_ptr(),
                      dst.data_ptr(), sums.data_ptr(), n, d, int(vec4))
    return sums


def rev_bwd_plain(e_new, g_sums, values, by_src: CSR, dst):
    d = values.shape[1]
    gc = take_rows_plain(g_sums, by_src.key)  # zero rows on padded edges
    g1, g2 = gc[:, :d], gc[:, d:]
    sig = torch.sigmoid(e_new)
    return (g1 * values[dst] + g2) * (sig * (1.0 - sig)), g1 * sig


def rev_bwd(e_new: torch.Tensor, g_sums: torch.Tensor, values: torch.Tensor,
            by_src: CSR, dst: torch.Tensor):
    """``(d_e_new, d_v_rows)`` per canonical edge ([E, D] each), the
    cotangents of :func:`sigma_reverse_sum`'s inputs given ``g_sums``
    ([N, 2D]); ``d_v_rows``'s by_dst segment sum is ``d_values``. Zero on
    padded edges."""
    if by_src.identity:
        raise ValueError("rev_bwd needs the by_src layout")
    if on_cpu(e_new, g_sums, values, by_src.key, by_src.offsets, by_src.order, dst):
        return rev_bwd_plain(e_new, g_sums, values, by_src, dst)
    check_cuda_args("rev_bwd", [e_new, g_sums, values],
                    [by_src.offsets, by_src.order, dst])
    n, d = values.shape
    n_rows = e_new.shape[0]
    if by_src.offsets.shape[0] != n + 1 or e_new.shape[1] != d \
            or g_sums.shape != (n, 2 * d):
        raise ValueError("rev_bwd: shape mismatch")
    d_e_new, d_v_rows = torch.empty_like(e_new), torch.empty_like(e_new)
    vec4 = vec4_ok(d, e_new, g_sums, values, d_e_new, d_v_rows)
    REV_BWD(e_new.device, e_new.data_ptr(), g_sums.data_ptr(), values.data_ptr(),
            by_src.offsets.data_ptr(), by_src.order.data_ptr(), dst.data_ptr(),
            d_e_new.data_ptr(), d_v_rows.data_ptr(), n, n_rows, d, int(vec4))
    return d_e_new, d_v_rows


class SigmaReverseSum(torch.autograd.Function):
    """:func:`sigma_reverse_sum` with the gradient of the JAX
    ``_fused_sigma_reverse_unsorted`` (``gnnome_tpu/ops/segment.py:649-695``).
    Saves ``(e_new, values)``."""

    @staticmethod
    def forward(ctx, e_new, values, by_src: CSR, dst, by_dst: CSR):
        ctx.save_for_backward(e_new, values)
        ctx.by_src, ctx.dst, ctx.by_dst = by_src, dst, by_dst
        return sigma_reverse_sum(e_new, values, by_src, dst)

    @staticmethod
    def backward(ctx, g):
        e_new, values = ctx.saved_tensors
        d_e_new, d_v_rows = rev_bwd(e_new, g.contiguous(), values, ctx.by_src, ctx.dst)
        d_values = segment_sum(d_v_rows, ctx.by_dst) if ctx.needs_input_grad[1] else None
        return d_e_new, d_values, None, None, None
