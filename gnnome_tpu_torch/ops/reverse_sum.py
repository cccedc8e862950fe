"""GatedGCN reverse (by-source) σ-weighted aggregation.

Counterpart of ``gnnome_tpu/ops/spmm_pallas.py:fused_sigma_unsorted_pallas``
and ``fused_sigma_opposite_pallas``. The CUDA kernels are
``csrc/reverse_sum.cu``; the plain versions below are their CPU form and
their reference on the card. The backward of the first
(:class:`SigmaReverseSum`, the JAX ``_rev_unsorted_bwd``) runs
``csrc/rev_bwd.cu`` (``rev_bwd_pallas``; an edge-balanced walk over the
src-sorted positions, each edge's row read from ``by_src.segment_ids``) and
the by_dst segment sum; that of the second (:class:`SigmaOpposite`, the JAX
``_fused_opp_bwd``) runs the sorted-output entry of ``csrc/rev_bwd.cu``
(``opp_bwd_pallas``), two row gathers back to canonical order and the
by_dst segment sum.

The two compute one function; the opposite form reads each edge's dst id
contiguously from ``by_src.opp_ids`` and is the JAX package's route when
its TPU band plans exist. The model takes the first on every graph.

Under bf16 the first and its backward have their own entries: ``e_new``,
the values and the per-edge cotangents are bf16, the sums and ``g_sums``
f32; the forward rounds each summand, σ·v and σ, to bf16 before its f32
sum, as the TPU kernel does (``spmm_pallas.py:2358-2360``); the backward rounds the ``g_sums`` rows to bf16 before use (the JAX
VJP casts the cotangent to the edge dtype) and each cotangent once, as it
stores it (``gnnome_tpu/ops/segment.py:647-690``).
"""
from __future__ import annotations

import torch

from gnnome_tpu_torch.core.graph import CSR
from gnnome_tpu_torch.ops.cuda_lib import (
    I32, I64, P, Kernel, check_cuda_args, entry, on_cpu, register, vec_ok)
from gnnome_tpu_torch.ops.segment_sum import segment_sum
from gnnome_tpu_torch.ops.take import take_rows, take_rows_plain

SIGMA_REVERSE_SUM = register(Kernel(
    "sigma_reverse_sum", "gnnome_sigma_reverse_sum_f32",
    [P, P, P, P, P, P, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/reverse_sum.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:2446 fused_sigma_unsorted_pallas"))
SIGMA_REVERSE_SUM_BF16 = register(Kernel(
    "sigma_reverse_sum_bf16", "gnnome_sigma_reverse_sum_bf16",
    [P, P, P, P, P, P, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/reverse_sum.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:2446 fused_sigma_unsorted_pallas",
    dtype=torch.bfloat16))
REV_BWD = register(Kernel(
    "rev_bwd", "gnnome_rev_bwd_f32", [P, P, P, P, P, P, P, P, I64, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/rev_bwd.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:1746 rev_bwd_pallas"))
REV_BWD_BF16 = register(Kernel(
    "rev_bwd_bf16", "gnnome_rev_bwd_bf16", [P, P, P, P, P, P, P, P, I64, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/rev_bwd.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:1746 rev_bwd_pallas", dtype=torch.bfloat16))
SIGMA_OPPOSITE = register(Kernel(
    "sigma_opposite", "gnnome_sigma_opposite_f32",
    [P, P, P, P, P, P, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/reverse_sum.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:2145 fused_sigma_opposite_pallas"))
OPP_BWD = register(Kernel(
    "opp_bwd", "gnnome_opp_bwd_f32", [P, P, P, P, P, P, P, P, I64, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/rev_bwd.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:1920 opp_bwd_pallas"))


def sigma_reverse_sum_plain(e_new, values, by_src: CSR, dst):
    n, d = by_src.offsets.shape[0] - 1, values.shape[1]
    dt, f32 = e_new.dtype, torch.float32
    sigma = torch.sigmoid(e_new.to(f32))
    sv = sigma * values[dst].to(f32)
    if dt != f32:  # the summands rounded to the data dtype, as the TPU kernel
        sv, sigma = sv.to(dt).to(f32), sigma.to(dt).to(f32)
    stacked = torch.cat([sv, sigma], dim=-1)
    valid = by_src.key < n
    sums = torch.zeros((n, 2 * d), dtype=f32, device=values.device)
    sums.index_add_(0, by_src.key[valid], stacked[valid])
    return sums


def sigma_reverse_sum(e_new: torch.Tensor, values: torch.Tensor,
                      by_src: CSR, dst: torch.Tensor) -> torch.Tensor:
    """Per source node ``[Σ σ(e_new)·values[dst] ‖ Σ σ(e_new)]`` (f32
    [N, 2D], ``N = len(by_src.offsets) - 1``) over its out-edges. ``e_new``
    and ``dst`` are in canonical order; padded edges (key ``PAD_SEGMENT``)
    join no sum. ``values`` may have any row count that ``dst`` indexes: the
    sharded layer keys its edges on a combined [N_local + P·H] table
    (``parallel/sharded.py``) and reads ``N_local`` value rows. float32 or
    bfloat16 ``e_new`` and ``values``."""
    if by_src.identity:
        raise ValueError("sigma_reverse_sum needs the by_src layout")
    if on_cpu(e_new, values, by_src.key, by_src.offsets, by_src.order, dst):
        return sigma_reverse_sum_plain(e_new, values, by_src, dst)
    kernel = entry(e_new.dtype, SIGMA_REVERSE_SUM, SIGMA_REVERSE_SUM_BF16)
    check_cuda_args(kernel.name, [e_new, values], [by_src.offsets, by_src.order, dst],
                    dtype=kernel.dtype)
    # n sizes the sums (the CSR's rows); the kernel does not bound dst
    n, d = by_src.offsets.shape[0] - 1, values.shape[1]
    if e_new.shape[1] != d:
        raise ValueError("sigma_reverse_sum: shape mismatch")
    sums = torch.empty((n, 2 * d), dtype=torch.float32, device=e_new.device)
    kernel(e_new.device, e_new.data_ptr(), values.data_ptr(), by_src.offsets.data_ptr(),
           by_src.order.data_ptr(), dst.data_ptr(), sums.data_ptr(), n, d,
           int(vec_ok(d, e_new, values, sums)))
    return sums


def rev_bwd_plain(e_new, g_sums, values, by_src: CSR, dst):
    d, dt, f32 = values.shape[1], e_new.dtype, torch.float32
    # zero rows on padded edges; the cotangent rounded to the edge dtype
    gc = take_rows_plain(g_sums.to(dt), by_src.key).to(f32)
    g1, g2 = gc[:, :d], gc[:, d:]
    sig = torch.sigmoid(e_new.to(f32))
    return (((g1 * values[dst].to(f32) + g2) * (sig * (1.0 - sig))).to(dt),
            (g1 * sig).to(dt))


def rev_bwd(e_new: torch.Tensor, g_sums: torch.Tensor, values: torch.Tensor,
            by_src: CSR, dst: torch.Tensor):
    """``(d_e_new, d_v_rows)`` per canonical edge ([E, D] each), the
    cotangents of :func:`sigma_reverse_sum`'s inputs given ``g_sums``
    ([N, 2D]); ``d_v_rows``'s by_dst segment sum is ``d_values``. Zero on
    padded edges. bfloat16 ``e_new`` and ``values`` take an f32 ``g_sums``,
    rounded to bf16 as it is used, and give bf16 cotangents."""
    if by_src.identity:
        raise ValueError("rev_bwd needs the by_src layout")
    if on_cpu(e_new, g_sums, values, by_src.key, by_src.offsets, by_src.order, dst):
        return rev_bwd_plain(e_new, g_sums, values, by_src, dst)
    kernel = entry(e_new.dtype, REV_BWD, REV_BWD_BF16)
    check_cuda_args(kernel.name, [e_new, values], [by_src.segment_ids, by_src.order, dst],
                    dtype=kernel.dtype, f32=[g_sums])
    # n bounds the CSR's rows (a padded position's segment id is past it)
    n, d = by_src.offsets.shape[0] - 1, values.shape[1]
    n_rows = e_new.shape[0]
    if e_new.shape[1] != d or g_sums.shape != (n, 2 * d) \
            or by_src.segment_ids.shape != (n_rows,):
        raise ValueError("rev_bwd: shape mismatch")
    d_e_new, d_v_rows = torch.empty_like(e_new), torch.empty_like(e_new)
    kernel(e_new.device, e_new.data_ptr(), g_sums.data_ptr(), values.data_ptr(),
           by_src.segment_ids.data_ptr(), by_src.order.data_ptr(), dst.data_ptr(),
           d_e_new.data_ptr(), d_v_rows.data_ptr(), n, n_rows, d,
           int(vec_ok(d, e_new, g_sums, values, d_e_new, d_v_rows)))
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
        d_values = segment_sum(d_v_rows, ctx.by_dst).to(values.dtype) \
            if ctx.needs_input_grad[1] else None
        return d_e_new, d_values, None, None, None


def _sorted_parts(csr: CSR):
    if csr.identity or csr.opp_ids is None:
        raise ValueError("the opposite aggregation needs the by_src layout "
                         "with opp_ids (core/graph.py:build_graph)")
    return csr.order, csr.opp_ids


def sigma_opposite_plain(e_new, values, csr: CSR):
    order, opp_ids = _sorted_parts(csr)
    n, d = csr.offsets.shape[0] - 1, values.shape[1]
    sigma = torch.sigmoid(e_new[order])
    stacked = torch.cat([sigma * values[opp_ids], sigma], dim=-1)
    valid = csr.segment_ids < n
    sums = torch.zeros((n, 2 * d), dtype=torch.float32, device=values.device)
    return sums.index_add_(0, csr.segment_ids[valid], stacked[valid])


def sigma_opposite(e_new: torch.Tensor, values: torch.Tensor, csr: CSR) -> torch.Tensor:
    """:func:`sigma_reverse_sum` with the dst ids read in src-sorted order:
    per source node ``[Σ σ(e_new[order])·values[opp_ids] ‖ Σ σ]`` (f32
    [N, 2D]); ``e_new`` is in canonical order."""
    order, opp_ids = _sorted_parts(csr)
    if on_cpu(e_new, values, csr.segment_ids, csr.offsets, order, opp_ids):
        return sigma_opposite_plain(e_new, values, csr)
    check_cuda_args("sigma_opposite", [e_new, values], [csr.offsets, order, opp_ids])
    n, d = values.shape
    if csr.offsets.shape[0] != n + 1 or e_new.shape[1] != d:
        raise ValueError("sigma_opposite: shape mismatch")
    sums = torch.empty((n, 2 * d), dtype=torch.float32, device=e_new.device)
    SIGMA_OPPOSITE(e_new.device, e_new.data_ptr(), values.data_ptr(),
                   csr.offsets.data_ptr(), order.data_ptr(), opp_ids.data_ptr(),
                   sums.data_ptr(), n, d, int(vec_ok(d, e_new, values, sums)))
    return sums


def opp_bwd_plain(e_new, g_sums, values, csr: CSR):
    order, opp_ids = _sorted_parts(csr)
    d = values.shape[1]
    gc = take_rows_plain(g_sums, csr.segment_ids)  # zero rows on padded edges
    g1, g2 = gc[:, :d], gc[:, d:]
    sig = torch.sigmoid(e_new[order])
    return (g1 * values[opp_ids] + g2) * (sig * (1.0 - sig)), g1 * sig


def opp_bwd(e_new: torch.Tensor, g_sums: torch.Tensor, values: torch.Tensor, csr: CSR):
    """``(d_e_sorted, d_v_sorted)`` ([E, D] each, in ``csr``'s sorted
    order, as ``opp_bwd_pallas`` returns them): the cotangents of
    :func:`sigma_opposite`'s per-edge inputs given ``g_sums`` ([N, 2D]).
    Zero on padded edges."""
    order, opp_ids = _sorted_parts(csr)
    if on_cpu(e_new, g_sums, values, csr.segment_ids, csr.offsets, order, opp_ids):
        return opp_bwd_plain(e_new, g_sums, values, csr)
    check_cuda_args("opp_bwd", [e_new, g_sums, values], [csr.segment_ids, order, opp_ids])
    n, d = values.shape
    n_rows = e_new.shape[0]
    if csr.offsets.shape[0] != n + 1 or e_new.shape[1] != d \
            or g_sums.shape != (n, 2 * d) or csr.segment_ids.shape != (n_rows,):
        raise ValueError("opp_bwd: shape mismatch")
    d_e, d_v = torch.empty_like(e_new), torch.empty_like(e_new)
    OPP_BWD(e_new.device, e_new.data_ptr(), g_sums.data_ptr(), values.data_ptr(),
            csr.segment_ids.data_ptr(), order.data_ptr(), opp_ids.data_ptr(),
            d_e.data_ptr(), d_v.data_ptr(), n, n_rows, d,
            int(vec_ok(d, e_new, g_sums, values, d_e, d_v)))
    return d_e, d_v


class SigmaOpposite(torch.autograd.Function):
    """:func:`sigma_opposite` with the gradient of the JAX
    ``_fused_sigma_opposite`` (``gnnome_tpu/ops/segment.py:450-535``):
    :func:`opp_bwd` in sorted order, both outputs taken back to canonical
    order through ``inv_order`` (a permutation, as row gathers), then the
    segment sum of the value cotangent over ``by_opp`` (the by_dst CSR).
    Arguments in the JAX order ``(values, gate_pre, csr, by_opp)``; saves
    ``(values, gate_pre)``."""

    @staticmethod
    def forward(ctx, values, gate_pre, csr: CSR, by_opp: CSR):
        ctx.save_for_backward(values, gate_pre)
        ctx.csr, ctx.by_opp = csr, by_opp
        return sigma_opposite(gate_pre, values, csr)

    @staticmethod
    def backward(ctx, g):
        values, gate_pre = ctx.saved_tensors
        d_e_s, d_v_s = opp_bwd(gate_pre, g.contiguous(), values, ctx.csr)
        inv = ctx.csr.inv_order
        d_gate_pre = take_rows(d_e_s, inv)
        d_values = segment_sum(take_rows(d_v_s, inv), ctx.by_opp) \
            if ctx.needs_input_grad[0] else None
        return d_values, d_gate_pre, None, None
