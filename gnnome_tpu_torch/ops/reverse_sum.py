"""GatedGCN reverse (by-source) σ-weighted aggregation.

Counterpart of ``gnnome_tpu/ops/spmm_pallas.py:fused_sigma_unsorted_pallas``.
The CUDA kernel is ``csrc/reverse_sum.cu``; the plain version below is its
CPU form and its reference on the card.
"""
from __future__ import annotations

import torch

from gnnome_tpu_torch.core.graph import CSR
from gnnome_tpu_torch.ops.cuda_lib import (
    I32, I64, P, Kernel, check_cuda_args, on_cpu, register, vec4_ok)

SIGMA_REVERSE_SUM = register(Kernel(
    "sigma_reverse_sum", "gnnome_sigma_reverse_sum_f32",
    [P, P, P, P, P, P, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/reverse_sum.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:2446 fused_sigma_unsorted_pallas"))


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
