"""Segment sum of canonical-order edge rows into node rows along a CSR.

Counterpart of ``gnnome_tpu/ops/segment.py:segment_sum_csr`` and its two
Pallas kernels, ``sorted_segment_sum_pallas`` (the ``by_dst`` layout) and
``segment_sum_unsorted_pallas`` (``by_src``). Both are entry points of one
CUDA kernel, ``csrc/segment_sum.cu``; the plain version below is its CPU
form and its reference on the card. It is the transpose reduction of every
gather on the training path.
"""
from __future__ import annotations

import torch

from gnnome_tpu_torch.core.graph import CSR
from gnnome_tpu_torch.ops.cuda_lib import (
    I32, I64, P, Kernel, check_cuda_args, entry, on_cpu, register, vec_ok)

SEGMENT_SUM_BY_DST = register(Kernel(
    "segment_sum_by_dst", "gnnome_segment_sum_by_dst_f32", [P, P, P, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/segment_sum.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:1116 sorted_segment_sum_pallas"))
SEGMENT_SUM_BY_SRC = register(Kernel(
    "segment_sum_by_src", "gnnome_segment_sum_by_src_f32", [P, P, P, P, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/segment_sum.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:436 segment_sum_unsorted_pallas"))
SEGMENT_SUM_BY_DST_BF16 = register(Kernel(
    "segment_sum_by_dst_bf16", "gnnome_segment_sum_by_dst_bf16", [P, P, P, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/segment_sum.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:1116 sorted_segment_sum_pallas",
    dtype=torch.bfloat16))
SEGMENT_SUM_BY_SRC_BF16 = register(Kernel(
    "segment_sum_by_src_bf16", "gnnome_segment_sum_by_src_bf16",
    [P, P, P, P, I64, I32, I32], source="gnnome_tpu_torch/csrc/segment_sum.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:436 segment_sum_unsorted_pallas",
    dtype=torch.bfloat16))


def segment_sum_plain(data: torch.Tensor, csr: CSR) -> torch.Tensor:
    n = csr.offsets.shape[0] - 1
    valid = csr.key < n
    out = torch.zeros((n, data.shape[1]), dtype=torch.float32, device=data.device)
    return out.index_add_(0, csr.key[valid], data[valid].to(torch.float32))


def segment_sum(data: torch.Tensor, csr: CSR) -> torch.Tensor:
    """Per node ``v`` of ``csr`` (``N_pad = len(offsets) - 1`` rows) the
    f32 sum of the rows of ``data`` ([E_pad, D], canonical order, float32 or
    bfloat16) whose key is ``v``; padded edges (key ``PAD_SEGMENT``) join
    no sum."""
    if on_cpu(data, csr.key, csr.offsets):
        return segment_sum_plain(data, csr)
    ints = [csr.offsets] if csr.identity else [csr.offsets, csr.order]
    kernel = entry(data.dtype, *((SEGMENT_SUM_BY_DST, SEGMENT_SUM_BY_DST_BF16)
                                 if csr.identity else
                                 (SEGMENT_SUM_BY_SRC, SEGMENT_SUM_BY_SRC_BF16)))
    check_cuda_args(kernel.name, [data], ints, dtype=kernel.dtype)
    n, d = csr.offsets.shape[0] - 1, data.shape[1]
    if data.shape[0] != csr.key.shape[0]:
        raise ValueError("segment_sum: data rows do not match the CSR's edges")
    out = torch.empty((n, d), dtype=torch.float32, device=data.device)
    order = [] if csr.identity else [csr.order.data_ptr()]
    kernel(data.device, data.data_ptr(), csr.offsets.data_ptr(), *order, out.data_ptr(),
           n, d, int(vec_ok(d, data, out)))
    return out
