"""Row gather ``table[ids]`` with zero rows for out-of-range ids.

Counterpart of ``gnnome_tpu/ops/banded.py:take_rows`` and its Pallas
kernel ``banded_take_pallas``. The CUDA kernel is ``csrc/take.cu``; the
plain version below is its CPU form and its reference on the card.
:class:`TakeRows` gives the gather its gradient, the segment sum over the
gathered endpoint's CSR (``gnnome_tpu/ops/segment.py:_gather_bwd``).
"""
from __future__ import annotations

import torch

from gnnome_tpu_torch.core.graph import CSR
from gnnome_tpu_torch.ops.cuda_lib import (
    I32, I64, P, Kernel, check_cuda_args, entry, on_cpu, register, vec_ok)
from gnnome_tpu_torch.ops.segment_sum import segment_sum

TAKE_ROWS = register(Kernel(
    "take_rows", "gnnome_take_rows_f32", [P, P, P, I64, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/take.cu",
    replaces="gnnome_tpu/ops/banded.py:300 banded_take_pallas"))
TAKE_ROWS_BF16 = register(Kernel(
    "take_rows_bf16", "gnnome_take_rows_bf16", [P, P, P, I64, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/take.cu",
    replaces="gnnome_tpu/ops/banded.py:300 banded_take_pallas", dtype=torch.bfloat16))


def take_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = table.index_select(0, torch.where(valid, ids, torch.zeros_like(ids)))
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=table.dtype,
                                                         device=table.device))


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` ([R, D] table, int ids [E] → [E, D]); ids outside
    ``[0, R)``, such as ``PAD_SEGMENT``, give zero rows. A float32 or
    bfloat16 table; the rows are copied bit for bit."""
    if on_cpu(table, ids):
        return take_rows_plain(table, ids)
    kernel = entry(table.dtype, TAKE_ROWS, TAKE_ROWS_BF16)
    check_cuda_args(kernel.name, [table], [ids], dtype=kernel.dtype)
    n_rows, d = table.shape
    out = torch.empty((ids.shape[0], d), dtype=table.dtype, device=table.device)
    kernel(table.device, table.data_ptr(), ids.data_ptr(), out.data_ptr(),
           ids.shape[0], n_rows, d, int(vec_ok(d, table, out)))
    return out


class TakeRows(torch.autograd.Function):
    """``table[index]`` whose gradient is the segment sum of the cotangent
    over ``csr``, the CSR keyed on ``index`` (``graph.src`` with
    ``by_src``, ``graph.dst`` with ``by_dst``). Padded edges gather row 0
    (their ids are clamped) but their cotangent rows are dropped, as the
    JAX VJP drops them. The gradient is summed in f32 and returned in the
    table's dtype (``gnnome_tpu/ops/segment.py:_gather_bwd``)."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, index: torch.Tensor, csr: CSR):
        ctx.csr, ctx.dtype = csr, table.dtype
        return take_rows(table, index)

    @staticmethod
    def backward(ctx, g):
        return segment_sum(g.contiguous(), ctx.csr).to(ctx.dtype), None, None
