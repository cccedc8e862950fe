"""GatedGCN σ-weighted aggregation over a CSR, with the value rows either
gathered from a node table inside the kernel or pregathered per edge.

Counterpart of ``gnnome_tpu/ops/spmm_pallas.py:fused_sigma_aggregate_pallas``
and the custom VJP around it (``gnnome_tpu/ops/segment.py:
_fused_sigma_aggregate``, whose backward ``_fused_bwd`` is gather-only). The
CUDA kernels are ``csrc/sigma_aggregate.cu``; the plain versions below are
their CPU form and their reference on the card (the backward kernels walk
fixed tiles of the CSR's sorted positions, each edge's row read from its
``segment_ids``). Three forms:

* by_dst with ``ids`` (a node table read at ``ids[k]``): the LayerNorm
  layer's forward aggregation, ``a2h[src]`` gathered in the kernel;
* by_dst pregathered: an ``[E, D]`` table of value rows per canonical edge;
* by_src pregathered: the same, walked through ``by_src.order``.

A by_src walk over a node table is the reverse aggregation of
``ops/reverse_sum.py``, the TPU's ``fused_sigma_unsorted_pallas``.

Under bf16 (``e`` and the values bf16, the sums f32) each form has its own
``_bf16`` entry, which rounds where the TPU kernel rounds
(``gnnome_tpu/ops/spmm_pallas.py:1233-1236``): σ in f32 of the bf16 ``e``,
each summand ``σ·v`` and ``σ`` rounded to bf16, the sums taken in f32 (the
JAX xla composition, ``gnnome_tpu/ops/segment.py:245-246``, sums the f32
``σ·v``). The backward rounds the ``g_sums`` rows to bf16 as it uses them
(``segment.py:261-263``), computes in f32 and returns bf16 ``d_e`` and
``d_v``; with a node table, the segment sum of ``d_v`` is rounded to the
table's dtype, as the gather's VJP returns it.
"""
from __future__ import annotations

from typing import Optional

import torch

from gnnome_tpu_torch.core.graph import CSR
from gnnome_tpu_torch.ops.cuda_lib import (
    I32, I64, P, Kernel, check_cuda_args, entry, on_cpu, register, vec_ok)
from gnnome_tpu_torch.ops.segment_sum import segment_sum
from gnnome_tpu_torch.ops.take import take_rows_plain

_SOURCE = "gnnome_tpu_torch/csrc/sigma_aggregate.cu"
_FWD = "gnnome_tpu/ops/spmm_pallas.py:1247 fused_sigma_aggregate_pallas"
_BWD = ("gnnome_tpu/ops/segment.py:255 _fused_bwd (the VJP of "
        "fused_sigma_aggregate_pallas)")
_FWD_ARGS = [P, P, P, P, P, P, I64, I32, I32]
_BWD_ARGS = [P, P, P, P, P, P, P, P, I64, I64, I32, I32]


def _entries(name: str, symbol: str, argtypes, replaces: str) -> tuple[Kernel, Kernel]:
    """The f32 and bf16 entries of one form."""
    return tuple(register(Kernel(name + tail, f"{symbol}_{sym}", argtypes, _SOURCE, replaces,
                                 dtype))
                 for tail, sym, dtype in (("", "f32", torch.float32),
                                          ("_bf16", "bf16", torch.bfloat16)))


# one counter per form and dtype; the forms of one dtype share their C entry
# point, which picks the form from the null pointers (order: by_dst, ids:
# pregathered)
SIGMA_AGGREGATE_GATHER, SIGMA_AGGREGATE_GATHER_BF16 = _entries(
    "sigma_aggregate_gather", "gnnome_sigma_aggregate", _FWD_ARGS, _FWD)
SIGMA_AGGREGATE, SIGMA_AGGREGATE_BF16 = _entries(
    "sigma_aggregate", "gnnome_sigma_aggregate", _FWD_ARGS, _FWD)
SIGMA_AGGREGATE_BY_SRC, SIGMA_AGGREGATE_BY_SRC_BF16 = _entries(
    "sigma_aggregate_by_src", "gnnome_sigma_aggregate", _FWD_ARGS, _FWD)
SIGMA_AGGREGATE_BWD_GATHER, SIGMA_AGGREGATE_BWD_GATHER_BF16 = _entries(
    "sigma_aggregate_bwd_gather", "gnnome_sigma_aggregate_bwd", _BWD_ARGS, _BWD)
SIGMA_AGGREGATE_BWD, SIGMA_AGGREGATE_BWD_BF16 = _entries(
    "sigma_aggregate_bwd", "gnnome_sigma_aggregate_bwd", _BWD_ARGS, _BWD)
SIGMA_AGGREGATE_BWD_BY_SRC, SIGMA_AGGREGATE_BWD_BY_SRC_BF16 = _entries(
    "sigma_aggregate_bwd_by_src", "gnnome_sigma_aggregate_bwd", _BWD_ARGS, _BWD)


def _form(csr: CSR, ids: Optional[torch.Tensor], fwd: bool,
          dtype: torch.dtype) -> Kernel:
    if csr.identity:
        if ids is not None:
            pair = ((SIGMA_AGGREGATE_GATHER, SIGMA_AGGREGATE_GATHER_BF16) if fwd else
                    (SIGMA_AGGREGATE_BWD_GATHER, SIGMA_AGGREGATE_BWD_GATHER_BF16))
        else:
            pair = ((SIGMA_AGGREGATE, SIGMA_AGGREGATE_BF16) if fwd else
                    (SIGMA_AGGREGATE_BWD, SIGMA_AGGREGATE_BWD_BF16))
    elif ids is None:
        pair = ((SIGMA_AGGREGATE_BY_SRC, SIGMA_AGGREGATE_BY_SRC_BF16) if fwd else
                (SIGMA_AGGREGATE_BWD_BY_SRC, SIGMA_AGGREGATE_BWD_BY_SRC_BF16))
    else:
        raise ValueError("a by_src walk over a node table is the reverse aggregation "
                         "(ops/reverse_sum.py)")
    return entry(dtype, *pair)


def _value_rows(values, ids):
    return values if ids is None else values[ids]


def sigma_aggregate_plain(e, values, csr: CSR, ids=None):
    n, d, dt, f32 = csr.offsets.shape[0] - 1, e.shape[1], e.dtype, torch.float32
    sigma = torch.sigmoid(e.to(f32))
    sv = sigma * _value_rows(values, ids).to(f32)
    if dt != f32:  # the summands rounded to the data dtype, as the TPU kernel
        sv, sigma = sv.to(dt).to(f32), sigma.to(dt).to(f32)
    stacked = torch.cat([sv, sigma], dim=-1)
    valid = csr.key < n
    sums = torch.zeros((n, 2 * d), dtype=f32, device=e.device)
    return sums.index_add_(0, csr.key[valid], stacked[valid])


def sigma_aggregate(e: torch.Tensor, values: torch.Tensor, csr: CSR,
                    ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per key node of ``csr`` (``N = len(offsets) - 1`` rows)
    ``[Σ σ(e)·v ‖ Σ σ(e)]`` (f32 [N, 2D]) over its edges, with ``e`` [E, D]
    in canonical order and ``v = values[ids]`` (a node table of any row
    count that ``ids`` indexes, canonical ids) or, without ``ids``,
    ``values`` itself ([E, D], canonical order).
    Padded edges (key ``PAD_SEGMENT``) join no sum. ``e`` and ``values``
    float32 or bfloat16 (one dtype for both)."""
    kernel = _form(csr, ids, True, e.dtype)
    extra = [] if ids is None else [ids]
    if on_cpu(e, values, csr.key, csr.offsets, *extra):
        return sigma_aggregate_plain(e, values, csr, ids)
    ints = [csr.offsets, *extra, *([] if csr.identity else [csr.order])]
    check_cuda_args(kernel.name, [e, values], ints, dtype=kernel.dtype)
    n, d = csr.offsets.shape[0] - 1, e.shape[1]
    # pregathered values have a row per edge; a node table any count that
    # ids indexes (n sizes the sums, and the kernel does not bound ids)
    if values.shape[1] != d or (ids is None and values.shape[0] != e.shape[0]) \
            or (ids is not None and ids.shape[0] != e.shape[0]):
        raise ValueError(f"{kernel.name}: shape mismatch")
    sums = torch.empty((n, 2 * d), dtype=torch.float32, device=e.device)
    kernel(e.device, e.data_ptr(), values.data_ptr(), csr.offsets.data_ptr(),
           None if csr.identity else csr.order.data_ptr(),
           None if ids is None else ids.data_ptr(), sums.data_ptr(), n, d,
           int(vec_ok(d, e, values, sums)))
    return sums


def sigma_aggregate_bwd_plain(e, g_sums, values, csr: CSR, ids=None):
    d, dt, f32 = e.shape[1], e.dtype, torch.float32
    # zero rows on padded edges; the cotangent rounded to the edge dtype
    gc = take_rows_plain(g_sums.to(dt), csr.key).to(f32)
    g1, g2 = gc[:, :d], gc[:, d:]
    sig = torch.sigmoid(e.to(f32))
    d_e = (g1 * _value_rows(values, ids).to(f32) + g2) * (sig * (1.0 - sig))
    return d_e.to(dt), (g1 * sig).to(dt)


def sigma_aggregate_bwd(e: torch.Tensor, g_sums: torch.Tensor, values: torch.Tensor,
                        csr: CSR, ids: Optional[torch.Tensor] = None):
    """``(d_e, d_v)`` per canonical edge ([E, D] each): the cotangents of
    :func:`sigma_aggregate`'s inputs given ``g_sums`` ([N, 2D]); ``d_v`` is
    the gradient of the value row each edge read (with ``ids``, its segment
    sum over the CSR keyed on ``ids`` is ``d_values``). Zero on padded
    edges. ``g_sums`` is f32; bfloat16 data round its rows to bf16 as they
    use them and give bf16 cotangents."""
    kernel = _form(csr, ids, False, e.dtype)
    extra = [] if ids is None else [ids]
    if on_cpu(e, g_sums, values, csr.key, csr.offsets, *extra):
        return sigma_aggregate_bwd_plain(e, g_sums, values, csr, ids)
    ints = [csr.segment_ids, *extra, *([] if csr.identity else [csr.order])]
    check_cuda_args(kernel.name, [e, values], ints, dtype=kernel.dtype, f32=[g_sums])
    n, (n_rows, d) = csr.offsets.shape[0] - 1, e.shape
    if values.shape[1] != d or (ids is None and values.shape[0] != n_rows) \
            or g_sums.shape != (n, 2 * d) \
            or (ids is not None and ids.shape[0] != n_rows) \
            or csr.segment_ids.shape != (n_rows,):
        raise ValueError(f"{kernel.name}: shape mismatch")
    d_e, d_v = torch.empty_like(e), torch.empty_like(e)
    kernel(e.device, e.data_ptr(), g_sums.data_ptr(), values.data_ptr(),
           csr.segment_ids.data_ptr(), None if csr.identity else csr.order.data_ptr(),
           None if ids is None else ids.data_ptr(), d_e.data_ptr(), d_v.data_ptr(),
           n, n_rows, d, int(vec_ok(d, e, g_sums, values, d_e, d_v)))
    return d_e, d_v


class SigmaAggregate(torch.autograd.Function):
    """:func:`sigma_aggregate` with the gradient of the JAX
    ``_fused_sigma_aggregate`` (``gnnome_tpu/ops/segment.py:215-274``)
    composed with the endpoint gather's VJP where the values are a node
    table: ``d_values`` is then the segment sum of ``d_v`` over
    ``value_csr_t``, the CSR keyed on ``ids``, in the table's dtype. Saves
    ``(e, values)``; a strided slice of a wider table (the wide-gather
    pairs) is copied to contiguous rows first."""

    @staticmethod
    def forward(ctx, e, values, csr: CSR, ids, value_csr_t: Optional[CSR]):
        e, values = e.contiguous(), values.contiguous()
        ctx.save_for_backward(e, values)
        ctx.csr, ctx.ids, ctx.value_csr_t = csr, ids, value_csr_t
        return sigma_aggregate(e, values, csr, ids)

    @staticmethod
    def backward(ctx, g):
        e, values = ctx.saved_tensors
        d_e, d_v = sigma_aggregate_bwd(e, g.contiguous(), values, ctx.csr, ctx.ids)
        if ctx.ids is not None:
            d_v = segment_sum(d_v, ctx.value_csr_t).to(values.dtype) \
                if ctx.needs_input_grad[1] else None
        return d_e, d_v, None, None, None
