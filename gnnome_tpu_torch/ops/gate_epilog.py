"""GatedGCN gate epilog fused with the forward (by-destination) σ-weighted
aggregation, with its neighbour gather or over pregathered value rows.

Counterpart of ``gnnome_tpu/ops/spmm_pallas.py:fused_gate_sigma_gather_pallas``
(``src`` given: the values are a node table read at ``src[k]``) and
``fused_gate_sigma_aggregate_pallas`` (no ``src``: an ``[E, D]`` table of
value rows per canonical edge, the wide-gather path). The CUDA kernels are
``csrc/gate_epilog.cu``; the plain version below is their CPU form and
their reference on the card. The backward (:class:`GateSigmaGather`, the
JAX ``_fused_gate_gather_bwd`` and ``_fused_gate_bwd``) runs
``csrc/epilog_bwd.cu`` (``epilog_bwd_pallas``, or its pregathered entry for
the XLA VJP of the second; an edge-balanced walk that reads each edge's row
from ``by_dst.key``), then, with ``src``, the by_src segment sum.

Under bf16 (``gnnome_tpu/ops/segment.py:769-790, 804-850, 1040-1085``):
the gate, ``e_in``, the values and ``e_new`` are bf16, the affine and the
sums f32; ``e_new`` is computed in f32 and rounded to bf16. Both forms
round where their TPU kernels round (``gnnome_tpu/ops/spmm_pallas.py:2951-2956``
and ``:1395-1399``): σ of the f32 ``e_new``, each summand ``σ·v`` and ``σ``
rounded to bf16 before its f32 sum (the xla compositions take σ of the
rounded ``e_new`` and sum the f32 products). In the
backward the ``g_sums`` rows are rounded to bf16 before use (the JAX VJP
casts the cotangent to the edge dtype), the [E, D] cotangents are computed
in f32 and rounded once, and ``d_affine`` stays f32; the pregathered form
recomputes the f32 ``e_new`` from ``e_in``, as ``_fused_gate_bwd`` does.
"""
from __future__ import annotations

from typing import Optional

import torch

from gnnome_tpu_torch.core.graph import CSR
from gnnome_tpu_torch.ops.cuda_lib import (
    I32, I64, P, Kernel, check_cuda_args, entry, on_cpu, register, vec_ok)
from gnnome_tpu_torch.ops.segment_sum import segment_sum
from gnnome_tpu_torch.ops.take import take_rows_plain

GATE_SIGMA_GATHER = register(Kernel(
    "gate_sigma_gather", "gnnome_gate_sigma_gather_f32",
    [P, P, P, P, P, P, P, P, I64, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/gate_epilog.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:3020 fused_gate_sigma_gather_pallas"))
GATE_SIGMA_GATHER_BF16 = register(Kernel(
    "gate_sigma_gather_bf16", "gnnome_gate_sigma_gather_bf16",
    [P, P, P, P, P, P, P, P, I64, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/gate_epilog.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:3020 fused_gate_sigma_gather_pallas",
    dtype=torch.bfloat16))
GATE_SIGMA_AGGREGATE = register(Kernel(
    "gate_sigma_aggregate", "gnnome_gate_sigma_aggregate_f32",
    [P, P, P, P, P, P, P, I64, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/gate_epilog.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:3156 fused_gate_sigma_aggregate_pallas"))
GATE_SIGMA_AGGREGATE_BF16 = register(Kernel(
    "gate_sigma_aggregate_bf16", "gnnome_gate_sigma_aggregate_bf16",
    [P, P, P, P, P, P, P, I64, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/gate_epilog.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:3156 fused_gate_sigma_aggregate_pallas",
    dtype=torch.bfloat16))
EPILOG_BWD = register(Kernel(
    "epilog_bwd", "gnnome_epilog_bwd_f32",
    [P, P, P, P, P, P, P, P, P, P, P, P, P, I64, I64, I32, I32, I32],
    source="gnnome_tpu_torch/csrc/epilog_bwd.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:1550 epilog_bwd_pallas"))
EPILOG_BWD_BF16 = register(Kernel(
    "epilog_bwd_bf16", "gnnome_epilog_bwd_bf16",
    [P, P, P, P, P, P, P, P, P, P, P, P, P, I64, I64, I32, I32, I32],
    source="gnnome_tpu_torch/csrc/epilog_bwd.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:1550 epilog_bwd_pallas", dtype=torch.bfloat16))
EPILOG_BWD_PREGATHERED = register(Kernel(
    "epilog_bwd_pregathered", "gnnome_epilog_bwd_pregathered_f32",
    [P, P, P, P, P, P, P, P, P, P, P, P, I64, I64, I32, I32, I32],
    source="gnnome_tpu_torch/csrc/epilog_bwd.cu",
    replaces="gnnome_tpu/ops/segment.py:1057 _fused_gate_bwd (the VJP of "
             "fused_gate_sigma_aggregate_pallas)"))
EPILOG_BWD_PREGATHERED_BF16 = register(Kernel(
    "epilog_bwd_pregathered_bf16", "gnnome_epilog_bwd_pregathered_bf16",
    [P, P, P, P, P, P, P, P, P, P, P, P, I64, I64, I32, I32, I32],
    source="gnnome_tpu_torch/csrc/epilog_bwd.cu",
    replaces="gnnome_tpu/ops/segment.py:1057 _fused_gate_bwd (the VJP of "
             "fused_gate_sigma_aggregate_pallas)", dtype=torch.bfloat16))

# csrc/epilog_bwd.cu chooses the grid of its walk (the card filled once,
# fewer blocks where the edges are fewer) and clips it to _MAX_PARTS blocks;
# each block leaves one partial d_affine row in this scratch (2 MB at
# D = 256), summed in a fixed order
_MAX_PARTS = 1024


def _value_rows(values, src):
    return values if src is None else values[src]


def recomputes_e_new(dtype: torch.dtype, src) -> bool:
    """Whether :func:`epilog_bwd` takes ``e_in`` in place of ``e_new``:
    the bf16 pregathered form (the VJP of ``gate_sigma_aggregate``)
    recomputes the f32 ``e_new`` from ``e_in``, as JAX's ``_fused_gate_bwd``
    does. Every other form reads the saved ``e_new`` (in f32 the two are the
    same bits): the bf16 gather form's VJP takes σ of the saved, rounded
    ``e_new``, as JAX's ``_fused_gate_gather_bwd`` does
    (``gnnome_tpu/ops/segment.py:804-840``), though its forward took σ of
    the f32 one."""
    return src is None and dtype == torch.bfloat16


def gate_sigma_gather_plain(gate, e_in, values, affine, by_dst: CSR, src=None):
    n, d = by_dst.offsets.shape[0] - 1, gate.shape[1]
    dt, f32 = e_in.dtype, torch.float32
    pre = gate.to(f32) * affine[0] + affine[1]
    e32 = torch.relu(pre) + e_in.to(f32)
    e_new = e32.to(dt)
    # the TPU kernels' σ of the f32 e_new, each summand rounded to the dtype
    sigma = torch.sigmoid(e32)
    sv = (sigma * _value_rows(values, src).to(f32)).to(dt).to(f32)
    sigma = sigma.to(dt).to(f32)
    stacked = torch.cat([sv, sigma], dim=-1)
    valid = by_dst.key < n
    sums = torch.zeros((n, 2 * d), dtype=torch.float32, device=values.device)
    sums.index_add_(0, by_dst.key[valid], stacked[valid])
    return sums, e_new


def gate_sigma_gather(gate: torch.Tensor, e_in: torch.Tensor,
                      values: torch.Tensor, affine: torch.Tensor,
                      by_dst: CSR, src: Optional[torch.Tensor] = None):
    """``(sums, e_new)``: ``e_new = relu(gate·affine[0] + affine[1]) + e_in``
    per canonical edge, and per destination node
    ``sums = [Σ σ(e_new)·v ‖ Σ σ(e_new)]`` (f32 [N, 2D]) over its in-edges,
    with ``v = values[src]`` (a node table of any row count that ``src``
    indexes: the sharded layer's combined [N_local + P·H] table) or, without
    ``src``, ``values`` itself ([E, D] pregathered rows,
    ``gate_sigma_aggregate``); padded edges
    (key ``PAD_SEGMENT``) join no sum. ``by_dst`` must be the canonical
    (identity) layout. ``gate``, ``e_in``, ``values`` and ``e_new`` are
    float32 or bfloat16; ``affine`` and the sums f32."""
    if not by_dst.identity:
        raise ValueError("gate_sigma_gather runs on the canonical (by_dst) layout")
    extra = [] if src is None else [src]
    if on_cpu(gate, e_in, values, affine, by_dst.key, by_dst.offsets, *extra):
        return gate_sigma_gather_plain(gate, e_in, values, affine, by_dst, src)
    kernel = entry(gate.dtype, *((GATE_SIGMA_AGGREGATE, GATE_SIGMA_AGGREGATE_BF16)
                                 if src is None else (GATE_SIGMA_GATHER,
                                                      GATE_SIGMA_GATHER_BF16)))
    check_cuda_args(kernel.name, [gate, e_in, values], [by_dst.offsets, *extra],
                    dtype=kernel.dtype, f32=[affine])
    n, (n_rows, d) = by_dst.offsets.shape[0] - 1, gate.shape
    # pregathered values have a row per edge; a node table any count that
    # src indexes (n sizes the sums, and the kernel does not bound src)
    if gate.shape != e_in.shape or affine.shape != (2, d) or values.shape[1] != d \
            or (src is None and values.shape[0] != n_rows):
        raise ValueError(f"{kernel.name}: shape mismatch")
    sums = torch.empty((n, 2 * d), dtype=torch.float32, device=gate.device)
    e_new = torch.empty_like(e_in)
    vec = int(vec_ok(d, gate, e_in, values, affine, sums, e_new))
    ptrs = [gate.data_ptr(), e_in.data_ptr(), values.data_ptr(), affine.data_ptr(),
            by_dst.offsets.data_ptr(), *(t.data_ptr() for t in extra)]
    kernel(gate.device, *ptrs, sums.data_ptr(), e_new.data_ptr(), n, n_rows, d, vec)
    return sums, e_new


def epilog_bwd_plain(gate_raw, e_new, g_enew, g_sums, values, affine, by_dst: CSR,
                     src=None):
    d, dt, f32 = gate_raw.shape[1], gate_raw.dtype, torch.float32
    # zero rows on padded edges; the cotangent rounded to the edge dtype
    gc = take_rows_plain(g_sums.to(dt), by_dst.key).to(f32)
    g1, g2 = gc[:, :d], gc[:, d:]
    graw = gate_raw.to(f32)
    pre = graw * affine[0] + affine[1]
    e32 = e_new.to(f32)
    if recomputes_e_new(dt, src):  # e_new holds e_in
        e32 = torch.relu(pre) + e32
    sig = torch.sigmoid(e32)
    d_enew = g_enew.to(f32) + (g1 * _value_rows(values, src).to(f32) + g2) \
        * (sig * (1.0 - sig))
    d_pre = d_enew * (pre > 0)
    d_affine = torch.stack([(d_pre * graw).sum(0), d_pre.sum(0)])
    return (d_pre * affine[0]).to(dt), d_enew.to(dt), (g1 * sig).to(dt), d_affine


def epilog_bwd(gate_raw: torch.Tensor, e_new: torch.Tensor, g_enew: torch.Tensor,
               g_sums: torch.Tensor, values: torch.Tensor, affine: torch.Tensor,
               by_dst: CSR, src: Optional[torch.Tensor] = None):
    """``(d_gate_raw, d_e_in, d_vals, d_affine)``: the cotangents of
    :func:`gate_sigma_gather`'s inputs per canonical edge, given those of
    its outputs (``g_sums`` [N, 2D], ``g_enew`` [E, D]); ``d_vals`` is per
    edge (with ``src``, its by_src segment sum is ``d_values``; without, it
    is the gradient of the pregathered rows) and ``d_affine`` ([2, D]) is
    summed over all rows, padded ones included. bfloat16 [E, D] data take
    ``g_sums`` and ``affine`` in f32, round the ``g_sums`` rows to bf16 as
    they use them and return bf16 cotangents and an f32 ``d_affine``;
    where :func:`recomputes_e_new` (bf16 without ``src``), ``e_new`` is
    ``e_in``."""
    if not by_dst.identity:
        raise ValueError("epilog_bwd runs on the canonical (by_dst) layout")
    extra = [] if src is None else [src]
    if on_cpu(gate_raw, e_new, g_enew, g_sums, values, affine, by_dst.key,
              by_dst.offsets, *extra):
        return epilog_bwd_plain(gate_raw, e_new, g_enew, g_sums, values, affine,
                                by_dst, src)
    kernel = entry(gate_raw.dtype, *((EPILOG_BWD_PREGATHERED, EPILOG_BWD_PREGATHERED_BF16)
                                     if src is None else (EPILOG_BWD, EPILOG_BWD_BF16)))
    floats = [gate_raw, e_new, g_enew, g_sums, values, affine]
    check_cuda_args(kernel.name, [gate_raw, e_new, g_enew, values], [by_dst.key, *extra],
                    dtype=kernel.dtype, f32=[g_sums, affine])
    n, (n_rows, d) = by_dst.offsets.shape[0] - 1, gate_raw.shape
    if not (gate_raw.shape == e_new.shape == g_enew.shape) or values.shape[1] != d \
            or (src is None and values.shape[0] != n_rows) \
            or g_sums.shape != (n, 2 * d) or affine.shape != (2, d) \
            or by_dst.key.shape != (n_rows,):
        raise ValueError(f"{kernel.name}: shape mismatch")
    d_gate_raw, d_e_in, d_vals = (torch.empty_like(gate_raw) for _ in range(3))
    partial = torch.empty((_MAX_PARTS, 2, d), dtype=torch.float32, device=gate_raw.device)
    d_affine = torch.empty((2, d), dtype=torch.float32, device=gate_raw.device)
    vec = vec_ok(d, *floats, d_gate_raw, d_e_in, d_vals)
    kernel(gate_raw.device, *(t.data_ptr() for t in floats), by_dst.key.data_ptr(),
           *(t.data_ptr() for t in extra), d_gate_raw.data_ptr(), d_e_in.data_ptr(),
           d_vals.data_ptr(), partial.data_ptr(), d_affine.data_ptr(), n, n_rows, d,
           _MAX_PARTS, int(vec))
    return d_gate_raw, d_e_in, d_vals, d_affine


class GateSigmaGather(torch.autograd.Function):
    """:func:`gate_sigma_gather` with the gradient of the JAX
    ``fused_gate_sigma_gather`` (``gnnome_tpu/ops/segment.py:804-850``), or,
    with ``src`` and ``by_src`` None, of ``fused_gate_sigma_aggregate``
    (``:1057-1085``: ``d_vals`` is then the gradient of the pregathered
    rows). Saves ``(gate_raw, e_new, values, affine)``: ``e_new``, the
    forward's own output, in place of ``e_in``, as
    ``_fused_gate_gather_fwd`` does (``_fused_gate_fwd`` recomputes it from
    ``e_in``; in f32 the values are the same), but ``e_in`` for the bf16
    pregathered form, whose σ is of the unrounded e_new
    (:func:`recomputes_e_new`); a strided slice of a wider table (the
    wide-gather pairs) is copied to contiguous rows first."""

    @staticmethod
    def forward(ctx, gate, e_in, values, affine, by_dst: CSR, src, by_src: Optional[CSR]):
        values = values.contiguous()
        sums, e_new = gate_sigma_gather(gate, e_in, values, affine, by_dst, src)
        ctx.save_for_backward(gate, e_in if recomputes_e_new(e_in.dtype, src) else e_new,
                              values, affine)
        ctx.by_dst, ctx.src, ctx.by_src = by_dst, src, by_src
        return sums, e_new

    @staticmethod
    def backward(ctx, g_sums, g_enew):
        gate, e_saved, values, affine = ctx.saved_tensors
        d_gate, d_e_in, d_vals, d_affine = epilog_bwd(
            gate, e_saved, g_enew.contiguous(), g_sums.contiguous(), values, affine,
            ctx.by_dst, ctx.src)
        if ctx.src is not None:
            d_vals = segment_sum(d_vals, ctx.by_src).to(values.dtype) \
                if ctx.needs_input_grad[2] else None
        return d_gate, d_e_in, d_vals, d_affine, None, None, None
