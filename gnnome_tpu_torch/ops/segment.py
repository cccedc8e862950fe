"""Graph-level sparse ops of the GatedGCN layer and score head.

Counterpart of ``gnnome_tpu/ops/segment.py``: each function takes the
:class:`AssemblyGraph` fields it needs and runs one kernel (``ops/take.py``,
``ops/gate_front.py``, ``ops/gate_epilog.py``, ``ops/sigma_aggregate.py``,
``ops/reverse_sum.py``), or that kernel's plain version for CPU tensors,
through a ``torch.autograd.Function`` whose backward is the JAX package's
custom VJP on the backward kernels (``ops/segment_sum.py`` and the
``*_bwd`` kernels). Functions named as in the JAX package take its
arguments' meanings; the per-edge key arrays and ``num_segments`` are not
passed, since each :class:`CSR` carries its ``key`` and ``offsets``.
"""
from __future__ import annotations

import torch

from gnnome_tpu_torch.core.graph import CSR, AssemblyGraph
from gnnome_tpu_torch.ops.gate_epilog import GateSigmaGather
from gnnome_tpu_torch.ops.gate_front import GateFront
from gnnome_tpu_torch.ops.reverse_sum import SigmaOpposite, SigmaReverseSum
from gnnome_tpu_torch.ops.sigma_aggregate import SigmaAggregate
from gnnome_tpu_torch.ops.take import TakeRows


def gather_by_endpoint(values: torch.Tensor, index: torch.Tensor,
                       csr_t: CSR) -> torch.Tensor:
    """``values[index]`` per edge (canonical order); out-of-range ids give
    zero rows. ``index`` must be the endpoint array whose CSR is ``csr_t``
    (``graph.src`` with ``graph.by_src``, ``graph.dst`` with
    ``graph.by_dst``): the gradient is the segment sum over ``csr_t``."""
    return TakeRows.apply(values, index, csr_t)


def fused_gate_front(b1h, b2h, e, w3, bias3, graph: AssemblyGraph, moments: bool = True):
    """``(gate, mom)``: the shared GatedGCN gate
    ``b1h[src] + b2h[dst] + (e·W3 + b3)`` and its BatchNorm sums
    ``[Σ gate ‖ Σ gate²]`` over real edges (``layers/gated_gcn_full.py:120-127``
    of the reference). ``moments=False`` where only the gate is read (the
    LayerNorm layer): ``mom`` then takes no gradient and the backward skips
    the moments' term (:class:`GateFront`)."""
    return GateFront.apply(b1h, b2h, e, w3, bias3, graph.src, graph.dst,
                           graph.n_edges, graph.by_src, graph.by_dst, moments)


def fused_gate_sigma_gather(gate, e_in, values, affine, graph: AssemblyGraph):
    """``(sums, e_new)``: ``e_new = relu(gate·scale2 + bias2) + e_in`` and per
    destination ``[Σ σ(e_new)·values[src] ‖ Σ σ(e_new)]``."""
    return GateSigmaGather.apply(gate, e_in, values, affine, graph.by_dst,
                                 graph.src, graph.by_src)


def fused_gate_sigma_aggregate(gate_raw, e_in, vals, affine, csr: CSR):
    """``(sums, e_new)`` as :func:`fused_gate_sigma_gather`, over ``vals``
    ([E, D]) already gathered per canonical edge (the wide-gather path);
    ``csr`` must be the canonical by_dst layout. Its gradient with respect
    to ``vals`` is per edge: the gather that made them sums it."""
    return GateSigmaGather.apply(gate_raw, e_in, vals, affine, csr, None, None)


def gated_mean(sums: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``Σ σ·v / (Σ σ + eps)`` from a table of sums ``[Σ σ·v ‖ Σ σ]``
    ([N, 2D], as the σ kernels return them)."""
    d = sums.shape[-1] // 2
    return sums[:, :d] / (sums[:, d:] + eps)


def gated_aggregate(values: torch.Tensor, gate_pre: torch.Tensor,
                    value_index: torch.Tensor, value_csr_t: CSR, csr: CSR,
                    eps: float = 1e-6) -> torch.Tensor:
    """σ-weighted mean per key node of ``csr``,
    ``Σ σ(gate_pre)·values[value_index] / (Σ σ(gate_pre) + eps)``, with the
    neighbour gather inside the kernel; ``value_csr_t`` is the CSR keyed on
    ``value_index`` (its segment sum is the gather's gradient). By_dst with
    ``value_index = src`` is the LayerNorm layer's forward aggregation;
    by_src with ``dst`` is the reverse aggregation (:func:`gated_mean_by_src`)."""
    fn = SigmaAggregate if csr.identity else SigmaReverseSum
    return gated_mean(fn.apply(gate_pre, values, csr, value_index, value_csr_t), eps)


def gated_aggregate_pregathered(vals: torch.Tensor, gate_pre: torch.Tensor, csr: CSR,
                                eps: float = 1e-6) -> torch.Tensor:
    """:func:`gated_aggregate` when the value rows are already gathered per
    canonical edge ([E, D], e.g. a half of a paired wide-row gather); the
    gradient with respect to ``vals`` is per edge."""
    return gated_mean(SigmaAggregate.apply(gate_pre, vals, csr, None, None), eps)


def _fused_sigma_opposite(values: torch.Tensor, gate_pre: torch.Tensor, csr: CSR,
                          by_opp: CSR) -> torch.Tensor:
    """``[Σ σ(gate_pre[order])·values[opp_ids] ‖ Σ σ]`` (f32 [N, 2D]) per key
    node of ``csr`` (by_src), both gathers inside one kernel; ``by_opp`` is
    the by_dst layout the value gradient is summed over."""
    return SigmaOpposite.apply(values, gate_pre, csr, by_opp)


def gated_aggregate_opposite(values: torch.Tensor, gate_pre: torch.Tensor, csr: CSR,
                             by_opp: CSR, eps: float = 1e-6) -> torch.Tensor:
    """:func:`gated_aggregate` keyed on ``csr`` (by_src) with the neighbour
    rows read in src-sorted order (``csr.opp_ids``). The same function as
    :func:`gated_mean_by_src`, which the model uses on every graph."""
    return gated_mean(_fused_sigma_opposite(values, gate_pre, csr, by_opp), eps)


def gated_sums_by_src(values: torch.Tensor, e_new: torch.Tensor,
                      graph: AssemblyGraph) -> torch.Tensor:
    """``[Σ σ(e_new)·values[dst] ‖ Σ σ(e_new)]`` (f32 [N, 2D]) over each
    node's out-edges: the reverse aggregation before :func:`gated_mean`."""
    fn = SigmaAggregate if graph.by_src.identity else SigmaReverseSum
    return fn.apply(e_new, values, graph.by_src, graph.dst, graph.by_dst)


def gated_mean_by_src(values: torch.Tensor, e_new: torch.Tensor,
                      graph: AssemblyGraph, eps: float = 1e-6) -> torch.Tensor:
    """Reverse-direction gated mean over each node's out-edges,
    ``Σ σ(e_new)·values[dst] / (Σ σ(e_new) + eps)`` — the aggregation on the
    reversed graph (``layers/gated_gcn_full.py:133-143``). Replaces the JAX
    package's ``gated_aggregate_reverse_unsorted``, on every graph."""
    return gated_mean(gated_sums_by_src(values, e_new, graph), eps)
