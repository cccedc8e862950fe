"""Graph-level sparse ops of the GatedGCN layer and score head.

Counterpart of ``gnnome_tpu/ops/segment.py``: each function takes the
:class:`AssemblyGraph` fields it needs and runs one kernel (``ops/take.py``,
``ops/gate_front.py``, ``ops/gate_epilog.py``, ``ops/reverse_sum.py``), or
that kernel's plain version for CPU tensors, through a
``torch.autograd.Function`` whose backward is the JAX package's custom VJP
on the backward kernels (``ops/segment_sum.py`` and the ``*_bwd`` kernels).
"""
from __future__ import annotations

import torch

from gnnome_tpu_torch.core.graph import CSR, AssemblyGraph
from gnnome_tpu_torch.ops.gate_epilog import GateSigmaGather
from gnnome_tpu_torch.ops.gate_front import GateFront
from gnnome_tpu_torch.ops.reverse_sum import SigmaReverseSum
from gnnome_tpu_torch.ops.take import TakeRows


def gather_by_endpoint(values: torch.Tensor, index: torch.Tensor,
                       csr_t: CSR) -> torch.Tensor:
    """``values[index]`` per edge (canonical order); out-of-range ids give
    zero rows. ``index`` must be the endpoint array whose CSR is ``csr_t``
    (``graph.src`` with ``graph.by_src``, ``graph.dst`` with
    ``graph.by_dst``): the gradient is the segment sum over ``csr_t``."""
    return TakeRows.apply(values, index, csr_t)


def fused_gate_front(b1h, b2h, e, w3, bias3, graph: AssemblyGraph):
    """``(gate, mom)``: the shared GatedGCN gate
    ``b1h[src] + b2h[dst] + (e·W3 + b3)`` and its BatchNorm sums
    ``[Σ gate ‖ Σ gate²]`` over real edges (``layers/gated_gcn_full.py:120-127``
    of the reference)."""
    return GateFront.apply(b1h, b2h, e, w3, bias3, graph.src, graph.dst,
                           graph.n_edges, graph.by_src, graph.by_dst)


def fused_gate_sigma_gather(gate, e_in, values, affine, graph: AssemblyGraph):
    """``(sums, e_new)``: ``e_new = relu(gate·scale2 + bias2) + e_in`` and per
    destination ``[Σ σ(e_new)·values[src] ‖ Σ σ(e_new)]``."""
    return GateSigmaGather.apply(gate, e_in, values, affine, graph.by_dst,
                                 graph.src, graph.by_src)


def gated_mean_by_src(values: torch.Tensor, e_new: torch.Tensor,
                      graph: AssemblyGraph, eps: float = 1e-6) -> torch.Tensor:
    """Reverse-direction gated mean over each node's out-edges,
    ``Σ σ(e_new)·values[dst] / (Σ σ(e_new) + eps)`` — the aggregation on the
    reversed graph (``layers/gated_gcn_full.py:133-143``). Replaces the JAX
    package's ``gated_aggregate_reverse_unsorted``, on every graph."""
    d = values.shape[-1]
    sums = SigmaReverseSum.apply(e_new, values, graph.by_src, graph.dst, graph.by_dst)
    return sums[:, :d] / (sums[:, d:] + eps)


def gated_mean_plain(values: torch.Tensor, e_new: torch.Tensor,
                     value_index: torch.Tensor, key: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """``Σ σ(e_new)·values[value_index] / (Σ σ(e_new) + eps)`` per key node,
    in plain PyTorch on any device (index_add_). Only the
    ``batch_norm=False`` layer uses it; that branch has no kernel yet."""
    n, d = values.shape
    sigma = torch.sigmoid(e_new.to(torch.float32))
    stacked = torch.cat([sigma * values[value_index], sigma], dim=-1)
    valid = key < n
    sums = torch.zeros((n, 2 * d), dtype=torch.float32, device=values.device)
    sums.index_add_(0, key[valid], stacked[valid])
    return sums[:, :d] / (sums[:, d:] + eps)
