"""Edge-gated GatedGCN layer with bidirectional aggregation.

Counterpart of ``gnnome_tpu/models/gated_gcn.py``; reference
``layers/gated_gcn_full.py:99-157``. Per layer, for directed edge ``j → i``::

    ê        = B1·h[j] + B2·h[i] + B3·e
    e'       = ReLU(Norm(ê)) + e
    σ        = sigmoid(e')
    h_fwd[i] = Σ_{j→i} σ·A2·h[j] / (Σ_{j→i} σ + ε)
    h_bwd[j] = Σ_{j→i} σ·A3·h[i] / (Σ_{j→i} σ + ε)
    h'       = ReLU(Norm(A1·h + h_fwd + h_bwd)) + h

The gate is computed once and shared by both directions: in the
reference's live path the "backward" gate on the reversed graph evaluates
the same expression with the same normalizer.

The ``batch_norm=True`` branch (the shipped models) runs the three kernels
of the layer: gate front (gather + B3 product + moments), gate epilog with
the forward aggregation, and the reverse aggregation; their backward
kernels give it its gradient, and the BatchNorm statistics taken from
``mom`` stay plain autograd, which carries ``d_mom`` into the gate front's
backward. The ``batch_norm=False`` branch uses plain PyTorch functions
(differentiable by autograd): it has no kernel yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from gnnome_tpu_torch.core.graph import AssemblyGraph
from gnnome_tpu_torch.models.common import init_linear, init_norm, linear
from gnnome_tpu_torch.ops.norm import masked_batch_norm, masked_layer_norm
from gnnome_tpu_torch.ops.segment import (
    fused_gate_front,
    fused_gate_sigma_gather,
    gated_mean_by_src,
    gated_mean_plain,
)


def init_gated_gcn_layer(gen: torch.Generator, dim: int, device="cuda") -> Dict:
    params = {n: init_linear(gen, dim, dim, device)
              for n in ("A1", "A2", "A3", "B1", "B2", "B3")}
    params["norm_h"] = init_norm(dim, device)
    params["norm_e"] = init_norm(dim, device)
    return params


def gated_gcn_layer(params: Dict, graph: AssemblyGraph, h: torch.Tensor,
                    e: torch.Tensor, batch_norm: bool = True,
                    eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    h_in, e_in = h, e
    d = h.shape[-1]
    a1h = linear(params["A1"], h)
    a2h = linear(params["A2"], h)
    a3h = linear(params["A3"], h)
    b1h = linear(params["B1"], h)
    b2h = linear(params["B2"], h)

    if batch_norm:
        gate, mom = fused_gate_front(b1h, b2h, e, params["B3"]["w"],
                                     params["B3"]["b"], graph)
        cnt = float(max(graph.n_edges, 1))
        mean = mom[0] / cnt
        var = torch.clamp(mom[1] / cnt - mean * mean, min=0.0)
        scale2 = torch.rsqrt(var + 1e-5) * params["norm_e"]["scale"]
        bias2 = params["norm_e"]["bias"] - mean * scale2
        affine = torch.stack([scale2, bias2])
        sum_f, e_new = fused_gate_sigma_gather(gate, e_in, a2h, affine, graph)
        h_fwd = sum_f[:, :d] / (sum_f[:, d:] + eps)
        h_bwd = gated_mean_by_src(a3h, e_new, graph, eps)
    else:
        gate = b1h[graph.src] + b2h[graph.dst] + linear(params["B3"], e)
        gate = masked_layer_norm(gate, params["norm_e"]["scale"],
                                 params["norm_e"]["bias"])
        e_new = torch.relu(gate) + e_in
        h_fwd = gated_mean_plain(a2h, e_new, graph.src, graph.by_dst.key, eps)
        h_bwd = gated_mean_plain(a3h, e_new, graph.dst, graph.by_src.key, eps)

    h = a1h + h_fwd.to(h_in.dtype) + h_bwd.to(h_in.dtype)
    if batch_norm:
        h = masked_batch_norm(h, graph.node_mask, params["norm_h"]["scale"],
                              params["norm_h"]["bias"])
    else:
        h = masked_layer_norm(h, params["norm_h"]["scale"], params["norm_h"]["bias"])
    return torch.relu(h) + h_in, e_new
