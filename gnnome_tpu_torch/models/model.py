"""Full edge-classification model: encoders + GatedGCN stack + score head
(forward only).

Counterpart of ``gnnome_tpu/models/model.py``; reference
``GraphGatedGCNModel`` (``models/full_graph.py:11-29``):

  * node encoder: one linear on ``[in_deg ‖ out_deg ‖ pe]``;
  * edge encoder: 2-layer MLP ``2 → hidden_edge → hidden`` with ReLU;
  * processor: ``num_gnn_layers`` GatedGCN layers;
  * score head: per-edge MLP on ``[h_src ‖ h_dst ‖ e]`` →
    ``hidden_edge_scores`` → 1 (``layers/score_predictor.py:5-25``).

Parameters are a plain dictionary with the JAX package's tree layout
(see ``train/checkpoint.py``). Inference only: no dropout, no remat.
"""
from __future__ import annotations

from typing import Dict

import torch

from gnnome_tpu_torch.core.graph import AssemblyGraph
from gnnome_tpu_torch.models.common import init_linear, linear
from gnnome_tpu_torch.models.gated_gcn import gated_gcn_layer, init_gated_gcn_layer
from gnnome_tpu_torch.ops.segment import gather_by_endpoint


def init_model_params(gen: torch.Generator, cfg, device="cuda") -> Dict:
    """Random parameters for a ``ModelConfig`` from an explicit generator."""
    d = cfg.hidden_features
    params: Dict = {
        "linear_pe": init_linear(gen, cfg.nb_pos_enc + 2, d, device),
        "linear1_edge": init_linear(gen, cfg.edge_features, cfg.hidden_edge_features, device),
        "linear2_edge": init_linear(gen, cfg.hidden_edge_features, d, device),
        "layers": [init_gated_gcn_layer(gen, d, device)
                   for _ in range(cfg.num_gnn_layers)],
        "score1": init_linear(gen, 3 * d, cfg.hidden_edge_scores, device),
    }
    params["score2"] = init_linear(gen, cfg.hidden_edge_scores, 1, device)
    return params


def score_predictor(params: Dict, graph: AssemblyGraph, h: torch.Tensor,
                    e: torch.Tensor) -> torch.Tensor:
    """Per-edge score MLP on ``[h_src ‖ h_dst ‖ e]`` in split-matmul form:
    ``h`` is multiplied by the src and dst row blocks of W1 at node width,
    the two products are gathered per edge, and the [E, 3D] concat is never
    built (``gnnome_tpu/models/model.py:52-74``)."""
    d = h.shape[-1]
    w1, b1 = params["score1"]["w"], params["score1"]["b"]
    h_src_proj = h @ w1[:d]
    h_dst_proj = h @ w1[d: 2 * d]
    pre = (gather_by_endpoint(h_src_proj, graph.src)
           + gather_by_endpoint(h_dst_proj, graph.dst)
           + e @ w1[2 * d:]
           + b1)
    return linear(params["score2"], torch.relu(pre))[:, 0]


def model_forward(params: Dict, graph: AssemblyGraph, e_feat: torch.Tensor,
                  pe: torch.Tensor, batch_norm: bool = True) -> torch.Tensor:
    """Per-edge logits, f32[E_pad] in canonical order (rows past
    ``graph.n_edges`` are padding). ``e_feat``: f32[E_pad, 2] z-normed
    [overlap_length, overlap_similarity]; ``pe``: f32[N_pad, nb_pos_enc + 2]
    = [in_deg ‖ out_deg ‖ PageRank PE]."""
    h = linear(params["linear_pe"], pe)
    e = torch.relu(linear(params["linear1_edge"], e_feat))
    e = linear(params["linear2_edge"], e)
    for lp in params["layers"]:
        h, e = gated_gcn_layer(lp, graph, h, e, batch_norm=batch_norm)
    return score_predictor(params, graph, h, e).to(torch.float32)


def count_params(params) -> int:
    """Total parameter count (cf. ``train.py:96-112`` view_model_param)."""
    from gnnome_tpu_torch.train.checkpoint import iter_leaves

    return sum(leaf.numel() for _, leaf in iter_leaves(params))
