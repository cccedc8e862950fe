"""Full edge-classification model: encoders + GatedGCN stack + score head.

Counterpart of ``gnnome_tpu/models/model.py``; reference
``GraphGatedGCNModel`` (``models/full_graph.py:11-29``):

  * node encoder: one linear on ``[in_deg ‖ out_deg ‖ pe]``;
  * edge encoder: 2-layer MLP ``2 → hidden_edge → hidden`` with ReLU;
  * processor: ``num_gnn_layers`` GatedGCN layers;
  * score head: per-edge MLP on ``[h_src ‖ h_dst ‖ e]`` →
    ``hidden_edge_scores`` → 1 (``layers/score_predictor.py:5-25``).

Parameters are a plain dictionary with the JAX package's tree layout
(see ``train/checkpoint.py``). Differentiable end to end on the
``batch_norm=True`` branch (every sparse op through its backward kernels);
``remat`` trades activation memory for a recomputed forward, as in the JAX
package. No dropout yet.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

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
    pre = (gather_by_endpoint(h_src_proj, graph.src, graph.by_src)
           + gather_by_endpoint(h_dst_proj, graph.dst, graph.by_dst)
           + e @ w1[2 * d:]
           + b1)
    return linear(params["score2"], torch.relu(pre))[:, 0]


REMAT_MODES = ("none", "layer", "group", "unroll_group")


def _layer_stack(layers, graph: AssemblyGraph, h, e, batch_norm: bool):
    for lp in layers:
        h, e = gated_gcn_layer(lp, graph, h, e, batch_norm=batch_norm)
    return h, e


def model_forward(params: Dict, graph: AssemblyGraph, e_feat: torch.Tensor,
                  pe: torch.Tensor, batch_norm: bool = True, remat: str = "layer",
                  remat_group: int = 4) -> torch.Tensor:
    """Per-edge logits, f32[E_pad] in canonical order (rows past
    ``graph.n_edges`` are padding). ``e_feat``: f32[E_pad, 2] z-normed
    [overlap_length, overlap_similarity]; ``pe``: f32[N_pad, nb_pos_enc + 2]
    = [in_deg ‖ out_deg ‖ PageRank PE].

    ``remat`` sets what the backward keeps (``gnnome_tpu/models/model.py``):
      * ``"none"``: every layer's intermediates;
      * ``"layer"``: each layer's (h, e) input only, the layer recomputed in
        the backward (``torch.utils.checkpoint``, non-reentrant);
      * ``"group"`` / ``"unroll_group"``: the (h, e) input of each group of
        ``remat_group`` layers (1 if it does not divide the depth), the
        group recomputed. The JAX package's two spellings differ in how XLA
        loops: ``"group"`` scans, with each layer checkpointed again inside
        the group's replay; ``"unroll_group"`` unrolls, with a store tail
        calibrated to a 16 GB TPU. PyTorch has no scan and runs eagerly, so
        here both are the one group checkpoint and compute the same thing.
    The score head stays outside every checkpoint. Recompute reproduces the
    forward only because every kernel on it is deterministic (fixed-order
    sums, no atomics). With gradients off, nothing is checkpointed.
    """
    if remat not in REMAT_MODES:
        raise ValueError(f"unknown remat mode {remat!r}; one of {REMAT_MODES}")
    h = linear(params["linear_pe"], pe)
    e = torch.relu(linear(params["linear1_edge"], e_feat))
    e = linear(params["linear2_edge"], e)
    layers = params["layers"]
    if remat == "none" or not torch.is_grad_enabled():
        # rebinding h, e frees each layer's input once nothing saved it
        for lp in layers:
            h, e = gated_gcn_layer(lp, graph, h, e, batch_norm=batch_norm)
    else:
        g = 1 if remat == "layer" or len(layers) % remat_group else remat_group
        for i in range(0, len(layers), g):
            h, e = checkpoint(_layer_stack, layers[i: i + g], graph, h, e, batch_norm,
                              use_reentrant=False)
    return score_predictor(params, graph, h, e).to(torch.float32)


def count_params(params) -> int:
    """Total parameter count (cf. ``train.py:96-112`` view_model_param)."""
    from gnnome_tpu_torch.train.checkpoint import iter_leaves

    return sum(leaf.numel() for _, leaf in iter_leaves(params))
