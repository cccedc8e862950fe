"""Full edge-classification model: encoders + GatedGCN stack + score head.

Counterpart of ``gnnome_tpu/models/model.py``; reference
``GraphGatedGCNModel`` (``models/full_graph.py:11-29``):

  * node encoder: one linear on ``[in_deg ‖ out_deg ‖ pe]``;
  * edge encoder: 2-layer MLP ``2 → hidden_edge → hidden`` with ReLU;
  * processor: ``num_gnn_layers`` GatedGCN layers;
  * score head: per-edge MLP on ``[h_src ‖ h_dst ‖ e]`` →
    ``hidden_edge_scores`` → 1 (``layers/score_predictor.py:5-25``).

Parameters are a plain dictionary with the JAX package's tree layout
(see ``train/checkpoint.py``). Differentiable end to end on every branch
(BatchNorm or LayerNorm, narrow or wide gathers; every sparse op through
its backward kernels); ``remat`` trades activation memory for a recomputed
forward, and dropout follows the JAX package's API, as there. A shard of a
graph (``parallel/sharded.py``) runs this same forward through its halo
(``models/gated_gcn.py`` ``Halo``), which on one card changes nothing.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from gnnome_tpu_torch.core.graph import AssemblyGraph
from gnnome_tpu_torch.models.common import init_linear, linear
from gnnome_tpu_torch.models.gated_gcn import (
    ONE_CARD, Halo, gated_gcn_layer, init_gated_gcn_layer)
from gnnome_tpu_torch.ops.dense import matmul
from gnnome_tpu_torch.ops.segment import gather_by_endpoint
from gnnome_tpu_torch.utils.profiling import span


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
                    e: torch.Tensor, halo: Halo = ONE_CARD) -> torch.Tensor:
    """Per-edge score MLP on ``[h_src ‖ h_dst ‖ e]`` in split-matmul form:
    ``h`` is multiplied by the src and dst row blocks of W1 at node width,
    the two products are gathered per edge (the src one through ``halo``'s
    exchange), and the [E, 3D] concat is never built
    (``gnnome_tpu/models/model.py:52-74``)."""
    d = h.shape[-1]
    w1, b1 = params["score1"]["w"], params["score1"]["b"]
    h_src_proj = matmul(h, w1[:d])
    h_dst_proj = matmul(h, w1[d: 2 * d])
    (h_src_proj,) = halo.exchange([h_src_proj])
    pre = (gather_by_endpoint(h_src_proj, graph.src, graph.by_src)
           + gather_by_endpoint(h_dst_proj, graph.dst, graph.by_dst)
           + matmul(e, w1[2 * d:])
           + b1)
    return linear(params["score2"], torch.relu(pre))[:, 0]


REMAT_MODES = ("none", "layer", "group", "unroll_group")
BF16_NAMES = ("bfloat16", "bf16")


def compute_dtype_of(compute_dtype: str) -> torch.dtype:
    """The torch dtype of a ``compute_dtype`` name, JAX's spellings
    (``"float32"``; ``"bfloat16"`` / ``"bf16"``); raises ``ValueError`` for
    any other name. bf16 covers every model: BatchNorm and LayerNorm, narrow
    and wide gathers, as JAX's ``model_forward`` casts every config
    (``gnnome_tpu/models/model.py:134-140``)."""
    if compute_dtype == "float32":
        return torch.float32
    if compute_dtype not in BF16_NAMES:
        raise ValueError(f"compute_dtype={compute_dtype!r}; one of float32, {BF16_NAMES}")
    return torch.bfloat16


def _cast_params(params, dtype: torch.dtype):
    """Every float32 leaf cast to ``dtype`` (differentiable: the gradients
    reach the float32 leaves in float32, as JAX's ``astype`` VJP does)."""
    if isinstance(params, dict):
        return {k: _cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_cast_params(v, dtype) for v in params)
    return params.to(dtype) if params.dtype == torch.float32 else params


def _layer_stack(layer_fn, layers, h, e):
    for lp in layers:
        h, e = layer_fn(lp, h, e)
    return h, e


def _layer_rng(rng: torch.Generator, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``rng``: one stream per layer,
    as the JAX package folds the layer index into its key."""
    seed = int(torch.randint(0, 2**62, (), generator=rng))
    return torch.Generator(device=device).manual_seed(seed)


def model_forward(params: Dict, graph: AssemblyGraph, e_feat: torch.Tensor,
                  pe: torch.Tensor, batch_norm: bool = True, remat: str = "layer",
                  remat_group: int = 4, wide_gathers=False, dropout_rate: float = 0.0,
                  dropout_rng: Optional[torch.Generator] = None,
                  compute_dtype: str = "float32", halo: Halo = ONE_CARD) -> torch.Tensor:
    """Per-edge logits, f32[E_pad] in canonical order (rows past
    ``graph.n_edges`` are padding). ``e_feat``: f32[E_pad, 2] z-normed
    [overlap_length, overlap_similarity]; ``pe``: f32[N_pad, nb_pos_enc + 2]
    = [in_deg ‖ out_deg ‖ PageRank PE]. ``wide_gathers``: False, True or
    ``"src"`` (``models/gated_gcn.py``).

    ``compute_dtype`` ``"bfloat16"`` (or ``"bf16"``) runs the model in bf16
    with f32 master weights, as ``gnnome_tpu/models/model.py:134-140``:
    every f32 leaf, ``pe`` and ``e_feat`` are cast to bf16 inside the
    forward, the kernels take their bf16 entries (f32 sums and moments), the
    weight gradients keep an f32 result (``ops/dense.py``), and the logits
    come back in f32; every model branch (:func:`compute_dtype_of`).

    Dropout (``dropout_rate`` > 0 with a ``dropout_rng``, a CPU generator
    in place of JAX's ``dropout_rng`` key) runs the layers as a plain loop,
    each layer on its own stream drawn from ``dropout_rng``, outside any
    checkpoint (``gnnome_tpu/models/model.py:155-158``). Torch's streams are
    not JAX's: the same seed gives other masks.

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

    ``halo`` reaches the rows ``graph`` does not own (``models/gated_gcn.py``
    ``Halo``; the default, one card's, changes nothing): the sharded step
    passes its shard's graph and halo, and a recompute then runs the
    layer's collectives again, in the same order on every rank.
    """
    if remat not in REMAT_MODES:
        raise ValueError(f"unknown remat mode {remat!r}; one of {REMAT_MODES}")
    cdt = compute_dtype_of(compute_dtype)
    if cdt != torch.float32:
        params = _cast_params(params, cdt)
        pe, e_feat = pe.to(cdt), e_feat.to(cdt)
    h = linear(params["linear_pe"], pe)
    e = torch.relu(linear(params["linear1_edge"], e_feat))
    e = linear(params["linear2_edge"], e)
    layers = params["layers"]
    if dropout_rng is not None and dropout_rate > 0.0:
        for lp in layers:
            h, e = gated_gcn_layer(lp, graph, h, e, batch_norm=batch_norm,
                                   dropout_rate=dropout_rate,
                                   dropout_rng=_layer_rng(dropout_rng, h.device),
                                   wide_gathers=wide_gathers, halo=halo)
    else:
        def layer_fn(lp, h, e):
            # inside the checkpointed function: the recompute opens it again
            with span("model.layer"):
                return gated_gcn_layer(lp, graph, h, e, batch_norm=batch_norm,
                                       wide_gathers=wide_gathers, halo=halo)

        if remat == "none" or not torch.is_grad_enabled():
            # rebinding h, e frees each layer's input once nothing saved it
            for lp in layers:
                h, e = layer_fn(lp, h, e)
        else:
            g = 1 if remat == "layer" or len(layers) % remat_group else remat_group
            for i in range(0, len(layers), g):
                h, e = checkpoint(_layer_stack, layer_fn, layers[i: i + g], h, e,
                                  use_reentrant=False)
    return score_predictor(params, graph, h, e, halo).to(torch.float32)


def count_params(params) -> int:
    """Total parameter count (cf. ``train.py:96-112`` view_model_param)."""
    from gnnome_tpu_torch.train.checkpoint import iter_leaves

    return sum(leaf.numel() for _, leaf in iter_leaves(params))
