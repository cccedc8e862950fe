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

Every branch runs on kernels, following the JAX layer line by line
(``gnnome_tpu/models/gated_gcn.py:95-239``):

* ``batch_norm=True`` (the shipped models): gate front (gather + B3
  product + moments), gate epilog with the forward aggregation, and the
  reverse aggregation; the edge BatchNorm's statistics taken from ``mom``
  stay plain autograd, which carries ``d_mom`` into the gate front's
  backward; the node BatchNorm with its ReLU and residual in one kernel
  pair each way;
* ``batch_norm=False`` (LayerNorm): the same gate front, its moments left
  unread and out of its backward (where JAX adds two endpoint gathers and
  ``B3·e``), the LayerNorm with its ReLU and residual in one row kernel
  (edge and node norm alike), the forward aggregation with the gather
  inside the σ-aggregate kernel, and the reverse aggregation;
* ``wide_gathers`` (``True`` / ``"src"``): the endpoint tables are gathered
  in pairs at width 2D (``[b1h‖a2h]`` by src, ``[b2h‖a3h]`` by dst, or
  ``b2h`` alone for ``"src"``), the BatchNorm statistics come from
  ``masked_moments(gate)``, and the epilog and aggregations read the
  pregathered halves.

Every sum on these paths is a fixed-order CSR walk (no float atomics), so
a checkpointed layer's recompute reproduces its forward bit for bit.
Under bf16 compute (``h``, ``e`` and the parameters bf16; every branch)
the BatchNorm moments, the folded affine and the aggregation sums stay
f32, the LayerNorm and the wide gate's adds run in bf16, and ``h_fwd`` /
``h_bwd`` return to bf16, as in JAX (``gnnome_tpu/models/gated_gcn.py``).
The gate front rounds as the TPU kernel does (``ops/gate_front.py``), so
the LayerNorm gate takes one rounding fewer than JAX's two bf16 adds.
Dropout, as in JAX, is applied to ``h`` after the residual when a rate and
a generator are given.

Besides the ``norm`` spans of ``ops/norm.py``, two spans
(``utils/profiling.py``) mark the layer's other parts: ``gate``, the edge
gate's assembly up to the pre-norm ``gate`` (the gate front on both norm
branches; the wide gathers, ``B3·e`` and the adds on the wide ones),
and ``aggregate``, from the σ sums to ``a1h + h_fwd + h_bwd`` (on the
BatchNorm branch with the gate epilog, which holds ``e_new`` and the
forward sums). Neither holds a norm.

The graph may be one rank's shard of a larger one (``parallel/sharded.py``):
``halo`` (:class:`Halo`) then completes what reaches past it, the endpoint
tables ``b1h`` and ``a2h`` (the gate front reads ``b1h``'s contiguous
own ‖ halo table on both norm branches), the reverse σ sums before their
division, the edge BatchNorm's moments and the node BatchNorm's group.
The default, :data:`ONE_CARD`, returns what it is given, so on one card
the layer runs the same kernels in the same order. The wide-gather branches run on one
card only.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from gnnome_tpu_torch.core.graph import AssemblyGraph
from gnnome_tpu_torch.models.common import init_linear, init_norm, linear
from gnnome_tpu_torch.ops.norm import (
    batch_norm_relu_residual, layer_norm_relu_residual, masked_moments)
from gnnome_tpu_torch.ops.segment import (
    fused_gate_front,
    fused_gate_sigma_aggregate,
    fused_gate_sigma_gather,
    gated_aggregate,
    gated_aggregate_pregathered,
    gated_mean,
    gated_sums_by_src,
    gather_by_endpoint,
)
from gnnome_tpu_torch.utils.profiling import span

WIDE_GATHERS = (False, True, "src")


class Halo:
    """One card's halo, where the graph owns every row: each member returns
    what it is given. A shard's (``parallel/sharded.py``) overrides them:
    ``exchange`` maps ``[N, W]`` tables to ``[N + halo, W]`` ones (own rows
    ‖ halo rows), ``reduce`` is its transpose, ``edge_moments`` takes the
    gate's mean and variance from the gate front's ``[Σ gate ‖ Σ gate²]``
    (f32 [2, D]) over ``n_edges`` real edges, and ``group`` is the node
    BatchNorm's process group."""

    group = None

    def exchange(self, tables):
        return tables

    def reduce(self, sums):
        return sums

    def edge_moments(self, mom: torch.Tensor, n_edges: int):
        cnt = float(max(n_edges, 1))
        mean = mom[0] / cnt
        return mean, torch.clamp(mom[1] / cnt - mean * mean, min=0.0)


ONE_CARD = Halo()


def init_gated_gcn_layer(gen: torch.Generator, dim: int, device="cuda") -> Dict:
    params = {n: init_linear(gen, dim, dim, device)
              for n in ("A1", "A2", "A3", "B1", "B2", "B3")}
    params["norm_h"] = init_norm(dim, device)
    params["norm_e"] = init_norm(dim, device)
    return params


def gated_gcn_layer(params: Dict, graph: AssemblyGraph, h: torch.Tensor,
                    e: torch.Tensor, batch_norm: bool = True,
                    dropout_rate: float = 0.0,
                    dropout_rng: Optional[torch.Generator] = None,
                    eps: float = 1e-6,
                    wide_gathers=False,
                    halo: Halo = ONE_CARD) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer; ``dropout_rng`` is a generator on ``h``'s device, ``halo``
    the seam to rows the graph does not own (:class:`Halo`)."""
    if wide_gathers not in WIDE_GATHERS:
        raise ValueError(f"wide_gathers={wide_gathers!r}; one of {WIDE_GATHERS}")
    h_in, e_in = h, e
    d = h.shape[-1]
    a1h = linear(params["A1"], h)
    a2h = linear(params["A2"], h)
    a3h = linear(params["A3"], h)
    b1h = linear(params["B1"], h)
    b2h = linear(params["B2"], h)
    b1h, a2h = halo.exchange([b1h, a2h])

    a3_dst = mom = None
    with span("gate"):
        if not wide_gathers:
            gate, mom = fused_gate_front(b1h, b2h, e, params["B3"]["w"],
                                         params["B3"]["b"], graph, moments=batch_norm)
        else:
            b3e = linear(params["B3"], e)
            src_rows = gather_by_endpoint(torch.cat([b1h, a2h], dim=-1), graph.src,
                                          graph.by_src)
            if wide_gathers == "src":
                dst_rows = gather_by_endpoint(b2h, graph.dst, graph.by_dst)
                gate = src_rows[:, :d] + dst_rows + b3e
            else:
                dst_rows = gather_by_endpoint(torch.cat([b2h, a3h], dim=-1), graph.dst,
                                              graph.by_dst)
                gate = src_rows[:, :d] + dst_rows[:, :d] + b3e
                a3_dst = dst_rows[:, d:]
            a2_src = src_rows[:, d:]

    if batch_norm:
        with span("norm"):
            if mom is not None:
                mean, var = halo.edge_moments(mom, graph.n_edges)
            else:
                mean, var = masked_moments(gate, graph.edge_mask)
            # the affine in f32 whatever the compute dtype
            # (gnnome_tpu/models/gated_gcn.py:151-152)
            scale2 = torch.rsqrt(var + 1e-5) * params["norm_e"]["scale"].to(torch.float32)
            bias2 = params["norm_e"]["bias"].to(torch.float32) - mean * scale2
            affine = torch.stack([scale2, bias2])
    else:
        e_new = layer_norm_relu_residual(gate, params["norm_e"]["scale"],
                                         params["norm_e"]["bias"], e_in)
    with span("aggregate"):
        if batch_norm:
            if wide_gathers:
                sum_f, e_new = fused_gate_sigma_aggregate(gate, e_in, a2_src, affine,
                                                          graph.by_dst)
            else:
                sum_f, e_new = fused_gate_sigma_gather(gate, e_in, a2h, affine, graph)
            h_fwd = gated_mean(sum_f, eps)
        elif wide_gathers:
            h_fwd = gated_aggregate_pregathered(a2_src, e_new, graph.by_dst, eps)
        else:
            h_fwd = gated_aggregate(a2h, e_new, graph.src, graph.by_src, graph.by_dst,
                                    eps)
        if a3_dst is not None:
            h_bwd = gated_aggregate_pregathered(a3_dst, e_new, graph.by_src, eps)
        else:
            h_bwd = gated_mean(halo.reduce(gated_sums_by_src(a3h, e_new, graph)), eps)
        h = a1h + h_fwd.to(h_in.dtype) + h_bwd.to(h_in.dtype)
    if batch_norm:
        h = batch_norm_relu_residual(h, graph.node_mask, params["norm_h"]["scale"],
                                     params["norm_h"]["bias"], h_in, group=halo.group)
    else:
        h = layer_norm_relu_residual(h, params["norm_h"]["scale"], params["norm_h"]["bias"],
                                     h_in)
    if dropout_rate > 0.0 and dropout_rng is not None:
        keep = torch.rand(h.shape, generator=dropout_rng, device=h.device) \
            < 1.0 - dropout_rate
        h = torch.where(keep, h / (1.0 - dropout_rate), 0.0)
    return h, e_new
