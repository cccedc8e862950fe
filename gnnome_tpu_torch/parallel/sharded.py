"""The sharded training step: full-graph GatedGCN over a ``data × graph``
mesh of ranks, on torch.distributed.

Counterpart of ``gnnome_tpu/parallel/sharded.py``, whose design it keeps
(owner computes, halo exchange; its docstring :1-57):

  * **nodes** are block-sharded over the ``graph`` axis (``N_pad / P``
    rows a rank) and every dense projection runs on the local block;
  * **each edge lives on the owner of its dst** (canonical order is
    dst-sorted, so a shard is a contiguous slice of it, its real edges
    first), with ONE gate and ONE edge state per edge;
  * the **forward aggregation** (into dst) is a local CSR walk. The
    **reverse aggregation** (into src) keys each edge on ``ref``, its src
    row in the combined ``[N_local + P·H]`` table (own block ‖ one halo
    segment of ``H`` rows per peer): remote src rows sum into their peer's
    halo slot, and one all-to-all returns those partial sums to their
    owners, which add them in by a segment sum over the send CSR
    (:func:`halo_reduce`, the transpose of :func:`halo_exchange`, which
    gathers the boundary ``b1h`` and ``a2h`` rows out). Communication grows
    with the edge cut, not with N (:func:`halo_comm_bytes`);
  * the edge-BatchNorm sums and the node-BatchNorm moments are all-reduced
    over the graph group, so the statistics are those of the whole graph;
  * **graphs** shard over the ``data`` axis, one graph per replica group.

There is no sharded layer: :func:`sharded_forward` runs ``model_forward``
(``models/model.py``, ``models/gated_gcn.py``, spans included) on
:attr:`RankShard.graph`, the shard as a graph whose src is ``ref``, whose
dst is the clamped ``key_local`` and whose by_src layout is the ref CSR
over ``N_local + P·H`` rows, with the collectives entering through
:class:`ShardHalo`, the layer's ``Halo`` seam. At P = 1 the halo is empty
and the step is the single-card step.

Gradients: every rank backpropagates its own share of the loss (its edges'
sum over the graph's real-edge count, over the data axis's size), the
collectives' backwards carry the cross-rank terms (an all-reduce's backward
all-reduces, an all-to-all's is the reverse all-to-all), and the parameter
gradients are then summed over the world, as ``shard_map``'s transpose sums
those of replicated parameters. Backpropagating the all-reduced loss on
every rank would give gradients P times too large.

What exists only for the TPU is not ported (``ROADMAP.md``, "Port the
function, not the TPU mechanism"): the band plans (``_plan_rows``, the
``*_w0/_wr/_gr`` fields), the streaming plans (``key_stream``,
``ref_stream``), the reverse-unsorted bounds (``canon_lo``/``canon_hi``,
``rev_banded``) and ``_shard_fused_supported``: the CUDA kernels take every
graph on one path.

Host batches are numpy (:func:`prepare_batch`, element for element JAX's
arrays, default padding included); :func:`shard_batch` moves one rank's
``[b, p]`` slice to its device as port CSRs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gnnome_tpu_torch.core.collectives import all_reduce_sum, all_to_all, reduce_
from gnnome_tpu_torch.core.graph import CSR, PAD_SEGMENT, AssemblyGraph
from gnnome_tpu_torch.models.gated_gcn import Halo
from gnnome_tpu_torch.models.model import model_forward
from gnnome_tpu_torch.ops.segment_sum import segment_sum
from gnnome_tpu_torch.ops.take import TakeRows, take_rows
from gnnome_tpu_torch.parallel.mesh import Mesh
from gnnome_tpu_torch.train.checkpoint import iter_leaves


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# host batch: the dst-owned edge sharding with its CSRs and halo maps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EdgeShard:
    """The (dst-owned, dst-sorted) edge sharding, numpy; leading dims
    ``[B, P, ...]``. The arrays and their meaning are JAX's ``EdgeShard``
    without its TPU plans (see the module docstring).

    ``ref`` indexes each edge's src endpoint into the combined
    ``[N_local + P·H]`` table; ``ref_canonical`` is ``ref`` with
    ``PAD_SEGMENT`` on padded edges, the key of the ref CSR (``ref_*``),
    which is both the layout of the reverse aggregation and the transpose
    of every combined-table gather. ``send_idx`` lists the local rows each
    peer needs (peer-major, ``[P·H]``), and the send CSR (``send_*``) adds
    returned halo partials into their owner rows."""

    mask: np.ndarray  # bool [B, P, E_b]
    key_local: np.ndarray  # int32: dst − node_base (PAD_SEGMENT on padding)
    offsets: np.ndarray  # int32 [B, P, N_local + 1] local CSR row pointers
    e_feat: np.ndarray  # f32 [B, P, E_b, 2]
    y: np.ndarray  # f32 [B, P, E_b]
    ref: np.ndarray  # int32 [B, P, E_b] → combined-table row per edge
    ref_order: np.ndarray  # int32 [B, P, E_b]
    ref_inv_order: np.ndarray  # int32 [B, P, E_b]
    ref_offsets: np.ndarray  # int32 [B, P, N_local + P·H + 1]
    ref_segment_ids: np.ndarray  # int32 [B, P, E_b]
    ref_canonical: np.ndarray  # int32 [B, P, E_b]
    send_idx: np.ndarray  # int32 [B, P, P·H] local rows to send, peer-major
    send_order: np.ndarray  # int32 [B, P, P·H]
    send_inv_order: np.ndarray  # int32 [B, P, P·H]
    send_offsets: np.ndarray  # int32 [B, P, N_local + 1]
    send_segment_ids: np.ndarray  # int32 [B, P, P·H]


@dataclasses.dataclass(frozen=True)
class ShardedBatch:
    node_mask: np.ndarray  # bool [B, N_pad]
    pe: np.ndarray  # f32 [B, N_pad, pe + 2]
    fwd: EdgeShard  # THE edge sharding: owned by the dst block, dst-sorted

    @property
    def n_nodes_padded(self) -> int:
        return self.node_mask.shape[1]


def _sorted_csr_arrays(keys: np.ndarray, n_rows: int) -> Dict[str, np.ndarray]:
    """Host-built CSR over an (unsorted) int key array: stable sort order,
    inverse, row offsets, and sorted segment ids. Keys ≥ n_rows (padding)
    sort last and carry PAD_SEGMENT."""
    keys = np.where(keys < n_rows, keys, PAD_SEGMENT).astype(np.int64)
    order = np.argsort(keys, kind="stable").astype(np.int32)
    inv_order = np.empty_like(order)
    inv_order[order] = np.arange(len(order), dtype=np.int32)
    key_sorted = keys[order]
    offsets = np.searchsorted(key_sorted, np.arange(n_rows + 1)).astype(np.int32)
    return {
        "order": order,
        "inv_order": inv_order,
        "offsets": offsets,
        "segment_ids": key_sorted.astype(np.int32),
    }


def _halo_sets(other_sorted_by_shard: List[np.ndarray], n_local: int,
               n_shards: int) -> Dict[Tuple[int, int], np.ndarray]:
    """R[(p, q)]: sorted unique global ids owned by p that shard q's edges
    reference as their non-keyed endpoint."""
    R: Dict[Tuple[int, int], np.ndarray] = {}
    for q in range(n_shards):
        oth = other_sorted_by_shard[q]
        owner = oth // n_local
        for p in range(n_shards):
            if p == q:
                continue
            R[(p, q)] = np.unique(oth[owner == p])
    return R


def _build_edge_shard(order: np.ndarray, key_sorted: np.ndarray, other_c: np.ndarray,
                      e_feat_c: np.ndarray, y_c: np.ndarray, n_real_edges: int,
                      n_pad: int, n_shards: int, e_bucket: int, h_halo: int,
                      R: Dict[Tuple[int, int], np.ndarray]) -> Dict[str, np.ndarray]:
    """One graph's shards: ``order`` permutes canonical positions into
    key-sorted order, ``key_sorted`` is the sorted keyed endpoint
    (PAD_SEGMENT on padding), ``other_c`` the non-keyed endpoint in
    canonical order."""
    n_local = n_pad // n_shards
    n_comb = n_local + n_shards * h_halo
    bounds = np.searchsorted(key_sorted[:n_real_edges], np.arange(n_shards + 1) * n_local)
    out = {
        "mask": np.zeros((n_shards, e_bucket), bool),
        "key_local": np.full((n_shards, e_bucket), PAD_SEGMENT, np.int32),
        "offsets": np.zeros((n_shards, n_local + 1), np.int32),
        "e_feat": np.zeros((n_shards, e_bucket, e_feat_c.shape[-1]), np.float32),
        "y": np.zeros((n_shards, e_bucket), np.float32),
        "ref": np.zeros((n_shards, e_bucket), np.int32),
        "ref_order": np.zeros((n_shards, e_bucket), np.int32),
        "ref_inv_order": np.zeros((n_shards, e_bucket), np.int32),
        "ref_offsets": np.zeros((n_shards, n_comb + 1), np.int32),
        "ref_segment_ids": np.zeros((n_shards, e_bucket), np.int32),
        "ref_canonical": np.full((n_shards, e_bucket), PAD_SEGMENT, np.int32),
        "send_idx": np.zeros((n_shards, n_shards * h_halo), np.int32),
        "send_order": np.zeros((n_shards, n_shards * h_halo), np.int32),
        "send_inv_order": np.zeros((n_shards, n_shards * h_halo), np.int32),
        "send_offsets": np.zeros((n_shards, n_local + 1), np.int32),
        "send_segment_ids": np.zeros((n_shards, n_shards * h_halo), np.int32),
    }
    for p in range(n_shards):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        cnt = hi - lo
        assert cnt <= e_bucket, (cnt, e_bucket)
        sel = order[lo:hi]
        oth = other_c[sel]
        out["mask"][p, :cnt] = True
        out["key_local"][p, :cnt] = key_sorted[lo:hi] - p * n_local
        out["e_feat"][p, :cnt] = e_feat_c[sel]
        out["y"][p, :cnt] = y_c[sel]
        out["offsets"][p] = np.searchsorted(out["key_local"][p, :cnt], np.arange(n_local + 1))

        # per-edge combined-table reference: own block rows map directly,
        # remote rows map to their slot in the peer's halo segment
        owner = oth // n_local
        ref = np.zeros(cnt, np.int64)
        local = owner == p
        ref[local] = oth[local] - p * n_local
        for r in range(n_shards):
            if r == p:
                continue
            m = owner == r
            if m.any():
                pos = np.searchsorted(R[(r, p)], oth[m])
                ref[m] = n_local + r * h_halo + pos
        out["ref"][p, :cnt] = ref
        ref_keys = np.full(e_bucket, PAD_SEGMENT, np.int64)
        ref_keys[:cnt] = ref
        out["ref_canonical"][p] = ref_keys
        csr = _sorted_csr_arrays(ref_keys, n_comb)
        out["ref_order"][p] = csr["order"]
        out["ref_inv_order"][p] = csr["inv_order"]
        out["ref_offsets"][p] = csr["offsets"]
        out["ref_segment_ids"][p] = csr["segment_ids"]

        # send lists: rows of p's block that each peer q needs (slot q)
        send_keys = np.full(n_shards * h_halo, PAD_SEGMENT, np.int64)
        for q in range(n_shards):
            if q == p:
                continue
            rows = R[(p, q)] - p * n_local
            send_keys[q * h_halo: q * h_halo + len(rows)] = rows
        out["send_idx"][p] = np.where(send_keys < n_local, send_keys, 0).astype(np.int32)
        csr = _sorted_csr_arrays(send_keys, n_local)
        out["send_order"][p] = csr["order"]
        out["send_inv_order"][p] = csr["inv_order"]
        out["send_offsets"][p] = csr["offsets"]
        out["send_segment_ids"][p] = csr["segment_ids"]
    return out


def prepare_batch(samples: Sequence, mesh: Mesh,
                  edge_bucket_multiple: int = 1024) -> ShardedBatch:
    """Stack graphs (``GraphSample``s: ``graph``, ``e_feat``, ``pe``, ``y``
    in canonical order) into the sharded host layout, one graph per index
    of the data axis. Padding as JAX's: ``N_pad`` a multiple of 512·P, the
    edge bucket of ``edge_bucket_multiple``, ``H`` of 1024 / P."""
    n_graph, n_data = mesh.graph, mesh.data
    if len(samples) != n_data:
        raise ValueError(f"batch of {len(samples)} graphs must equal data-axis size "
                         f"{n_data} (one graph per replica group)")
    n_pad = _round_up(max(s.graph.n_nodes_padded for s in samples), 512 * n_graph)
    n_local = n_pad // n_graph

    # pass 1: shard bounds (edge buckets) and halo sets (halo bucket); the
    # halo sets are the boundary src rows, in both roles
    per_graph = []
    max_bucket = max_halo = 0
    for s in samples:
        g = s.graph
        src_c, dst_c = _np(g.src), _np(g.dst)
        dst_key = np.where(np.arange(g.n_edges_padded) < g.n_edges, dst_c, PAD_SEGMENT)
        b = np.searchsorted(dst_key[: g.n_edges], np.arange(n_graph + 1) * n_local)
        max_bucket = max(max_bucket, int(np.diff(b).max()))
        R = _halo_sets([src_c[int(b[p]): int(b[p + 1])] for p in range(n_graph)],
                       n_local, n_graph)
        max_halo = max(max_halo, max((len(v) for v in R.values()), default=0))
        per_graph.append((s, dst_key, src_c, R))

    e_bucket = _round_up(max(max_bucket, 1), edge_bucket_multiple)
    h_halo = _round_up(max(max_halo, 1), max(1024 // n_graph, 1)) if n_graph > 1 else 0

    shards, node_masks, pes = [], [], []
    for s, key_sorted, other, R in per_graph:
        g = s.graph
        shards.append(_build_edge_shard(
            np.arange(g.n_edges_padded), key_sorted, other, _np(s.e_feat), _np(s.y),
            g.n_edges, n_pad, n_graph, e_bucket, h_halo, R))
        nm = np.zeros(n_pad, bool)
        nm[: g.n_nodes] = True
        node_masks.append(nm)
        pe = _np(s.pe)
        padded = np.zeros((n_pad, pe.shape[1]), np.float32)
        padded[: pe.shape[0]] = pe
        pes.append(padded)
    fwd = EdgeShard(**{k: np.stack([d[k] for d in shards]) for k in shards[0]})
    return ShardedBatch(node_mask=np.stack(node_masks), pe=np.stack(pes), fwd=fwd)


def halo_comm_bytes(batch: ShardedBatch, hidden: int = 256,
                    dtype_bytes: int = 2) -> Dict[str, int]:
    """Analytic per-rank per-layer traffic of the halo design vs the
    all-gather design it replaced (JAX's ``halo_comm_bytes``).

    Halo: one gather all-to-all of P·H [b1h ‖ a2h] rows (compute dtype)
    out, one reduce all-to-all of P·H [Σσ·a3h ‖ Σσ] partial-sum rows (f32)
    back. All-gather: each direction gathered a full [N_pad, 2·hidden]
    table.
    """
    n_shards = batch.fwd.send_idx.shape[1]
    send_slots = int(batch.fwd.send_idx.shape[-1])  # P·H
    n_pad = batch.n_nodes_padded
    row = 2 * hidden * dtype_bytes
    return {
        "halo_bytes_per_layer": send_slots * (row + 2 * hidden * 4),
        "all_gather_bytes_per_layer": 2 * (n_pad - n_pad // n_shards) * row,
        "halo_rows": send_slots,
        "n_pad": n_pad,
    }


# ---------------------------------------------------------------------------
# one rank's shard on its device
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RankShard:
    """Rank ``(b, p)``'s slice of a :class:`ShardedBatch` on its device.

    ``key`` is ``key_local`` clamped to a real row (the gathers' ids),
    ``by_key`` the local identity CSR over ``N_local`` rows (its key keeps
    ``PAD_SEGMENT``); ``ref`` and ``by_ref`` (over ``N_local + P·H``) the
    combined-table endpoint and its CSR; ``by_send`` (over ``N_local``) the
    CSR of the halo's send list, whose key is ``send_idx`` with
    ``PAD_SEGMENT`` on the unused slots. ``n_real``: this shard's
    real edges (they lead its bucket); ``n_real_graph``: the graph's.
    ``graph``: the shard as a graph (src ``ref``, dst ``key``, by_src
    ``by_ref``, by_dst ``by_key``, ``n_edges`` ``n_real``, edge_mask ``mask``)."""

    n_local: int
    n_halo: int  # P·H
    n_real: int
    n_real_graph: int
    node_mask: torch.Tensor
    pe: torch.Tensor
    mask: torch.Tensor
    e_feat: torch.Tensor
    y: torch.Tensor
    key: torch.Tensor
    ref: torch.Tensor
    by_key: CSR
    by_ref: CSR
    by_send: CSR
    graph: AssemblyGraph


def shard_batch(batch: ShardedBatch, mesh: Mesh) -> RankShard:
    """This rank's ``[data_index, graph_index]`` slice, on the mesh's device."""
    b, p = mesh.data_index, mesh.graph_index
    f = {k.name: getattr(batch.fwd, k.name)[b, p] for k in dataclasses.fields(EdgeShard)}
    n_local = f["offsets"].shape[0] - 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)

    key_local = t(f["key_local"])
    send_key = f["send_segment_ids"][f["send_inv_order"]]  # canonical order
    own_rows = batch.node_mask[b, p * n_local: (p + 1) * n_local]
    own_order = np.arange(f["mask"].shape[0])  # a shard's edges are in its own order
    graph = AssemblyGraph(
        n_nodes=int(own_rows.sum()),
        n_edges=int(f["mask"].sum()),
        src=t(f["ref"]),
        dst=t(np.where(f["key_local"] < n_local, f["key_local"], 0)),
        node_mask=t(own_rows),
        edge_mask=t(f["mask"]),
        by_dst=CSR(key=key_local, order=None, segment_ids=key_local, offsets=t(f["offsets"])),
        by_src=CSR(key=t(f["ref_canonical"]), order=t(f["ref_order"]),
                   segment_ids=t(f["ref_segment_ids"]), offsets=t(f["ref_offsets"]),
                   inv_order=t(f["ref_inv_order"])),
        edge_perm=own_order,
        edge_inv_perm=own_order,
    )
    return RankShard(
        n_local=n_local,
        n_halo=f["send_idx"].shape[0],
        n_real=graph.n_edges,
        n_real_graph=int(batch.fwd.mask[b].sum()),
        node_mask=graph.node_mask,
        pe=t(batch.pe[b, p * n_local: (p + 1) * n_local]),
        mask=graph.edge_mask,
        e_feat=t(f["e_feat"]),
        y=t(f["y"]),
        key=graph.dst,
        ref=graph.src,
        by_key=graph.by_dst,
        by_ref=graph.by_src,
        by_send=CSR(key=t(send_key), order=t(f["send_order"]),
                    segment_ids=t(f["send_segment_ids"]), offsets=t(f["send_offsets"]),
                    inv_order=t(f["send_inv_order"])),
        graph=graph,
    )


# ---------------------------------------------------------------------------
# halo exchange and reduce
# ---------------------------------------------------------------------------


class _SegmentSum(torch.autograd.Function):
    """:func:`segment_sum` whose gradient is the row gather along the CSR's
    key (zero rows on padded slots)."""

    @staticmethod
    def forward(ctx, data, csr: CSR):
        ctx.csr, ctx.dtype = csr, data.dtype
        return segment_sum(data, csr)

    @staticmethod
    def backward(ctx, g):
        return take_rows(g.contiguous(), ctx.csr.key).to(ctx.dtype), None


def halo_exchange(tables: Sequence[torch.Tensor], shard: RankShard,
                  mesh: Mesh) -> List[torch.Tensor]:
    """``[N_local, W]`` tables → combined ``[N_local + P·H, W]`` tables (own
    rows ‖ halo rows), each contiguous: the boundary rows of every table
    gathered into one peer-major send buffer (row gather kernel, gradient
    the segment sum over the send CSR), one all-to-all, and each table's
    columns of what came back appended to its own rows. The kernels need
    contiguous rows, so the tables come back apart, not as one wider table
    to slice. The unused send slots are gathered as zero rows (by the send
    CSR's key, ``PAD_SEGMENT`` there, where JAX gathers row 0 of
    ``send_idx``; no edge reads them), which makes the pair an exact
    adjoint. Traffic ∝ edge cut, not N."""
    if shard.n_halo == 0:
        return list(tables)
    sent = [TakeRows.apply(t, shard.by_send.key, shard.by_send) for t in tables]
    recv = all_to_all(torch.cat(sent, dim=-1) if len(sent) > 1 else sent[0],
                      mesh.graph_group)
    parts = recv.split([t.shape[1] for t in tables], dim=-1)
    return [torch.cat([t, r]) for t, r in zip(tables, parts)]


def halo_reduce(comb: torch.Tensor, shard: RankShard, mesh: Mesh) -> torch.Tensor:
    """``[N_local + P·H, W]`` partial sums → ``[N_local, W]`` complete sums,
    the transpose of :func:`halo_exchange`: halo slot ``(r, pos)`` holds this
    rank's part of a row owned by peer ``r``; one all-to-all routes every
    slot to its owner, where the rows land in the send CSR's peer-major
    layout and its segment sum adds them into the local block."""
    if shard.n_halo == 0:
        return comb
    local, halo = comb[: shard.n_local], comb[shard.n_local:]
    remote = _SegmentSum.apply(all_to_all(halo, mesh.graph_group), shard.by_send)
    return local + remote.to(local.dtype)


# ---------------------------------------------------------------------------
# the sharded model
# ---------------------------------------------------------------------------


class ShardHalo(Halo):
    """The layer's ``Halo`` (``models/gated_gcn.py``) on a rank's shard:
    :func:`halo_exchange`, :func:`halo_reduce`, the gate front's sums
    all-reduced over the graph group (each real edge counted once, on its
    dst's owner) over the graph's real edges, and the graph group."""

    def __init__(self, shard: RankShard, mesh: Mesh):
        self.shard, self.mesh, self.group = shard, mesh, mesh.graph_group

    def exchange(self, tables):
        return halo_exchange(tables, self.shard, self.mesh)

    def reduce(self, sums):
        return halo_reduce(sums, self.shard, self.mesh)

    def edge_moments(self, mom, n_edges):
        return super().edge_moments(all_reduce_sum(mom, self.group), self.shard.n_real_graph)


def sharded_forward(params: Dict, shard: RankShard, mesh: Mesh, batch_norm: bool = True,
                    remat: str = "layer", compute_dtype: str = "float32",
                    remat_group: int = 4) -> torch.Tensor:
    """This shard's edge logits, f32 ``[E_b]`` (rows past ``n_real`` are
    padding): ``model_forward`` on :attr:`RankShard.graph` through the
    shard's :class:`ShardHalo`, with its ``remat`` and ``compute_dtype``."""
    return model_forward(params, shard.graph, shard.e_feat, shard.pe, batch_norm=batch_norm,
                         remat=remat, remat_group=remat_group, compute_dtype=compute_dtype,
                         halo=ShardHalo(shard, mesh))


def make_sharded_loss(mesh: Mesh, batch_norm: bool = True, remat: str = "layer",
                      compute_dtype: str = "float32", remat_group: int = 4):
    """``loss_fn(params, shard, pos_weight) -> (loss, share)``: the
    masked BCE-with-logits with ``pos_weight``, averaged over each graph's
    real edges and then over the data axis. ``loss`` is its value, the same
    on every rank, without gradient; ``share`` is this rank's differentiable
    part of it (its edges' sum over its graph's real-edge count, over the
    data axis's size; the shares of all ranks sum to ``loss``). Backpropagate
    ``share`` and then :func:`all_reduce_gradients`."""

    def loss_fn(params, shard: RankShard, pos_weight):
        logits = sharded_forward(params, shard, mesh, batch_norm=batch_norm, remat=remat,
                                 compute_dtype=compute_dtype, remat_group=remat_group)
        y, m = shard.y, shard.mask.to(torch.float32)
        per_edge = -(pos_weight * y * torch.nn.functional.logsigmoid(logits)
                     + (1.0 - y) * torch.nn.functional.logsigmoid(-logits))
        share = torch.sum(per_edge * m) / float(max(shard.n_real_graph, 1))
        if mesh.data > 1:
            share = share / float(mesh.data)
        loss = reduce_(share.detach().clone(), mesh.world_group)
        return loss, share

    return loss_fn


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    i = 0
    for t in tensors:
        t.copy_(flat[i: i + t.numel()].view_as(t))
        i += t.numel()


@torch.no_grad()
def all_reduce_gradients(params: Dict, mesh: Mesh) -> None:
    """Sum every parameter's gradient over the world (one all-reduce of the
    flattened gradients); a no-op at world size 1."""
    if mesh.world_group is None:
        return
    leaves = [leaf for _, leaf in iter_leaves(params)]
    grads = [leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
             for leaf in leaves]
    flat = reduce_(_flat(grads), mesh.world_group)
    for leaf, g in zip(leaves, grads):
        leaf.grad = g
    _unflat_(flat, grads)


@torch.no_grad()
def replicate_to_mesh(params: Dict, mesh: Mesh) -> Dict:
    """Every rank's parameters set to global rank 0's (one broadcast of the
    flattened leaves, in place); a no-op at world size 1. Returns
    ``params``."""
    if mesh.world_group is None:
        return params
    leaves = [leaf for _, leaf in iter_leaves(params)]
    flat = _flat(leaves)
    dist.broadcast(flat, src=0, group=mesh.world_group)
    _unflat_(flat, leaves)
    return params


def make_sharded_train_step(mesh: Mesh, batch_norm: bool = True, remat: str = "layer",
                            compute_dtype: str = "float32", remat_group: int = 4):
    """``step(params, opt, shard, pos_weight) -> loss``: the sharded loss,
    its gradients summed over the world, and the Adam update of
    ``train/loop.py:make_optimizer`` in place, as ``train_step`` does. Start
    every rank from the same parameters (:func:`replicate_to_mesh`); the
    summed gradients are the same on every rank, so the parameters stay
    equal bit for bit."""
    loss_fn = make_sharded_loss(mesh, batch_norm=batch_norm, remat=remat,
                                compute_dtype=compute_dtype, remat_group=remat_group)

    def step(params, opt: torch.optim.Optimizer, shard: RankShard, pos_weight):
        opt.zero_grad(set_to_none=True)
        loss, share = loss_fn(params, shard, pos_weight)
        share.backward()
        all_reduce_gradients(params, mesh)
        opt.step()
        return loss

    return step
