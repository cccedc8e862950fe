"""Array-based assembly graph on torch tensors.

Counterpart of ``gnnome_tpu/core/graph.py``. The graph is a COO edge list
in **canonical edge order** (stable-sorted by destination, padding last)
plus two CSR layouts over it:

* ``by_dst``: canonical order itself, so forward aggregation walks
  ``offsets[v]:offsets[v+1]`` contiguously;
* ``by_src``: a permutation ``order`` of canonical positions sorted
  (stably) by source, for the reverse aggregation, with its inverse
  ``inv_order`` and the opposite endpoint in that order, ``opp_ids``.

Only what the GPU path reads is built. The JAX package's band plans,
streaming plans and canonical-position bounds exist for the TPU's
windowed gathers and are not computed here; every graph, banded or not,
takes the same kernel path. Padding is optional (``*_pad_multiple=1`` by
default): it exists so the tests can build the same padded layout as the
JAX package, and every consumer masks it.

Domain invariants kept from the reference: read ``i`` yields nodes ``2i``
(forward strand) and ``2i+1`` (reverse complement); ``node ^ 1`` flips
strand; the graph is directed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Key assigned to padded edges: larger than any real node id, so CSR
# offsets and masked sums drop them.
PAD_SEGMENT = 2**30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class CSR:
    """One directional layout of the edge set.

    ``key``: int32[E_pad] keyed endpoint of each edge in canonical order,
    ``PAD_SEGMENT`` on padding. ``order``: int32[E_pad] canonical positions
    in this layout's sorted order, ``None`` when canonical order already is
    this layout. ``segment_ids``: ``key[order]`` (sorted). ``offsets``:
    int32[N_pad + 1]; ``offsets[v]:offsets[v+1]`` indexes the sorted
    edges keyed on node ``v``. ``inv_order``: int32[E_pad], the sorted
    position of each canonical edge (``inv_order[order] = arange``).
    ``opp_ids``: int32[E_pad], the opposite endpoint of each edge in sorted
    order (``dst[order]`` for ``by_src``, padding clamped to 0). Both are
    ``None`` when canonical order already is this layout.
    """

    key: torch.Tensor
    order: Optional[torch.Tensor]
    segment_ids: torch.Tensor
    offsets: torch.Tensor
    inv_order: Optional[torch.Tensor] = None
    opp_ids: Optional[torch.Tensor] = None

    @property
    def identity(self) -> bool:
        return self.order is None


@dataclasses.dataclass(frozen=True)
class AssemblyGraph:
    """Canonical (dst-sorted) assembly graph. ``n_nodes``/``n_edges`` are
    the real counts; tensors may carry padding past them."""

    n_nodes: int
    n_edges: int
    src: torch.Tensor  # int32[E_pad] canonical order, padding clamped to 0
    dst: torch.Tensor  # int32[E_pad] canonical order, padding clamped to 0
    node_mask: torch.Tensor  # bool[N_pad]
    edge_mask: torch.Tensor  # bool[E_pad]
    by_dst: CSR
    by_src: CSR
    edge_perm: np.ndarray  # int64[E_pad]: canonical[i] = original[edge_perm[i]]
    edge_inv_perm: np.ndarray  # int64[E_pad]: original[j] = canonical[edge_inv_perm[j]]

    @property
    def n_nodes_padded(self) -> int:
        return self.node_mask.shape[0]

    @property
    def n_edges_padded(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.src.device


def _offsets(sorted_key: np.ndarray, n_pad: int) -> np.ndarray:
    n_real = int((sorted_key < PAD_SEGMENT).sum())
    return np.searchsorted(sorted_key[:n_real], np.arange(n_pad + 1)).astype(
        np.int32)


def build_graph(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    node_pad_multiple: int = 1,
    edge_pad_multiple: int = 1,
    device="cuda",
) -> AssemblyGraph:
    """Build an :class:`AssemblyGraph` from COO edge arrays in any order.

    Host work is numpy (two stable argsorts, a searchsorted and two
    permutations), linear in the edge count apart from the sorts; tensors are then moved to
    ``device``.
    """
    device = torch.device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    n_edges = int(src.shape[0])
    if n_edges and (min(src.min(), dst.min()) < 0
                    or max(src.max(), dst.max()) >= n_nodes):
        raise ValueError("edge endpoint out of range [0, n_nodes)")
    n_pad = _round_up(max(n_nodes, 1), node_pad_multiple)
    e_pad = _round_up(max(n_edges, 1), edge_pad_multiple)

    edge_mask = np.arange(e_pad) < n_edges
    src_p = np.zeros(e_pad, np.int32)
    dst_p = np.zeros(e_pad, np.int32)
    src_p[:n_edges] = src
    dst_p[:n_edges] = dst

    dst_key = np.where(edge_mask, dst_p, PAD_SEGMENT).astype(np.int32)
    edge_perm = np.argsort(dst_key, kind="stable")
    edge_inv_perm = np.empty_like(edge_perm)
    edge_inv_perm[edge_perm] = np.arange(e_pad)
    src_c, dst_c, dst_key_c = src_p[edge_perm], dst_p[edge_perm], dst_key[edge_perm]
    src_key_c = np.where(edge_mask, src_c, PAD_SEGMENT).astype(np.int32)
    src_order = np.argsort(src_key_c, kind="stable").astype(np.int32)
    src_inv_order = np.empty_like(src_order)
    src_inv_order[src_order] = np.arange(e_pad, dtype=np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dst_key_t = t(dst_key_c)
    by_dst = CSR(key=dst_key_t, order=None, segment_ids=dst_key_t,
                 offsets=t(_offsets(dst_key_c, n_pad)))
    src_sorted = src_key_c[src_order]
    by_src = CSR(key=t(src_key_c), order=t(src_order),
                 segment_ids=t(src_sorted), offsets=t(_offsets(src_sorted, n_pad)),
                 inv_order=t(src_inv_order), opp_ids=t(dst_c[src_order]))
    return AssemblyGraph(
        n_nodes=n_nodes,
        n_edges=n_edges,
        src=t(src_c),
        dst=t(dst_c),
        node_mask=t(np.arange(n_pad) < n_nodes),
        edge_mask=t(edge_mask),
        by_dst=by_dst,
        by_src=by_src,
        edge_perm=edge_perm,
        edge_inv_perm=edge_inv_perm,
    )


def canonicalize_edge_features(graph: AssemblyGraph, arr: np.ndarray) -> np.ndarray:
    """Reorder a padded per-edge array from original (parser) order into
    canonical (dst-sorted) order."""
    return np.asarray(arr)[graph.edge_perm]


def decanonicalize_edge_values(graph: AssemblyGraph, arr: np.ndarray) -> np.ndarray:
    """Inverse of :func:`canonicalize_edge_features`."""
    return np.asarray(arr)[graph.edge_inv_perm]


def pad_features(arr: np.ndarray, padded_len: int, dtype=np.float32) -> np.ndarray:
    """Zero-pad a [n, ...] array to [padded_len, ...]."""
    arr = np.asarray(arr, dtype=dtype)
    if arr.shape[0] == padded_len:
        return arr
    pad_width = [(0, padded_len - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width)


def prepare_edge_features(graph: AssemblyGraph, arr: np.ndarray,
                          dtype=np.float32) -> torch.Tensor:
    """Unpadded per-edge array (parser order) → padded canonical tensor on
    the graph's device."""
    padded = pad_features(arr, graph.n_edges_padded, dtype)
    return torch.from_numpy(
        np.ascontiguousarray(canonicalize_edge_features(graph, padded))
    ).to(graph.device)


def extract_edge_values(graph: AssemblyGraph, arr) -> np.ndarray:
    """Padded canonical tensor → unpadded parser-order numpy array."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return decanonicalize_edge_values(graph, arr)[: graph.n_edges]


def degrees(graph: AssemblyGraph) -> tuple[torch.Tensor, torch.Tensor]:
    """(in_degree, out_degree) as float32[N_pad], zero on padding
    (``utils.py:102-103`` of the reference)."""
    n_pad = graph.n_nodes_padded
    ones = graph.edge_mask.to(torch.float32)
    zeros = torch.zeros(n_pad, dtype=torch.float32, device=graph.device)
    in_deg = zeros.index_add(0, graph.dst, ones)
    out_deg = zeros.index_add(0, graph.src, ones)
    return in_deg, out_deg
