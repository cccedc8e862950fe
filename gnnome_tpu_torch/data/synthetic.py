"""Synthetic assembly-like graph at chromosome scale (counterpart of
``bench.py:build_bench_graph``).

Two strand chains (``0→2→4…`` and its reverse-complement mirror) plus
random short skip edges emulating transitive overlaps; ``frac_long``
rewires that share of the skips to uniform-random destinations, the
cross-locus edges repeat families induce. At 150k nodes / ~1M edges this is
the size of a simulated chr19 graph. Host numpy throughout (no per-edge
Python loop), so it builds in seconds at that size.
"""
from __future__ import annotations

import numpy as np
import torch

from gnnome_tpu_torch.core.graph import (
    AssemblyGraph, build_graph, pad_features, prepare_edge_features)
from gnnome_tpu_torch.data.pe import pagerank_pe_np


def bench_edges(n_nodes: int, n_edges: int, seed: int = 0,
                frac_long: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) int32 arrays, self-loops removed, from ``seed``."""
    rng = np.random.default_rng(seed)
    half = n_nodes // 2
    fwd = np.arange(half - 1, dtype=np.int64)
    src = [2 * fwd, 2 * (fwd + 1) + 1]
    dst = [2 * (fwd + 1), 2 * fwd + 1]
    extra = n_edges - 2 * (half - 1)
    if extra > 0:
        s = rng.integers(0, n_nodes, extra)
        offs = rng.integers(2, 12, extra)
        d = np.minimum(s + 2 * offs, n_nodes - 1)
        n_long = int(extra * frac_long)
        if n_long:
            d[:n_long] = rng.integers(0, n_nodes, n_long)
        src.append(s)
        dst.append(d)
    src = np.concatenate(src).astype(np.int32)
    dst = np.concatenate(dst).astype(np.int32)
    keep = src != dst
    return src[keep], dst[keep]


def build_bench_graph(n_nodes: int, n_edges: int, seed: int = 0,
                      frac_long: float = 0.0,
                      device="cuda") -> tuple[AssemblyGraph, int]:
    """(graph, real edge count), the same edges as the JAX package's bench."""
    src, dst = bench_edges(n_nodes, n_edges, seed, frac_long)
    return build_graph(src, dst, n_nodes, device=device), int(src.shape[0])


def bench_features(graph: AssemblyGraph, seed: int, nb_pos_enc: int):
    """``(e_feat, pe)`` on the graph's device: standard-normal edge features
    from ``seed`` ([E_pad, 2], canonical order) and the real node features
    ``[in_deg ‖ out_deg ‖ PageRank PE]`` ([N_pad, nb_pos_enc + 2])."""
    n = graph.n_nodes
    src = graph.src[: graph.n_edges].cpu().numpy()
    dst = graph.dst[: graph.n_edges].cpu().numpy()
    rng = np.random.default_rng(seed)
    e_feat = rng.standard_normal((graph.n_edges_padded, 2)).astype(np.float32)
    pe = np.concatenate([
        np.bincount(dst, minlength=n)[:, None].astype(np.float32),
        np.bincount(src, minlength=n)[:, None].astype(np.float32),
        pagerank_pe_np(src, dst, n, nb_pos_enc)], axis=1)
    return (torch.from_numpy(e_feat).to(graph.device),
            torch.from_numpy(pad_features(pe, graph.n_nodes_padded)).to(graph.device))


def bench_labels(graph: AssemblyGraph, seed: int) -> torch.Tensor:
    """Edge labels of the JAX package's bench (``bench.py:106-107``): each
    real edge positive with probability 0.7 (``bench.py`` trains on them
    with pos_weight 0.5), drawn from ``seed`` in edge-list order; f32[E_pad]
    in canonical order on the graph's device, zero on padding."""
    rng = np.random.default_rng(seed)
    return prepare_edge_features(graph, (rng.random(graph.n_edges) < 0.7).astype(np.float32))
