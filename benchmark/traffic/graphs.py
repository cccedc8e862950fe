"""The one traffic generator: chromosome-scale assembly-like graphs from a seed.

Frozen copies of the program's generators, so that a later change to the
program cannot change the benchmark's inputs:

* :func:`bench_edges` is ``gnnome_tpu_torch/data/synthetic.py``
  ``bench_edges`` (itself ``bench.py:34-62``);
* :func:`node_features` is that file's ``bench_features`` with
  ``gnnome_tpu_torch/data/pe.py`` ``pagerank_pe_np``, on host arrays in
  edge-list order (the program's version draws the edge features in its own
  canonical order, which the benchmark must not depend on);
* :func:`edge_labels` is ``bench_labels`` (``bench.py:106-107``);
* :func:`distinct_edges`, :func:`adjacency_lists` and :func:`read_lengths`
  are ``chip_smoke.py``'s ``decode_problem``, ``adjacency_lists`` and
  ``read_lengths``.

A traffic file (``benchmark/workloads/<traffic>.json``) gives the sizes;
graph ``g`` of a run with seed ``s`` is drawn from ``n_graphs * s + g``,
so every seed gives the same sizes and shares of edges, on other graphs.
Where the work a graph asks for varies from graph to graph more than a
run's noise (decoding, the ClusterGCN sampler), the file fixes the set and
its order (``graph_seed``): the run's seed then draws the weights, or the
graph whose answers are checked.
"""
from __future__ import annotations

import numpy as np


def frac_long(cross_locus: float, n_nodes: int, n_edges: int) -> float:
    """The share of ``bench_edges``' skip edges to rewire so that
    ``cross_locus`` of all edges join random loci (``chip_smoke.py``
    ``FRAC_LONG``; 11.93% of real graphs' edges, ``PERFORMANCE.md:18``)."""
    return cross_locus * n_edges / (n_edges - n_nodes)


def bench_edges(n_nodes: int, n_edges: int, seed: int = 0,
                frac_long: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) int32 arrays, self-loops removed, from ``seed``: two strand
    chains plus random short skip edges, ``frac_long`` of them rewired to
    uniform-random destinations."""
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


def pagerank_pe(src: np.ndarray, dst: np.ndarray, n: int, k: int,
                alpha: float = 0.95) -> np.ndarray:
    """k-step PageRank PE (the reference's ``utils.py:97-140``): every
    iterate of ``x <- alpha * P x + (1 - alpha) / n`` is one column."""
    out_deg = np.bincount(src, minlength=n).astype(np.float64)
    inv_out = np.where(out_deg > 1e-9, 1.0 / (out_deg + 1e-9), 0.0)
    x = np.full(n, 1.0 / n)
    cols = []
    for _ in range(k):
        contrib = x[src] * inv_out[src]
        x = alpha * np.bincount(dst, weights=contrib, minlength=n) + (1.0 - alpha) / n
        cols.append(x.astype(np.float32))
    return np.stack(cols, axis=-1)


def node_features(src: np.ndarray, dst: np.ndarray, n: int, nb_pos_enc: int,
                  seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``(e_feat, pe)`` in edge-list order: standard-normal edge features
    f32[E, 2] from ``seed`` and the node features
    ``[in_deg | out_deg | PageRank PE]`` f32[n, nb_pos_enc + 2]."""
    rng = np.random.default_rng(seed)
    e_feat = rng.standard_normal((len(src), 2)).astype(np.float32)
    pe = np.concatenate([
        np.bincount(dst, minlength=n)[:, None].astype(np.float32),
        np.bincount(src, minlength=n)[:, None].astype(np.float32),
        pagerank_pe(src, dst, n, nb_pos_enc)], axis=1)
    return e_feat, pe


def edge_labels(n_edges: int, seed: int, positive: float = 0.7) -> np.ndarray:
    """f32[E] labels, each edge positive with probability ``positive``."""
    rng = np.random.default_rng(seed)
    return (rng.random(n_edges) < positive).astype(np.float32)


def distinct_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """The distinct (src, dst) pairs in first-occurrence order, int64."""
    _, first = np.unique(src.astype(np.int64) * n_nodes + dst, return_index=True)
    first.sort()
    return src[first].astype(np.int64), dst[first].astype(np.int64)


def adjacency_lists(src, dst, n_nodes: int) -> dict:
    """Successor and predecessor lists and the (src, dst) -> edge id map,
    the decoder's inputs (``get_info``'s ``succ``, ``pred``, ``edges``)."""
    su, du = src.tolist(), dst.tolist()
    succs = {i: [] for i in range(n_nodes)}
    preds = {i: [] for i in range(n_nodes)}
    for u, v in zip(su, du):
        succs[u].append(v)
        preds[v].append(u)
    return dict(succs=succs, preds=preds, edges=dict(zip(zip(su, du), range(len(su)))))


def read_lengths(rng, src, n_nodes: int) -> dict:
    """Read lengths of 10-30 kb and per edge a prefix length below its
    source read's length."""
    read_length = rng.integers(10_000, 30_000, n_nodes)
    return dict(read_length=read_length, prefix_length=rng.integers(1_000, read_length[src]))


def graph_seed(traffic: dict, seed: int, g: int) -> int:
    return traffic["n_graphs"] * traffic.get("graph_seed", seed) + g


def first_graph(traffic: dict, seed: int) -> int:
    """The graph a run starts from (the set is taken in turn from there):
    the first of a fixed set, else one the seed picks."""
    return 0 if "graph_seed" in traffic else seed % traffic["n_graphs"]


def make_graph(traffic: dict, seed: int, g: int, nb_pos_enc: int) -> dict:
    """Graph ``g`` of a run with ``seed``, on the host, in edge-list order:
    ``src``, ``dst``, ``n_nodes``, ``e_feat``, ``pe`` and, for training,
    ``y``; for decoding (``traffic["distinct"]``), the distinct edges and
    the decoder's lists and lengths. Each part draws from its own stream of
    the graph's seed."""
    gs = graph_seed(traffic, seed, g)
    n, e = traffic["n_nodes"], traffic["n_edges"]
    src, dst = bench_edges(n, e, [gs, 0], frac_long(traffic["cross_locus"], n, e))
    out = dict(n_nodes=n)
    if traffic.get("distinct"):
        src, dst = distinct_edges(src, dst, n)
        out.update(adjacency_lists(src, dst, n))
        out.update(read_lengths(np.random.default_rng([gs, 3]), src, n))
    out["src"], out["dst"] = src, dst
    out["e_feat"], out["pe"] = node_features(src, dst, n, nb_pos_enc, [gs, 1])
    if "label_positive" in traffic:
        out["y"] = edge_labels(len(src), [gs, 2], traffic["label_positive"])
    return out
