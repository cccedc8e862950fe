"""Graph partitioning and locality ordering (counterpart of
``gnnome_tpu/parallel/partition.py``).

:func:`partition_nodes` fills the role METIS plays in the reference (via
``dgl.dataloading.ClusterGCNSampler``, ``train.py:291-293``): split a graph
into ``num_parts`` clusters whose induced subgraphs are the ClusterGCN
minibatches (``train/cluster.py``). The native C++ partitioner (BFS order,
contiguous chunks, label-propagation refinement) runs when the library is
built (``data/native_bridge.py``); the numpy BFS-chunk version is the
fallback and spec, as in the JAX package.

Assembly graphs are long, thin overlap chains; numbering reads in
undirected-BFS order makes an edge's endpoints close in node id, so
endpoint gathers touch nearby rows (:func:`locality_order_pairs`).
"""
from __future__ import annotations

from collections import deque

import numpy as np


def bfs_order(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Node ordering by undirected BFS over all components."""
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    order_edges = np.argsort(u, kind="stable")
    v_sorted = v[order_edges]
    offsets = np.searchsorted(u[order_edges], np.arange(n + 1))

    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    for root in range(n):
        if visited[root]:
            continue
        visited[root] = True
        q = deque([root])
        while q:
            x = q.popleft()
            order[pos] = x
            pos += 1
            for y in v_sorted[offsets[x] : offsets[x + 1]]:
                if not visited[y]:
                    visited[y] = True
                    q.append(y)
    return order


def _bfs_chunks(src: np.ndarray, dst: np.ndarray, n: int, num_parts: int) -> np.ndarray:
    """int32[n]: contiguous chunks of the undirected BFS order."""
    order = bfs_order(src, dst, n)
    parts = np.zeros(n, dtype=np.int32)
    chunk = (n + num_parts - 1) // num_parts
    for p in range(num_parts):
        parts[order[p * chunk : (p + 1) * chunk]] = p
    return parts


def partition_nodes(src: np.ndarray, dst: np.ndarray, n: int, num_parts: int,
                    pair_aligned: bool = True) -> np.ndarray:
    """int32[n] partition assignment, ``num_parts`` clamped to ``[1, n]``.

    ``pair_aligned`` keeps strand mates ``2i``/``2i+1`` in the same part
    (the ^1 pairing invariant) by partitioning on read ids; an odd ``n``
    has no pairing and is partitioned node by node.
    """
    from gnnome_tpu_torch.data import native_bridge

    num_parts = max(1, min(num_parts, max(n, 1)))
    if not pair_aligned or n % 2 != 0:
        native = native_bridge.partition_graph(src, dst, n, num_parts)
        return native if native is not None else _bfs_chunks(src, dst, n, num_parts)
    # collapse node pairs to read ids, partition reads, expand back
    rsrc, rdst, n_reads = src // 2, dst // 2, n // 2
    read_parts = native_bridge.partition_graph(rsrc, rdst, n_reads, num_parts)
    if read_parts is None:
        read_parts = _bfs_chunks(rsrc, rdst, n_reads, num_parts)
    return np.repeat(read_parts, 2).astype(np.int32)


def edge_cut_fraction(parts: np.ndarray, src: np.ndarray, dst: np.ndarray) -> float:
    """Fraction of edges crossing partitions (quality metric)."""
    if len(src) == 0:
        return 0.0
    return float(np.mean(parts[src] != parts[dst]))


def band_statistics(src: np.ndarray, dst: np.ndarray) -> dict:
    """|src − dst| distribution: how banded the graph is."""
    if len(src) == 0:
        return {"p50": 0, "p90": 0, "p99": 0, "max": 0}
    d = np.abs(src.astype(np.int64) - dst.astype(np.int64))
    return {
        "p50": int(np.percentile(d, 50)),
        "p90": int(np.percentile(d, 90)),
        "p99": int(np.percentile(d, 99)),
        "max": int(d.max()),
    }


def locality_order_pairs(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """old→new node id map that keeps the ``2i``/``2i+1`` strand pairing and
    numbers reads in undirected-BFS order."""
    if n % 2:
        raise ValueError("node pairing requires an even node count")
    read_order = bfs_order(src // 2, dst // 2, n // 2)  # new position -> old read
    node_map = np.empty(n, dtype=np.int32)
    new_r = np.arange(n // 2, dtype=np.int32)
    node_map[2 * read_order] = 2 * new_r
    node_map[2 * read_order + 1] = 2 * new_r + 1
    return node_map
