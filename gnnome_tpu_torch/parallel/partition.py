"""Locality node ordering (the part of ``gnnome_tpu/parallel/partition.py``
that loading a graph needs).

Assembly graphs are long, thin overlap chains; numbering reads in
undirected-BFS order makes an edge's endpoints close in node id, so
endpoint gathers touch nearby rows. The partitioner itself (and its native
C++ version) waits for the slice that ports minibatch and sharded training.
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
