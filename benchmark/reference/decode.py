"""Plain restatement of the reference's greedy decoder (lvrcek/GNNome-assembly
``inference.py:20-77, 182-277``): edge scores in, contig walks out.

Each iteration draws ``nb_paths`` seed edges among the edges whose both
ends are unvisited, with probability proportional to sigmoid(score)
(``numpy``'s ``Generator.choice`` over the alive edges in edge-list order,
probabilities floored at 1e-9); from each seed ``s -> d`` it walks greedily
forward from ``d`` and backward from ``s``: a node with one neighbour is
left for it unconditionally, a node with several for the best-scoring one
(the first in list order on ties) that neither this walk nor an earlier
contig visited; a walk marks each node and its strand mate (``node ^ 1``).
The walk that reconstructs the most bases (prefix lengths along it plus
the last read) wins, the first on ties; its nodes, their mates and the
nodes it skips transitively (successors of one step's source that are
predecessors of its destination) and their mates are marked visited. The
loop ends when no edge is alive or the best walk has fewer than
``len_threshold`` nodes. Self-loops are dropped.

One departure from the reference, which loops forever on a cycle of
single-successor nodes: a walk stops at ``n_nodes + 2`` nodes.
This file imports nothing of the program.
"""
from __future__ import annotations

import numpy as np


def _tables(neighbors: dict, edges: dict, scores: np.ndarray, n: int, reverse: bool):
    nbrs, scs = [[] for _ in range(n)], [[] for _ in range(n)]
    for node, row in neighbors.items():
        nbrs[node] = list(row)
        scs[node] = [float(scores[edges[(v, node)] if reverse else edges[(node, v)]])
                     for v in row]
    return nbrs, scs


def _walk(start: int, nbrs, scs, visited: bytearray, mine: bytearray, max_len: int):
    node, walk = start, []
    while True:
        walk.append(node)
        mine[node] = mine[node ^ 1] = 1
        row = nbrs[node]
        if not row or len(walk) >= max_len:
            return walk
        if len(row) == 1:
            node = row[0]
            continue
        best, best_s = -1, -np.inf
        for v, s in zip(row, scs[node]):
            if not visited[v] and not mine[v] and s > best_s:
                best, best_s = v, s
        if best < 0:
            return walk
        node = best


def get_contigs(src, dst, scores, succs: dict, preds: dict, edges: dict,
                prefix_length, read_length, nb_paths: int = 50,
                len_threshold: int = 20, seed: int = 0) -> list:
    """The contig walks (lists of node ids) in the order they were kept."""
    rng = np.random.default_rng(seed)
    src, dst = np.asarray(src), np.asarray(dst)
    scores = np.asarray(scores, dtype=np.float64)
    probs = 1.0 / (1.0 + np.exp(-scores))
    n = len(read_length)
    n_even = n + (n & 1)
    fwd = _tables(succs, edges, scores, n, reverse=False)
    bwd = _tables(preds, edges, scores, n, reverse=True)
    visited = bytearray(n_even)
    seen = np.frombuffer(visited, dtype=np.uint8)
    not_self = src != dst
    contigs = []
    while True:
        alive = np.nonzero(not_self & (seen[src] == 0) & (seen[dst] == 0))[0]
        if len(alive) == 0:
            return contigs
        p = np.maximum(probs[alive], 1e-9)
        starts = alive[rng.choice(len(p), size=nb_paths, p=p / p.sum())]
        best, best_len, best_mine = None, -1, None
        for eid in starts:
            mine = bytearray(n_even)
            ahead = _walk(int(dst[eid]), *fwd, visited, mine, n + 2)
            behind = _walk(int(src[eid]), *bwd, visited, mine, n + 2)
            walk = behind[::-1] + ahead
            length = sum(int(prefix_length[edges[(u, v)]]) for u, v in zip(walk, walk[1:]))
            length += int(read_length[walk[-1]])
            if length > best_len:
                best, best_len, best_mine = walk, length, mine
        if len(best) < len_threshold:
            return contigs
        contigs.append(best)
        seen |= np.frombuffer(best_mine, dtype=np.uint8)
        for u, v in zip(best, best[1:]):
            for t in set(succs[u]) & set(preds[v]):
                for m in (t, t ^ 1):
                    if m < n_even:
                        visited[m] = 1
