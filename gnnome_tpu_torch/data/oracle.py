"""Ground-truth edge labeler: coordinate-guided DFS oracle.

Host-side (numpy) re-implementation of the reference oracle
(``algorithms.py:60-186``): simulated reads carry genome coordinates
(strand/start/end), so the optimal assembly walks — and therefore the
"correct" edges a perfect model should score 1 — are computable exactly.

Semantics preserved bit-for-bit (tie-breaking included):

  * DFS over positive-strand nodes only, children filtered to overlapping
    (start ≤ current end) non-backtracking (start ≥ current start)
    neighbors; if none, *gap-jumping* children (start > current end) are
    allowed (``algorithms.py:86-106``).
  * Children are pushed in descending ``read_start`` order so the stack
    pops the smallest start first (``algorithms.py:108-111``).
  * Walk = parent-chain to the max-``read_end`` node (``algorithms.py:116-124``).
  * Components whose walk ends before the furthest point already covered
    (or trivial walks) are discarded (``algorithms.py:160-167``).
  * Correct edges: consecutive-overlap pairs along each walk, plus their
    reverse-complement mirrors via the ``^1`` strand trick
    (``algorithms.py:127-145``).
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np


def assert_strand(read_strand: np.ndarray, walk, log_fn=print) -> bool:
    """Debug check: all nodes of a walk share the first node's strand
    (``algorithms.py:12-19``). Returns True when consistent."""
    ok = True
    org = read_strand[walk[0]]
    for idx, node in enumerate(walk[1:]):
        if read_strand[node] != org:
            log_fn(f"strand mismatch at walk index {idx}, node {node}")
            ok = False
    return ok


def assert_overlap(
    read_start: np.ndarray, read_end: np.ndarray, read_strand: np.ndarray,
    walk, log_fn=print,
) -> bool:
    """Debug check: consecutive walk nodes genuinely overlap in genome
    coordinates (``algorithms.py:22-39``)."""
    ok = True
    for idx, (src, dst) in enumerate(zip(walk[:-1], walk[1:])):
        if read_strand[src] == read_strand[dst] == 1 and read_start[dst] > read_end[src]:
            log_fn(f"nodes not connected at {idx}: {src}->{dst} "
                   f"(end {read_end[src]} < start {read_start[dst]})")
            ok = False
        if read_strand[src] == read_strand[dst] == -1 and read_end[dst] < read_start[src]:
            log_fn(f"nodes not connected at {idx}: {src}->{dst}")
            ok = False
    return ok


def interval_union(read_strand, read_start, read_end):
    """Merged genome intervals covered by positive-strand nodes
    (``utils.py... algorithms — reference: algorithms.interval_union,
    algorithms.py:42-57``)."""
    intervals = sorted(
        [int(s), int(e)]
        for st, s, e in zip(read_strand, read_start, read_end)
        if st == 1
    )
    if not intervals:
        return []
    result = [intervals[0]]
    for lo, hi in intervals[1:]:
        if lo <= result[-1][1]:
            result[-1][1] = max(result[-1][1], hi)
        else:
            result.append([lo, hi])
    return result


def dfs(
    read_start: np.ndarray,
    read_end: np.ndarray,
    read_strand: np.ndarray,
    neighbors: Dict[int, List[int]],
    start: int,
    avoid: Set[int],
    max_gap: float = np.inf,
) -> Tuple[List[int], Set[int]]:
    """One guided DFS from ``start`` (``algorithms.py:60-124``).

    ``max_gap`` bounds the gap-jump fallback (``algorithms.py:97-106``,
    unbounded in the reference): a genuine coverage gap at 32× is at most
    a few kb, while a *repeat teleport* — a dead-end inside a collapsed
    repeat whose only remaining graph child sits at a copy Mb away —
    also satisfies ``start > current end`` and, unbounded, poisons the
    labels catastrophically: the accepted walk's end sets
    ``largest_visited`` and the monotone acceptance rule
    (``algorithms.py:160-167``) then silently discards every component
    behind the jump (observed: 40%+ of a chromosome labeled negative).
    Bounding the jump makes the walk END at the dead-end instead, so the
    skipped region keeps its own walks. ``np.inf`` = reference-exact.
    """
    n = len(read_start)
    stack = [start]
    visited = np.zeros(n, dtype=bool)
    for a in avoid:
        visited[a] = True

    parent: Dict[int, int | None] = {start: None}
    max_node = start
    max_value = read_end[start]

    while stack:
        current = stack.pop()
        if visited[current]:
            continue
        if read_end[current] > max_value:
            max_value = read_end[current]
            max_node = current
        visited[current] = True

        tmp = []
        for node in neighbors.get(current, []):
            if visited[node] or read_strand[node] == -1:
                continue
            if read_start[node] > read_end[current]:
                continue
            if read_start[node] < read_start[current]:
                continue
            tmp.append(node)
        if not tmp:
            # fallback: allow jumping a coverage gap (algorithms.py:97-106),
            # bounded by max_gap (see docstring; reference is unbounded)
            for node in neighbors.get(current, []):
                if visited[node] or read_strand[node] == -1:
                    continue
                if read_start[node] < read_start[current]:
                    continue
                if (read_start[node] > read_end[current]
                        and read_start[node] - read_end[current] <= max_gap):
                    tmp.append(node)

        tmp.sort(key=lambda x: -read_start[x])
        for node in tmp:
            stack.append(node)
            parent[node] = current

    walk = []
    current = max_node
    while current is not None:
        walk.append(current)
        current = parent[current]
    walk.reverse()
    visited_set = set(np.nonzero(visited)[0].tolist())
    return walk, visited_set


def get_correct_edges(
    read_start: np.ndarray,
    read_end: np.ndarray,
    neighbors: Dict[int, List[int]],
    edges: Dict[Tuple[int, int], int],
    walk: List[int],
) -> Tuple[Set[int], Set[int]]:
    """Edges justified by a walk + their negative-strand mirrors
    (``algorithms.py:127-145``)."""
    pos_edges: Set[int] = set()
    neg_edges: Set[int] = set()
    for i, src in enumerate(walk[:-1]):
        for dst in walk[i + 1 :]:
            if dst in neighbors[src] and read_start[dst] < read_end[src]:
                pos_edges.add(edges[(src, dst)])
                neg_edges.add(edges[(dst ^ 1, src ^ 1)])
            else:
                break
    return pos_edges, neg_edges


def get_gt_edges(
    read_start: np.ndarray,
    read_end: np.ndarray,
    read_strand: np.ndarray,
    neighbors: Dict[int, List[int]],
    edges: Dict[Tuple[int, int], int],
    max_gap: float = np.inf,
) -> Tuple[Set[int], Set[int]]:
    """All correct edge ids, (positive strand, negative strand)
    (``algorithms.py:148-186``)."""
    n = len(read_start)
    all_nodes = {i for i in range(n) if read_strand[i] == 1}
    if not all_nodes:
        return set(), set()
    last_node = max(all_nodes, key=lambda x: read_end[x])

    largest_visited = -1
    pos_correct: Set[int] = set()
    neg_correct: Set[int] = set()
    all_visited: Set[int] = set()

    while all_nodes:
        start = min(all_nodes, key=lambda x: read_start[x])
        walk, visited = dfs(read_start, read_end, read_strand, neighbors,
                            start, all_visited, max_gap=max_gap)
        if read_end[walk[-1]] < largest_visited or len(walk) == 1:
            all_nodes -= visited
            all_visited |= visited
            continue
        largest_visited = read_end[walk[-1]]

        pos_e, neg_e = get_correct_edges(read_start, read_end, neighbors, edges, walk)
        pos_correct |= pos_e
        neg_correct |= neg_e

        if largest_visited == read_end[last_node]:
            break
        all_nodes -= visited
        all_visited |= visited

    return pos_correct, neg_correct


def edge_labels(
    parsed, neighbors: Dict[int, List[int]], edges: Dict[Tuple[int, int], int],
    max_gap: float = None,
) -> np.ndarray:
    """float32[E] 0/1 labels (``graph_parser.py:307-309``).

    ``max_gap=None`` derives the gap-jump bound from the read-length
    distribution (4× the median read length — orders of magnitude above
    any genuine 32× coverage gap, orders below a repeat teleport; see
    :func:`dfs`). Pass ``np.inf`` for the reference's unbounded behavior.
    """
    if max_gap is None:
        lengths = parsed.read_end - parsed.read_start
        max_gap = 4.0 * float(np.median(lengths)) if len(lengths) else np.inf
    pos_e, neg_e = get_gt_edges(
        parsed.read_start, parsed.read_end, parsed.read_strand, neighbors,
        edges, max_gap=max_gap,
    )
    labels = pos_e | neg_e
    y = np.zeros(parsed.n_edges, dtype=np.float32)
    for idx in labels:
        y[idx] = 1.0
    return y
