"""Greedy probability-guided decoding: edge scores → contig walks.

The reference decoder (``inference.py:20-277``) walks on the host CPU
(``inference.py:490``): each step of a walk depends on the visited set.
The host engines below do the same; the device engine runs the candidate
walks of an iteration on the card and keeps the outer loop on the host.

Semantics preserved:
  * iterative outer loop: sample ``nb_paths`` seed edges ∝ sigmoid(score)
    among edges of the *remaining* subgraph (``inference.py:256-277``),
    walk greedily forward from dst and backward from src
    (``inference.py:31-77``), keep the walk reconstructing the most bases
    (``inference.py:228``), mark its nodes + their ``^1`` strand mates +
    transitively skipped nodes visited (``inference.py:233-239``), repeat
    until the best walk is shorter than ``len_threshold`` nodes
    (``inference.py:245-247``);
  * self-loops are dropped before decoding (``inference.py:184``).

Three engines, chosen by ``get_contigs(engine=...)``, give the same walks:

* ``"batched"`` (the default; the JAX package's ``decode/batched.py``):
  adjacency as aligned lists-of-lists (neighbor / score / edge id) and
  visited sets as bytearrays, in place of per-step dict lookups and set
  hashing;
* ``"sequential"``: the direct restatement of the reference
  (:func:`walk_forwards`, :func:`walk_backwards`, :func:`get_contig_length`);
* ``"device"`` (the JAX package's ``engine="tpu"``): the ``nb_paths``
  walks of an iteration advance on the card, one CUDA kernel launch per
  leg (:mod:`gnnome_tpu_torch.decode.device_walker`).

Walks equal the JAX package's engines (tests/test_torch_inference.py,
tests/test_torch_decode_device.py): same neighbor order, same first-max
tie-breaking, same rng consumption. A safety cap (``n_nodes + 2`` steps
per walk) bounds the batched and device walks on degenerate
single-successor cycles, which would loop forever in the reference; a
device walk cut by it counts the prefix of one more hop, as JAX's
``tpu_walker`` does, so on such cycles the device engine may keep
another candidate than the host engines.
"""
from __future__ import annotations

from math import inf
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np


def get_contig_length(
    walk: Sequence[int],
    prefix_length: np.ndarray,
    read_length: np.ndarray,
    edges: Dict[Tuple[int, int], int],
) -> int:
    """Reconstructed bases of a walk (``inference.py:20-28``)."""
    total = 0
    for src, dst in zip(walk[:-1], walk[1:]):
        total += int(prefix_length[edges[(src, dst)]])
    total += int(read_length[walk[-1]])
    return total


def walk_forwards(
    start: int,
    edge_scores: np.ndarray,
    neighbors: Dict[int, List[int]],
    edges: Dict[Tuple[int, int], int],
    visited_old: Set[int],
    min_score: float = float("-inf"),
) -> Tuple[List[int], Set[int]]:
    """Greedy forward walk (``inference.py:31-52``).

    ``min_score`` (raw-logit confidence floor, default -inf = reference
    semantics) halts the walk when the edge about to be taken scores
    below it — including the single-neighbor unconditional hop.
    """
    current = start
    walk: List[int] = []
    visited: Set[int] = set()
    while True:
        walk.append(current)
        visited.add(current)
        visited.add(current ^ 1)
        nbrs = neighbors.get(current, [])
        if len(nbrs) == 0:
            break
        if len(nbrs) == 1:
            if edge_scores[edges[(current, nbrs[0])]] < min_score:
                break
            current = nbrs[0]
            continue
        masked = [n for n in nbrs if n not in visited_old and n not in visited]
        if not masked:
            break
        scores = [edge_scores[edges[(current, n)]] for n in masked]
        j = int(np.argmax(scores))
        if scores[j] < min_score:
            break
        current = masked[j]
    return walk, visited


def walk_backwards(
    start: int,
    edge_scores: np.ndarray,
    predecessors: Dict[int, List[int]],
    edges: Dict[Tuple[int, int], int],
    visited_old: Set[int],
    min_score: float = float("-inf"),
) -> Tuple[List[int], Set[int]]:
    """Greedy backward walk (``inference.py:55-77``); ``min_score`` as in
    :func:`walk_forwards`."""
    current = start
    walk: List[int] = []
    visited: Set[int] = set()
    while True:
        walk.append(current)
        visited.add(current)
        visited.add(current ^ 1)
        preds = predecessors.get(current, [])
        if len(preds) == 0:
            break
        if len(preds) == 1:
            if edge_scores[edges[(preds[0], current)]] < min_score:
                break
            current = preds[0]
            continue
        masked = [n for n in preds if n not in visited_old and n not in visited]
        if not masked:
            break
        scores = [edge_scores[edges[(n, current)]] for n in masked]
        j = int(np.argmax(scores))
        if scores[j] < min_score:
            break
        current = masked[j]
    walk.reverse()
    return walk, visited


def sample_edges(
    probs: np.ndarray, nb_paths: int, rng: np.random.Generator
) -> np.ndarray:
    """Sample edge indices ∝ prob (``inference.py:270-277``)."""
    p = np.maximum(probs, 1e-9)
    p = p / p.sum()
    return rng.choice(len(p), size=nb_paths, p=p)


class ListAdjacency:
    """Aligned per-node neighbor / score / edge-id lists built from the
    successor (or predecessor) dicts + the (u, v) -> eid edge dict."""

    __slots__ = ("nbrs", "scores", "eids")

    def __init__(
        self,
        neighbors: Dict[int, List[int]],
        edges: Dict[Tuple[int, int], int],
        scores: np.ndarray,
        n_nodes: int,
        reverse: bool,
    ):
        self.nbrs: List[List[int]] = [[] for _ in range(n_nodes)]
        self.scores: List[List[float]] = [[] for _ in range(n_nodes)]
        self.eids: List[List[int]] = [[] for _ in range(n_nodes)]
        for node, nbrs in neighbors.items():
            if node >= n_nodes:
                continue
            row_n, row_s, row_e = [], [], []
            for nb in nbrs:
                e = edges[(nb, node)] if reverse else edges[(node, nb)]
                row_n.append(nb)
                row_s.append(float(scores[e]))
                row_e.append(e)
            self.nbrs[node] = row_n
            self.scores[node] = row_s
            self.eids[node] = row_e


def _walk(
    start: int,
    adj: ListAdjacency,
    vg: bytearray,  # global visited
    vw: bytearray,  # this walk's visited — updated in place
    max_steps: int,
    min_score: float = -inf,
) -> List[int]:
    """One greedy walk (``inference.py:31-52``): single-neighbor hops are
    taken unconditionally (no visited check), multi-neighbor hops first-max
    the score over neighbors absent from both visited sets. ``min_score``
    (raw-logit floor, -inf = reference semantics) halts the walk before
    taking any edge scoring below it — single-neighbor hops included."""
    node = start
    lst: List[int] = []
    nbrs_all, scores_all = adj.nbrs, adj.scores
    while True:
        lst.append(node)
        vw[node] = 1
        vw[node ^ 1] = 1
        nbrs = nbrs_all[node]
        k = len(nbrs)
        if k == 0 or len(lst) >= max_steps:
            break
        if k == 1:
            if scores_all[node][0] < min_score:
                break
            node = nbrs[0]
            continue
        scs = scores_all[node]
        best = -1
        best_s = -inf
        for j in range(k):
            nb = nbrs[j]
            if not vg[nb] and not vw[nb]:
                s = scs[j]
                if s > best_s:
                    best_s = s
                    best = nb
        if best < 0 or best_s < min_score:
            break
        node = best
    return lst


def _walk_length(
    walk: List[int],
    adj_f: ListAdjacency,
    prefix_length: np.ndarray,
    read_length: np.ndarray,
) -> int:
    """``get_contig_length`` via the aligned lists (``inference.py:20-28``)."""
    total = 0
    pl = prefix_length
    for u, v in zip(walk[:-1], walk[1:]):
        row = adj_f.nbrs[u]
        total += int(pl[adj_f.eids[u][row.index(v)]])
    return total + int(read_length[walk[-1]])


def get_contigs(
    src: np.ndarray,
    dst: np.ndarray,
    scores: np.ndarray,
    succs: Dict[int, List[int]],
    preds: Dict[int, List[int]],
    edges: Dict[Tuple[int, int], int],
    prefix_length: np.ndarray,
    read_length: np.ndarray,
    nb_paths: int = 50,
    len_threshold: int = 20,
    seed: int = 0,
    engine: str = "batched",
    min_prob: float = 0.0,
    min_score: float | None = None,
    device="cuda",
) -> List[List[int]]:
    """Iterative contig extraction (``inference.py:182-253``).

    ``scores`` are raw logits in original edge order. ``engine`` picks one
    of three engines with the same walks: ``"batched"`` (default, the
    aligned-list host layout), ``"sequential"`` (the direct reference
    restatement) or ``"device"``, the counterpart of the JAX package's
    ``engine="tpu"``: the walks of an iteration run on ``device`` (read by
    this engine alone; ``"cuda"`` by default, ``"cpu"`` runs the walk
    kernel's plain version), as f32 scores. ``min_prob`` > 0 stops
    extending a walk once the next edge's sigmoid probability drops below
    it (see DecodeConfig.min_prob); only meaningful when ``scores`` are
    logits. ``min_score`` (raw score-space floor) overrides the
    ``min_prob`` mapping — the equivalent confidence floor for decoders
    whose scores are NOT logits (the raw overlap_length /
    overlap_similarity baselines, where sigmoid saturates; use a feature
    quantile instead, see ``DecodeConfig.baseline_min_quantile``).
    """
    if engine not in ("batched", "sequential", "device"):
        raise ValueError(f"unknown decode engine {engine!r}: "
                         "'batched', 'sequential' or 'device'")
    if min_score is None:
        min_score = -inf if min_prob <= 0.0 else float(np.log(min_prob) - np.log1p(-min_prob))
    else:
        min_score = float(min_score)
    args = (src, dst, scores, succs, preds, edges, prefix_length, read_length,
            nb_paths, len_threshold, seed, min_score)
    if engine == "device":
        from gnnome_tpu_torch.decode.device_walker import get_contigs_device

        return get_contigs_device(*args, device=device)
    if engine == "sequential":
        return _get_contigs_sequential(*args)
    return _get_contigs_batched(*args)


def _get_contigs_batched(src, dst, scores, succs, preds, edges, prefix_length,
                         read_length, nb_paths, len_threshold, seed,
                         min_score) -> List[List[int]]:
    """The ``"batched"`` engine: the candidate walks over aligned lists."""
    rng = np.random.default_rng(seed)
    scores = np.asarray(scores, dtype=np.float64)
    probs = 1.0 / (1.0 + np.exp(-scores))
    not_self = src != dst  # dgl.remove_self_loop (inference.py:184)
    n_nodes = len(read_length)
    # ^1 strand mates index one past the end when n_nodes is odd
    nn = n_nodes + (n_nodes & 1)
    max_steps = n_nodes + 2

    adj_f = ListAdjacency(succs, edges, scores, n_nodes, reverse=False)
    adj_b = ListAdjacency(preds, edges, scores, n_nodes, reverse=True)

    visited_global = bytearray(nn)
    vg_np = np.frombuffer(visited_global, dtype=np.uint8)
    all_contigs: List[List[int]] = []

    while True:
        keep = vg_np == 0
        edge_alive = not_self & keep[src] & keep[dst]
        if min_score > -inf:
            # the confidence floor also gates SEED edges: a sub-floor seed
            # would otherwise enter the walk unchecked (the seed edge is
            # the one edge the walkers never score-test)
            edge_alive &= scores >= min_score
        alive_ids = np.nonzero(edge_alive)[0]
        if len(alive_ids) == 0:
            break

        seed_ids = alive_ids[sample_edges(probs[alive_ids], nb_paths, rng)]

        best_walk: List[int] | None = None
        best_len = -1
        best_vw: bytearray | None = None
        for eid in seed_ids:
            s, d = int(src[eid]), int(dst[eid])
            vw = bytearray(nn)
            walk_f = _walk(d, adj_f, visited_global, vw, max_steps, min_score)
            walk_b = _walk(s, adj_b, visited_global, vw, max_steps, min_score)
            walk = walk_b[::-1] + walk_f
            length = _walk_length(walk, adj_f, prefix_length, read_length)
            if length > best_len:
                best_len = length
                best_walk = walk
                best_vw = vw

        assert best_walk is not None and best_vw is not None
        # transitively skipped nodes + mates (inference.py:233-239)
        trans: set = set()
        for ss, dd in zip(best_walk[:-1], best_walk[1:]):
            t1 = set(succs[ss]) & set(preds[dd])
            trans |= t1 | {t ^ 1 for t in t1}

        if len(best_walk) < len_threshold:
            break
        all_contigs.append(best_walk)
        vg_np |= np.frombuffer(best_vw, dtype=np.uint8)
        for t in trans:
            if t < nn:
                visited_global[t] = 1

    return all_contigs


def _get_contigs_sequential(src, dst, scores, succs, preds, edges, prefix_length,
                            read_length, nb_paths, len_threshold, seed,
                            min_score) -> List[List[int]]:
    """The ``"sequential"`` engine: the reference's loop over sets."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / (1.0 + np.exp(-scores))
    not_self = src != dst  # dgl.remove_self_loop (inference.py:184)
    # visited sets include ^1 strand mates, which can exceed max(src, dst)
    # when trailing nodes are edge-less — and exceed n_nodes-1 itself when
    # n_nodes is odd (the last node's mate is n_nodes), so size the bitmap
    # to the next even count
    n_nodes = len(read_length)
    n_nodes += n_nodes & 1

    all_contigs: List[List[int]] = []
    visited: Set[int] = set()

    while True:
        # edges of the remaining subgraph (both endpoints unvisited)
        if visited:
            vis_arr = np.fromiter(visited, dtype=np.int64)
            keep_node = np.ones(n_nodes, dtype=bool)
            keep_node[vis_arr] = False
            edge_alive = not_self & keep_node[src] & keep_node[dst]
        else:
            edge_alive = not_self
        if min_score > -inf:
            # the floor also gates seed edges (as in the batched engine)
            edge_alive = edge_alive & (scores >= min_score)
        alive_ids = np.nonzero(edge_alive)[0]
        if len(alive_ids) == 0:
            break

        seed_ids = alive_ids[sample_edges(probs[alive_ids], nb_paths, rng)]

        best_walk: List[int] | None = None
        best_len = -1
        best_visited: Set[int] = set()
        for eid in seed_ids:
            s, d = int(src[eid]), int(dst[eid])
            walk_f, visited_f = walk_forwards(d, scores, succs, edges, visited, min_score)
            walk_b, visited_b = walk_backwards(
                s, scores, preds, edges, visited | visited_f, min_score)
            walk = walk_b + walk_f
            length = get_contig_length(walk, prefix_length, read_length, edges)
            if length > best_len:
                best_len = length
                best_walk = walk
                best_visited = visited_f | visited_b

        assert best_walk is not None
        # transitively skipped nodes + their mates (inference.py:233-239)
        trans: Set[int] = set()
        for ss, dd in zip(best_walk[:-1], best_walk[1:]):
            t1 = set(succs[ss]) & set(preds[dd])
            trans |= t1 | {t ^ 1 for t in t1}
        best_visited |= trans

        if len(best_walk) < len_threshold:
            break
        all_contigs.append(best_walk)
        visited |= best_visited

    return all_contigs


def get_contigs_baselines(
    src: np.ndarray,
    dst: np.ndarray,
    scores: np.ndarray,
    overlap_length: np.ndarray,
    overlap_similarity: np.ndarray,
    succs: Dict[int, List[int]],
    preds: Dict[int, List[int]],
    edges: Dict[Tuple[int, int], int],
    prefix_length: np.ndarray,
    read_length: np.ndarray,
    nb_paths: int = 50,
    len_threshold: int = 20,
    seed: int = 0,
) -> Tuple[List[List[int]], List[List[int]], List[List[int]]]:
    """GNN-scored decode plus the two non-learned controls that walk by raw
    overlap_length / overlap_similarity (``inference.py:80-179``)."""
    out = []
    for metric in (scores, overlap_length.astype(np.float64),
                   overlap_similarity.astype(np.float64)):
        out.append(
            get_contigs(
                src, dst, np.asarray(metric, dtype=np.float64), succs, preds,
                edges, prefix_length, read_length, nb_paths, len_threshold,
                seed,
            )
        )
    return out[0], out[1], out[2]
