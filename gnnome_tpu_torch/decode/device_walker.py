"""Greedy decode walks on the card: the ``nb_paths`` candidate walks of an
iteration run as one CUDA launch per leg (``csrc/walk.cu``).

Counterpart of ``gnnome_tpu/decode/tpu_walker.py`` (``PaddedAdjacency``,
``_walk_batch``, ``get_contigs_tpu``); ``greedy.get_contigs(engine="device")``
is the JAX package's ``engine="tpu"``. The walks of an iteration are
independent given its frozen global visited set, so each walk is one warp
that steps through padded ``[N_pad, K]`` neighbor / score / prefix tables,
first-maxing the scores of the usable slots. Semantics equal the host
engines' (same neighbor order → same first-max tie-breaks, same
unconditional single-neighbor hops, same ``^1`` mate marks, same
``min_score`` floor); tests/test_torch_decode_device.py pins walk-for-walk
equality with both packages' engines (scores cast to f32 on every engine:
the tables are f32).

The outer contig loop (sample seeds ∝ prob, walk, keep the longest, mark
visited + transitive skips, repeat) stays on the host as the reference
runs it. The tables go to the device once per call; per iteration the
host sends the visited set and the seeds and copies back the lengths, the
base counts, the best walk and its visited rows.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gnnome_tpu_torch.decode.greedy import sample_edges
from gnnome_tpu_torch.ops.cuda_lib import I32, I64, P, Kernel, on_cpu, register

WALK = register(Kernel(
    "walk", "gnnome_walk",
    [P, P, P, P, P, P, P, ctypes.c_float, I64, I64, I32, I64, P, P, P, P],
    source="gnnome_tpu_torch/csrc/walk.cu",
    replaces="gnnome_tpu/decode/tpu_walker.py:63 _walk_batch (jnp in a "
             "lax.while_loop; not a TPU kernel)"))

# JAX's stand-in for a missing floor (tpu_walker.py: jnp.float32(-3.4e38))
NO_FLOOR = -3.4e38


class WalkTables(NamedTuple):
    """One direction's padded adjacency on a device: ``nbr`` int32 [N_pad, K]
    (-1 past the degree), ``score`` f32 [N_pad, K], ``prefix`` int32
    [N_pad, K], ``deg`` int32 [N_pad]."""

    nbr: torch.Tensor
    score: torch.Tensor
    prefix: torch.Tensor
    deg: torch.Tensor


class WalkBuffers(NamedTuple):
    """One leg's outputs: ``walks`` int32 [B, max_steps] (-1 past each walk),
    ``lengths`` int32 [B], ``bp`` int64 [B] (Σ prefix over taken edges),
    ``visited`` uint8 [B, N_pad] (with ``^1`` mates)."""

    walks: torch.Tensor
    lengths: torch.Tensor
    bp: torch.Tensor
    visited: torch.Tensor


class PaddedAdjacency:
    """Dense [N, K] neighbor / score / prefix tables (K = max degree,
    rounded up to 8, at least 8) in the EXACT per-node order of the
    succ/pred dicts, built with numpy: the first max over a row is the
    reference's tie-break."""

    __slots__ = ("nbr", "score", "prefix", "deg", "k")

    def __init__(
        self,
        neighbors: Dict[int, List[int]],
        edges: Dict[Tuple[int, int], int],
        scores: np.ndarray,
        prefix_length: np.ndarray,
        n_nodes: int,
        reverse: bool,
    ):
        k = max((len(v) for v in neighbors.values()), default=1)
        k = max(8, (k + 7) & ~7)
        self.k = k
        self.nbr = np.full((n_nodes, k), -1, np.int32)
        self.score = np.full((n_nodes, k), -np.inf, np.float32)
        self.prefix = np.zeros((n_nodes, k), np.int32)
        self.deg = np.zeros(n_nodes, np.int32)
        rows = [(node, nbrs) for node, nbrs in neighbors.items() if node < n_nodes]
        if not rows:
            return
        nodes = np.fromiter((node for node, _ in rows), np.int64, len(rows))
        lens = np.fromiter((len(nbrs) for _, nbrs in rows), np.int64, len(rows))
        total = int(lens.sum())
        flat_nb = np.fromiter((nb for _, nbrs in rows for nb in nbrs), np.int64, total)
        if reverse:
            eids = (edges[(nb, node)] for node, nbrs in rows for nb in nbrs)
        else:
            eids = (edges[(node, nb)] for node, nbrs in rows for nb in nbrs)
        flat_e = np.fromiter(eids, np.int64, total)
        row = np.repeat(nodes, lens)
        slot = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
        self.deg[nodes] = lens
        self.nbr[row, slot] = flat_nb
        self.score[row, slot] = np.asarray(scores)[flat_e]
        self.prefix[row, slot] = np.asarray(prefix_length)[flat_e]

    def tensors(self, device) -> WalkTables:
        return WalkTables(*(torch.from_numpy(getattr(self, name)).to(device)
                            for name in WalkTables._fields))


def walk_buffers(n_walks: int, n_pad: int, max_steps: int, device) -> WalkBuffers:
    """Uninitialised outputs for :func:`walk_batch` (its kernel clears and
    pads them itself, so one set serves every launch)."""
    return WalkBuffers(torch.empty((n_walks, max_steps), dtype=torch.int32, device=device),
                       torch.empty(n_walks, dtype=torch.int32, device=device),
                       torch.empty(n_walks, dtype=torch.int64, device=device),
                       torch.empty((n_walks, n_pad), dtype=torch.uint8, device=device))


def walk_batch_plain(tables: WalkTables, starts: torch.Tensor, visited_global: torch.Tensor,
                     frozen_extra: Optional[torch.Tensor], min_score: float,
                     max_steps: int) -> WalkBuffers:
    """``_walk_batch`` (``tpu_walker.py:63-119``) step by step in PyTorch
    ops: the CPU form of the walk kernel and its reference on the card."""
    nbr, score, prefix, deg = tables
    b, n_pad, dev = starts.shape[0], nbr.shape[0], nbr.device
    walks = torch.full((b, max_steps), -1, dtype=torch.int32, device=dev)
    visited = torch.zeros((b, n_pad), dtype=torch.uint8, device=dev)
    frozen = visited_global[None, :].expand(b, n_pad)
    if frozen_extra is not None:
        frozen = torch.maximum(frozen, frozen_extra)
    bi = torch.arange(b, device=dev)
    floor = torch.tensor(min_score, dtype=torch.float32, device=dev)
    cur = starts.long()
    bp = torch.zeros(b, dtype=torch.int64, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    step = 0
    while step < max_steps and bool(alive.any()):
        walks[:, step] = torch.where(alive, cur, -1).to(torch.int32)
        live = alive.to(torch.uint8)
        for mark in (cur, cur ^ 1):
            at = mark.clamp(max=n_pad - 1)
            visited[bi, at] = torch.maximum(visited[bi, at], live)
        rows = nbr[cur].long()
        rows_c = rows.clamp(min=0)
        blocked = (frozen[bi[:, None], rows_c] | visited[bi[:, None], rows_c]) > 0
        usable = (rows >= 0) & ((deg[cur] == 1)[:, None] | ~blocked)
        masked = torch.where(usable, score[cur], -torch.inf)
        j = masked.argmax(dim=1)  # the first max
        best = masked[bi, j]
        advance = alive & (best > -torch.inf) & (best >= floor)
        bp = torch.where(advance, bp + prefix[cur, j], bp)
        cur = torch.where(advance, rows[bi, j], cur)
        alive = alive & advance
        step += 1
    lengths = (walks >= 0).sum(dim=1).to(torch.int32)
    return WalkBuffers(walks, lengths, bp, visited)


def walk_batch(tables: WalkTables, starts: torch.Tensor, visited_global: torch.Tensor,
               frozen_extra: Optional[torch.Tensor], min_score: float, max_steps: int,
               out: Optional[WalkBuffers] = None) -> WalkBuffers:
    """The ``B = len(starts)`` greedy walks of one leg: from each start,
    first-max the scores of the usable slots (not marked in
    ``visited_global`` [N_pad], in ``frozen_extra[b]`` ([B, N_pad] or None)
    or in the walk's own marks; a single neighbor is always usable) until
    no slot is usable, the best score is below ``min_score`` (f32), or
    ``max_steps`` nodes. On CUDA tensors one launch of ``csrc/walk.cu``
    writes into ``out`` (from :func:`walk_buffers`; new buffers if None);
    on CPU tensors :func:`walk_batch_plain` runs."""
    frozen = [] if frozen_extra is None else [frozen_extra]
    if on_cpu(*tables, starts, visited_global, *frozen):
        return walk_batch_plain(tables, starts, visited_global, frozen_extra, min_score,
                                max_steps)
    nbr, score, prefix, deg = tables
    (n_pad, k), b = nbr.shape, starts.shape[0]
    for name, t, dtype, shape in (
            ("nbr", nbr, torch.int32, (n_pad, k)), ("score", score, torch.float32, (n_pad, k)),
            ("prefix", prefix, torch.int32, (n_pad, k)), ("deg", deg, torch.int32, (n_pad,)),
            ("starts", starts, torch.int32, (b,)),
            ("visited_global", visited_global, torch.uint8, (n_pad,)),
            *((("frozen_extra", frozen_extra, torch.uint8, (b, n_pad)),) if frozen else ())):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"walk: {name} must be contiguous {dtype} of shape {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if max_steps < 1:
        raise ValueError("walk: max_steps must be at least 1")
    if b:
        lo, hi = torch.stack(torch.aminmax(starts)).tolist()  # one sync
        if lo < 0 or hi >= n_pad:
            raise ValueError(f"walk: a start lies outside [0, {n_pad})")
    if out is None:
        out = walk_buffers(b, n_pad, max_steps, nbr.device)
    elif (tuple(out.walks.shape) != (b, max_steps) or tuple(out.visited.shape) != (b, n_pad)
          or out.lengths.shape[0] != b or out.bp.shape[0] != b):
        raise ValueError("walk: out buffers of another shape")
    WALK(nbr.device, *(t.data_ptr() for t in tables), starts.data_ptr(),
         visited_global.data_ptr(), frozen_extra.data_ptr() if frozen else None,
         float(min_score), max_steps, n_pad, k, b, *(t.data_ptr() for t in out))
    return out


def get_contigs_device(
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
    min_score: float = float("-inf"),
    device="cuda",
) -> List[List[int]]:
    """``greedy.get_contigs`` with the walks of each iteration on ``device``
    (``get_contigs_tpu``, ``tpu_walker.py:122-208``): a CUDA device runs
    the walk kernel, ``"cpu"`` its plain version."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("engine='device' needs a CUDA device (or device='cpu')")
    rng = np.random.default_rng(seed)
    scores = np.asarray(scores, dtype=np.float64)
    probs = 1.0 / (1.0 + np.exp(-scores))
    not_self = src != dst
    n_nodes = len(read_length)
    n_pad = n_nodes + (n_nodes & 1)
    max_steps = n_nodes + 2

    tables_f = PaddedAdjacency(succs, edges, scores, prefix_length, n_pad,
                               reverse=False).tensors(device)
    tables_b = PaddedAdjacency(preds, edges, scores, prefix_length, n_pad,
                               reverse=True).tensors(device)
    floor = min_score if np.isfinite(min_score) else NO_FLOOR
    vg_host = np.zeros(n_pad, np.uint8)
    vg = torch.empty(n_pad, dtype=torch.uint8, device=device)
    starts = torch.empty((2, nb_paths), dtype=torch.int32, device=device)
    fwd, bwd = (walk_buffers(nb_paths, n_pad, max_steps, device) for _ in range(2))
    rows = torch.arange(nb_paths, device=device)
    all_contigs: List[List[int]] = []

    while True:
        keep = vg_host == 0
        edge_alive = not_self & keep[src] & keep[dst]
        if np.isfinite(min_score):
            # the floor also gates seed edges (see greedy.py)
            edge_alive = edge_alive & (scores >= min_score)
        alive_ids = np.nonzero(edge_alive)[0]
        if len(alive_ids) == 0:
            break
        seed_ids = alive_ids[sample_edges(probs[alive_ids], nb_paths, rng)]
        vg.copy_(torch.from_numpy(vg_host))
        starts.copy_(torch.from_numpy(np.stack([dst[seed_ids], src[seed_ids]]).astype(np.int32)))
        wf = walk_batch(tables_f, starts[0], vg, None, floor, max_steps, out=fwd)
        # backward legs must not re-enter their forward leg's nodes
        wb = walk_batch(tables_b, starts[1], vg, wf.visited, floor, max_steps, out=bwd)

        last_f = wf.walks[rows, (wf.lengths.long() - 1).clamp(min=0)]
        lf, lb, bpf, bpb, last_f = torch.stack(
            [wf.lengths.long(), wb.lengths.long(), wf.bp, wb.bp, last_f.long()]).cpu().numpy()
        # contig bp = Σ leg prefixes + the seed edge (s→d) + last read
        total = bpf + bpb + prefix_length[seed_ids] + read_length[last_f]
        best = int(np.argmax(total))

        walk_f = wf.walks[best, : lf[best]].tolist()
        walk_b = wb.walks[best, : lb[best]].tolist()[::-1]
        best_walk = walk_b + walk_f

        if len(best_walk) < len_threshold:
            break
        all_contigs.append(best_walk)
        vg_host |= torch.maximum(wf.visited[best], wb.visited[best]).cpu().numpy()
        trans = set()
        for ss, dd in zip(best_walk[:-1], best_walk[1:]):
            t1 = set(succs[ss]) & set(preds[dd])
            trans |= t1 | {t ^ 1 for t in t1}
        for t in trans:
            if t < n_pad:
                vg_host[t] = 1

    return all_contigs
