"""Cluster-minibatch sampling (ClusterGCN regime).

Counterpart of ``gnnome_tpu/train/cluster.py``, the reference's
METIS/ClusterGCN path (``train.py:282-343``): partition a graph into
``num_parts`` clusters, shuffle them, and train on the induced subgraphs of
``batch_size`` clusters at a time. Node features (PE, degrees) are sliced
from the full graph, as DGL's sampler does; they are not recomputed per
subgraph.

The host draws are the JAX package's (one ``random.Random(seed)`` for the
part count and the cluster order, the same partitioner), so both packages
cut a graph into the same pieces. Every piece of one call is padded to the
same bucket sizes, as in JAX: the pieces, and so the kernels' shapes, are
the same in both packages, and the caching allocator reuses one set of
blocks across the pieces.
"""
from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from gnnome_tpu_torch.core.graph import (
    build_graph,
    extract_edge_values,
    pad_features,
    prepare_edge_features,
)
from gnnome_tpu_torch.data.dataset import GraphSample
from gnnome_tpu_torch.parallel.partition import partition_nodes


def induced_subgraph(
    sample: GraphSample, node_ids: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(sub_src, sub_dst, edge_ids, node_ids) for the induced subgraph, in
    parser order (``edge_ids`` index ``sample.src``)."""
    n = sample.graph.n_nodes
    keep = np.zeros(n, dtype=bool)
    keep[node_ids] = True
    relabel = -np.ones(n, dtype=np.int64)
    relabel[node_ids] = np.arange(len(node_ids))
    edge_ids = np.nonzero(keep[sample.src] & keep[sample.dst])[0]
    return (
        relabel[sample.src[edge_ids]].astype(np.int32),
        relabel[sample.dst[edge_ids]].astype(np.int32),
        edge_ids,
        node_ids,
    )


def make_cluster_sampler(
    num_parts: int,
    batch_size: int,
    nb_pos_enc: int,
    seed: int = 0,
    jitter: int = 100,
    recluster: bool = True,
) -> Callable[[GraphSample], List[GraphSample]]:
    """Returns ``sampler(sample) -> list of sub-GraphSamples`` covering the
    graph once per call, on the sample's device.

    ``recluster=True`` (training) re-partitions on every call with a part
    count drawn uniformly from ``[num_parts - jitter, num_parts + jitter)``
    (the reference's per-graph-per-epoch METIS re-clustering,
    ``train.py:284-293``). ``recluster=False`` (evaluation) partitions each
    graph once at exactly ``num_parts`` and caches it by ``sample.idx``;
    the cluster order is reshuffled on every call either way
    (``train.py:436-439``). ``nb_pos_enc`` is kept for the JAX signature:
    the PE columns are sliced, not recomputed."""
    rng = random.Random(seed)
    part_cache: Dict[int, np.ndarray] = {}

    def sampler(sample: GraphSample) -> List[GraphSample]:
        g = sample.graph
        if recluster:
            lo = max(num_parts - jitter, 2)
            hi = max(num_parts + jitter, lo + 1)
            k = rng.randrange(lo, hi) if jitter > 0 else num_parts
            parts = partition_nodes(sample.src, sample.dst, g.n_nodes, k)
        else:
            if sample.idx not in part_cache:
                part_cache[sample.idx] = partition_nodes(
                    sample.src, sample.dst, g.n_nodes, num_parts)
            parts = part_cache[sample.idx]
        actual_parts = int(parts.max()) + 1 if len(parts) else 1
        cluster_ids = list(range(actual_parts))
        rng.shuffle(cluster_ids)

        # device features are canonical-order / device-numbered; bring them
        # back to parser order, which edge_ids / node_ids index
        pe_dev = sample.pe.cpu().numpy()
        pe_full = pe_dev[sample.node_map] if sample.node_map is not None else pe_dev
        e_full = extract_edge_values(g, sample.e_feat)
        y_full = extract_edge_values(g, sample.y)

        raw = []
        for b in range(math.ceil(actual_parts / batch_size)):
            chosen = cluster_ids[b * batch_size : (b + 1) * batch_size]
            raw.append(induced_subgraph(sample, np.nonzero(np.isin(parts, chosen))[0]))
        node_mult = _bucket(max(len(r[3]) for r in raw), base=512)
        edge_mult = _bucket(max(len(r[2]) for r in raw), base=1024)

        pieces: List[GraphSample] = []
        for sub_src, sub_dst, edge_ids, node_ids in raw:
            sub_g = build_graph(sub_src, sub_dst, len(node_ids),
                                node_pad_multiple=node_mult,
                                edge_pad_multiple=edge_mult, device=g.device)
            pieces.append(GraphSample(
                idx=sample.idx,
                graph=sub_g,
                e_feat=prepare_edge_features(sub_g, e_full[edge_ids]),
                pe=torch.from_numpy(
                    pad_features(pe_full[node_ids], sub_g.n_nodes_padded)).to(g.device),
                y=prepare_edge_features(sub_g, y_full[edge_ids]),
                prefix_length=sample.prefix_length[edge_ids],
                read_length=sample.read_length[node_ids],
                overlap_length=sample.overlap_length[edge_ids],
                overlap_similarity=sample.overlap_similarity[edge_ids],
                src=sub_src,
                dst=sub_dst,
            ))
        return pieces

    return sampler


def _bucket(x: int, base: int = 512) -> int:
    """A max size rounded up to a multiple of ``base`` (at least ``base``)."""
    return max(base, ((x + base - 1) // base) * base)
