"""Assembly-graph dataset: processing, caching and feature preparation.

Counterpart of ``gnnome_tpu/data/dataset.py`` (reference
``graph_dataset.py:12-138``), with torch tensors on an explicit device:

  * raw reads live in ``<root>/raw/<idx>.fasta``;
  * processing runs the overlap-graph builder on each raw file, labels
    edges with the oracle and caches ``<root>/processed/<idx>.npz`` plus the
    decode-time pickles in ``<root>/info/`` — the same files, in the same
    format, as the JAX package writes, so either package reads the other's
    cache;
  * loading prepares the features (``utils.py:67-94``) and the PageRank
    PE (``utils.py:97-140``) and builds the graph on the device.

The JAX package pads node and edge counts to geometric buckets so that
near-size graphs share one compiled program; eager PyTorch compiles
nothing, so graphs here are not padded.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gnnome_tpu_torch.core.graph import (
    AssemblyGraph,
    build_graph,
    pad_features,
    prepare_edge_features,
)
from gnnome_tpu_torch.data import oracle
from gnnome_tpu_torch.data.parser import ParsedGraph, adjacency_dicts, parse_csv
from gnnome_tpu_torch.data.pe import pagerank_pe_np

_NODE_ATTRS = (
    "read_length read_idx read_strand read_start read_end "
    "read_trim_start read_trim_end".split()
)
_EDGE_ATTRS = "prefix_length overlap_similarity overlap_length".split()


@dataclasses.dataclass
class GraphSample:
    """One device-ready graph with features, plus host metadata.

    Device tensors (``e_feat``, ``y``) are in the graph's canonical
    (dst-sorted) edge order; host arrays (``src``, ``dst``,
    ``prefix_length`` …) stay in parser order for decoding. Use
    ``core.graph.extract_edge_values`` to map device edge values back.
    """

    idx: int
    graph: AssemblyGraph
    e_feat: torch.Tensor  # f32[E, 2] z-normed [ol_len, ol_sim] (canonical)
    pe: torch.Tensor  # f32[N, nb_pos_enc + 2] = [in_deg ‖ out_deg ‖ PR]
    y: torch.Tensor  # f32[E] edge labels, canonical order
    prefix_length: np.ndarray  # int64[E]
    read_length: np.ndarray  # int64[N]
    overlap_length: np.ndarray  # int64[E]
    overlap_similarity: np.ndarray  # f32[E]
    src: np.ndarray  # int32[E] parser order
    dst: np.ndarray
    node_map: np.ndarray = None  # parser node id -> device node id
    read_strand: np.ndarray = None  # int8[N] in {-1, +1}
    read_start: np.ndarray = None  # int64[N]
    read_end: np.ndarray = None  # int64[N]


def save_processed(parsed: ParsedGraph, y: np.ndarray, npz_path: str) -> None:
    arrays = dict(
        src=parsed.src,
        dst=parsed.dst,
        y=y.astype(np.float32),
        n_nodes=np.int64(parsed.n_nodes),
    )
    for a in _NODE_ATTRS + _EDGE_ATTRS:
        arrays[a] = getattr(parsed, a)
    np.savez_compressed(npz_path, **arrays)


def znorm(x: np.ndarray) -> np.ndarray:
    # torch .std() is Bessel-corrected (ddof=1); match utils.py:72-73.
    std = x.std(ddof=1) if len(x) > 1 else 1.0
    return (x - x.mean()) / (std if std > 0 else 1.0)


def load_sample(npz_path: str, idx: int, nb_pos_enc: int = 16,
                locality_reorder: bool = True, device="cuda") -> GraphSample:
    """Load a cached graph and prepare its device features.

    ``locality_reorder`` renumbers nodes in pair-aligned BFS order for the
    device graph only; host arrays and decoding keep parser ids, and
    per-edge values map back through the edge permutation as usual.
    """
    z = np.load(npz_path)
    src, dst = z["src"], z["dst"]
    n = int(z["n_nodes"])

    if locality_reorder and n >= 2 and n % 2 == 0:
        from gnnome_tpu_torch.parallel.partition import locality_order_pairs

        node_map = locality_order_pairs(src, dst, n)
        dev_src, dev_dst = node_map[src], node_map[dst]
    else:
        node_map = np.arange(max(n, 1), dtype=np.int32)
        dev_src, dev_dst = src, dst
    graph = build_graph(dev_src, dev_dst, n, device=device)

    ol_len = znorm(z["overlap_length"].astype(np.float32))
    ol_sim = znorm(z["overlap_similarity"].astype(np.float32))
    e_feat = np.stack([ol_len, ol_sim], axis=1)

    pr = pagerank_pe_np(src, dst, n, nb_pos_enc)
    in_deg = np.bincount(dst, minlength=n).astype(np.float32)
    out_deg = np.bincount(src, minlength=n).astype(np.float32)
    # concat order [in_deg, out_deg, pe] matches train.py:249-251
    pe_parser = np.concatenate([in_deg[:, None], out_deg[:, None], pr], axis=1)
    pe = np.empty_like(pe_parser)
    pe[node_map[:n]] = pe_parser

    return GraphSample(
        idx=idx,
        graph=graph,
        e_feat=prepare_edge_features(graph, e_feat),
        pe=torch.from_numpy(pad_features(pe, graph.n_nodes_padded)).to(graph.device),
        y=prepare_edge_features(graph, z["y"]),
        prefix_length=z["prefix_length"],
        read_length=z["read_length"],
        overlap_length=z["overlap_length"],
        overlap_similarity=z["overlap_similarity"],
        src=src,
        dst=dst,
        node_map=node_map[:n],
        read_strand=z["read_strand"],
        read_start=z["read_start"],
        read_end=z["read_end"],
    )


def process_raw_graph(csv_path: str, reads_path: str, root: str, idx: int) -> ParsedGraph:
    """Parse builder output, label with the oracle, cache npz + info pickles
    (``graph_dataset.py:124-137``)."""
    parsed = parse_csv(csv_path, reads_path)
    succ, pred, edges = adjacency_dicts(parsed.src, parsed.dst, parsed.n_nodes)
    y = oracle.edge_labels(parsed, succ, edges)

    os.makedirs(os.path.join(root, "processed"), exist_ok=True)
    os.makedirs(os.path.join(root, "info"), exist_ok=True)
    save_processed(parsed, y, os.path.join(root, "processed", f"{idx}.npz"))
    info = os.path.join(root, "info")
    for kind, obj in (("succ", succ), ("pred", pred), ("edges", edges),
                      ("reads", parsed.reads)):
        with open(os.path.join(info, f"{idx}_{kind}.pkl"), "wb") as f:
            pickle.dump(obj, f)
    return parsed


class AssemblyGraphDataset:
    """Directory-backed dataset (reference ``graph_dataset.py:12-138``).

    ``root`` must contain ``raw/`` (FASTA read sets). Processing runs the
    overlap-graph builder on each raw file not yet processed; loading
    yields :class:`GraphSample` objects sorted by index, on ``device``.
    ``generate=True`` builds and caches the graphs and loads none of them
    (``generate.py`` and the pipeline's generate stage).
    """

    def __init__(self, root: str, nb_pos_enc: Optional[int] = 16,
                 specs: Optional[Dict] = None, generate: bool = False, device="cuda"):
        self.root = os.path.abspath(root)
        self.nb_pos_enc = nb_pos_enc
        self.specs = specs or {}
        for sub in ("raw", "processed", "info", "builder_output"):
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)
        self.raw_dir = os.path.join(self.root, "raw")
        self.save_dir = os.path.join(self.root, "processed")
        self.tmp_dir = os.path.join(self.root, "builder_output")

        if not self.has_cache():
            self.process()

        self.graph_list: List[Tuple[int, GraphSample]] = []
        if generate:
            return
        for file in sorted(os.listdir(self.save_dir)):
            if not file.endswith(".npz"):
                continue
            idx = int(file[: -len(".npz")])
            sample = load_sample(os.path.join(self.save_dir, file), idx,
                                 nb_pos_enc or 16, device=device)
            self.graph_list.append((idx, sample))
        self.graph_list.sort(key=lambda t: t[0])

    def has_cache(self) -> bool:
        """Resume-by-counting, as in ``graph_dataset.py:82-84``."""
        n_processed = len([f for f in os.listdir(self.save_dir) if f.endswith(".npz")])
        return n_processed >= len(os.listdir(self.raw_dir))

    def __len__(self) -> int:
        """Processed graphs on disk (loaded or not, as in the JAX package)."""
        return len([f for f in os.listdir(self.save_dir) if f.endswith(".npz")])

    def __getitem__(self, i: int) -> Tuple[int, GraphSample]:
        return self.graph_list[i]

    def __iter__(self):
        return iter(self.graph_list)

    def process(self) -> None:
        """Run the overlap-graph builder on unprocessed raw files
        (``graph_dataset.py:93-138``)."""
        from gnnome_tpu_torch.data.builder import build_overlap_graph

        raw_files = sorted(
            f for f in os.listdir(self.raw_dir) if f.endswith((".fasta", ".fastq")))
        n_have = len([f for f in os.listdir(self.save_dir) if f.endswith(".npz")])
        for idx in range(n_have, len(raw_files)):
            reads_path = os.path.join(self.raw_dir, f"{idx}.fasta")
            csv_path = os.path.join(self.tmp_dir, f"{idx}_graph_1.csv")
            build_overlap_graph(
                reads_path,
                csv_path,
                threads=self.specs.get("threads", 32),
                identity=self.specs.get("filter", 0.99),
                noisy=self.specs.get("noisy", False),
                trim_min_cov=self.specs.get("trim_min_cov", 3),
            )
            process_raw_graph(csv_path, reads_path, self.root, idx)


def get_info(idx: int, data_path: str, kind: str):
    """Load one info pickle (``utils.get_info``, ``utils.py:163-166``)."""
    with open(os.path.join(data_path, "info", f"{idx}_{kind}.pkl"), "rb") as f:
        return pickle.load(f)


def load_graph_data(num_graphs: int, data_path: str, use_reads: bool = False):
    """Batch-load decode-time info dicts (``utils.load_graph_data``,
    ``utils.py:182-195``)."""
    info_all = {"preds": [], "succs": [], "reads": [], "edges": []}
    for idx in range(num_graphs):
        info_all["preds"].append(get_info(idx, data_path, "pred"))
        info_all["succs"].append(get_info(idx, data_path, "succ"))
        if use_reads:
            info_all["reads"].append(get_info(idx, data_path, "reads"))
        info_all["edges"].append(get_info(idx, data_path, "edges"))
    return info_all


def print_graph_info(idx: int, sample: GraphSample, log_fn=print) -> None:
    """Basic graph info (``utils.print_graph_info``, ``utils.py:198-204``)."""
    log_fn("\n---- GRAPH INFO ----")
    log_fn(f"Graph index: {idx}")
    log_fn(f"Number of nodes: {sample.graph.n_nodes}")
    log_fn(f"Number of edges: {sample.graph.n_edges}")
