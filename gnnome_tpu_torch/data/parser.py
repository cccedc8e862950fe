"""Assembly-graph parser: Raven-format CSV/GFA + reads → numpy arrays.

Implements the exact file contract of the reference parser
(``graph_parser.py:95-311``) but produces flat numpy arrays instead of a
NetworkX→DGL object chain — the arrays feed straight into
:func:`gnnome_tpu_torch.core.graph.build_graph`.

Contract recap (documented at ``graph_parser.py:118-127,187-200``):

  * The CSV has two row kinds, ``src, dst, flag, payload``:
      - ``flag == 0``: a read declaration. ``src``/``dst`` fields are
        ``"<node_id> [<gfa_line>] …:<trimmed_len>…"``; node ``2i`` is the
        forward strand, ``2i+1`` its reverse complement. ``payload`` is the
        trimming info ``"trim_start trim_end"`` or ``"-"``.
      - ``flag != 0``: a directed edge; ``payload`` is
        ``"edge_id prefix_len weight similarity"``.
  * The GFA supplies trimmed sequences: rows with 5 whitespace fields
    ``tag id seq len count``, in the same order as the CSV's flag==0 rows.
  * Ground-truth coordinates come from the read FASTA headers rewritten by
    the simulator to ``"<id> strand=±, start=<s>, end=<e>"``
    (``pipeline.py:46-61``).
  * CSV node ids may have gaps (edge-less reads are omitted); ids are
    compacted to 0..N-1 in sorted order, preserving the 2i/2i+1 pairing
    (``graph_parser.py:194-199``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

_LEN_RE = re.compile(r":(\d+)")
_START_RE = re.compile(r"start=(\d+)")
_END_RE = re.compile(r"end=(\d+)")
_IDX_RE = re.compile(r"[a-zA-Z0-9]*\.(\d+)")

_COMPLEMENT = str.maketrans("ACGTacgt", "TGCAtgca")


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


@dataclasses.dataclass
class ParsedGraph:
    """Raw parsed graph, unpadded, in CSV edge order."""

    src: np.ndarray  # int32[E]
    dst: np.ndarray  # int32[E]
    # node attributes, int64[N] (graph_parser.py:284-294)
    read_length: np.ndarray
    read_idx: np.ndarray
    read_strand: np.ndarray
    read_start: np.ndarray
    read_end: np.ndarray
    read_trim_start: np.ndarray
    read_trim_end: np.ndarray
    # edge attributes (graph_parser.py:289-291)
    prefix_length: np.ndarray
    overlap_similarity: np.ndarray
    overlap_length: np.ndarray
    # node sequences (trimmed; reverse complement for odd nodes)
    reads: List[str]

    @property
    def n_nodes(self) -> int:
        return len(self.read_length)

    @property
    def n_edges(self) -> int:
        return len(self.src)


def parse_reads_descriptions(reads_path: str) -> Dict[str, str]:
    """Map read id → full header line (description) from FASTA/FASTQ.

    Replaces the BioPython scan in ``graph_parser.py:132-135``.
    """
    descriptions: Dict[str, str] = {}
    is_fastq = reads_path.endswith("fastq") or reads_path.endswith("fq")
    with open(reads_path) as f:
        if is_fastq:
            while True:
                header = f.readline()
                if not header:
                    break
                f.readline()  # seq
                f.readline()  # +
                f.readline()  # qual
                desc = header[1:].strip()
                descriptions[desc.split()[0]] = desc
        else:
            for line in f:
                if line.startswith(">"):
                    desc = line[1:].strip()
                    descriptions[desc.split()[0]] = desc
    return descriptions


def parse_gfa(gfa_path: str, descriptions: Dict[str, str]) -> Tuple[List[str], List[str]]:
    """Trimmed sequences + matched descriptions, GFA line order
    (``graph_parser.py:95-151``)."""
    seqs: List[str] = []
    descs: List[str] = []
    with open(gfa_path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) != 5:
                break  # reference stops at the first non-S row (:149-150)
            _tag, rid, seq, _length, _count = parts
            seqs.append(seq)
            descs.append(descriptions.get(rid, "0 strand=+, start=0, end=0"))
    return seqs, descs


def _parse_description(desc: str) -> Tuple[int, int, int, int]:
    """(idx, strand, start, end) from a simulator header
    (``graph_parser.py:220-249``)."""
    parts = desc.split()
    if len(parts) == 4:
        rid, strand_tok, start_tok, end_tok = parts
    else:
        rid, _extra, strand_tok, start_tok, end_tok = parts[:5]
    try:
        idx = int(rid)
    except ValueError:
        idx = int(_IDX_RE.findall(rid)[0])
    strand = 1 if strand_tok[-2] == "+" else -1  # token ends with ','
    start = int(_START_RE.findall(start_tok)[0])
    end = int(_END_RE.findall(end_tok)[0])
    return idx, strand, start, end


def parse_csv(csv_path: str, reads_path: str, gfa_path: Optional[str] = None) -> ParsedGraph:
    """Full parse: CSV + GFA + reads → :class:`ParsedGraph`.

    Equivalent of ``graph_parser.from_csv`` (``graph_parser.py:154-311``)
    minus label generation (see :mod:`gnnome_tpu_torch.data.oracle`).
    """
    if gfa_path is None:
        gfa_path = csv_path[:-3] + "gfa"
    descriptions = parse_reads_descriptions(reads_path)
    seqs, descs = parse_gfa(gfa_path, descriptions)
    seq_iter = iter(zip(seqs, descs))

    node_ids: List[int] = []
    read_length: Dict[int, int] = {}
    read_idx: Dict[int, int] = {}
    read_strand: Dict[int, int] = {}
    read_start: Dict[int, int] = {}
    read_end: Dict[int, int] = {}
    trim_start_d: Dict[int, int] = {}
    trim_end_d: Dict[int, int] = {}
    node_seq: Dict[int, str] = {}

    edge_src: List[int] = []
    edge_dst: List[int] = []
    prefix_length: List[int] = []
    overlap_similarity: List[float] = []

    with open(csv_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            src_f, dst_f, flag_f, payload = line.split(",", 3)
            src_parts, dst_parts = src_f.split(), dst_f.split()
            flag = int(flag_f)
            src_id = int(src_parts[0])
            src_len = int(_LEN_RE.findall(src_parts[2])[0])
            dst_id = int(dst_parts[0])
            dst_len = int(_LEN_RE.findall(dst_parts[2])[0])
            payload = payload.strip()

            if flag == 0:
                # read declaration; payload is trimming info (:218-249)
                seq, desc = next(seq_iter)
                idx, strand, start, end = _parse_description(desc)
                if payload == "-":
                    trim_start, trim_end = 0, end - start
                else:
                    ts, te = payload.split()
                    trim_start, trim_end = int(ts), int(te)
                # start/end in headers are untrimmed; adjust (:249-250)
                end = start + trim_end
                start = start + trim_start

                node_ids.extend((src_id, dst_id))
                node_seq[src_id] = seq
                node_seq[dst_id] = reverse_complement(seq)
                read_length[src_id], read_length[dst_id] = src_len, dst_len
                read_idx[src_id] = read_idx[dst_id] = idx
                read_strand[src_id], read_strand[dst_id] = strand, -strand
                read_start[src_id] = read_start[dst_id] = start
                read_end[src_id] = read_end[dst_id] = end
                trim_start_d[src_id] = trim_start_d[dst_id] = trim_start
                trim_end_d[src_id] = trim_end_d[dst_id] = trim_end
            else:
                # edge row; payload = "edge_id prefix_len weight similarity"
                toks = payload.split()
                try:
                    prefix_len = int(toks[1])
                    similarity = float(toks[3]) if len(toks) > 3 else 0.0
                except (IndexError, ValueError):
                    continue  # graph_parser.py:272-276 skips malformed rows
                edge_src.append(src_id)
                edge_dst.append(dst_id)
                prefix_length.append(prefix_len)
                overlap_similarity.append(similarity)

    # Compact node ids (CSV may skip edge-less reads, :194-199).
    sorted_ids = sorted(node_ids)
    id_map = {old: new for new, old in enumerate(sorted_ids)}
    n = len(sorted_ids)

    def node_arr(d: Dict[int, int], dtype=np.int64) -> np.ndarray:
        out = np.zeros(n, dtype=dtype)
        for old, new in id_map.items():
            out[new] = d[old]
        return out

    src_arr = np.array([id_map[s] for s in edge_src], dtype=np.int32)
    dst_arr = np.array([id_map[d] for d in edge_dst], dtype=np.int32)
    rl = node_arr(read_length)
    # overlap_length = read_length[src] - prefix_len (graph_parser.py:281)
    prefix_arr = np.asarray(prefix_length, dtype=np.int64)
    ol_len = rl[src_arr] - prefix_arr

    return ParsedGraph(
        src=src_arr,
        dst=dst_arr,
        read_length=rl,
        read_idx=node_arr(read_idx),
        read_strand=node_arr(read_strand),
        read_start=node_arr(read_start),
        read_end=node_arr(read_end),
        read_trim_start=node_arr(trim_start_d),
        read_trim_end=node_arr(trim_end_d),
        prefix_length=prefix_arr,
        overlap_similarity=np.asarray(overlap_similarity, dtype=np.float32),
        overlap_length=ol_len,
        reads=[node_seq[i] for i in sorted_ids],
    )


def print_pairwise(src: np.ndarray, dst: np.ndarray, path: str) -> None:
    """Export edges as a pairwise TXT for Graphia visualization
    (``graph_parser.py:76-92``)."""
    with open(path, "w") as f:
        for s, d in zip(src, dst):
            f.write(f"{int(s)}\t{int(d)}\n")


def adjacency_dicts(src: np.ndarray, dst: np.ndarray, n: int):
    """(successors, predecessors, edge_index) dicts for host-side decoding
    (``graph_parser.py:13-73``)."""
    succ: Dict[int, List[int]] = {i: [] for i in range(n)}
    pred: Dict[int, List[int]] = {i: [] for i in range(n)}
    edges: Dict[Tuple[int, int], int] = {}
    for k in range(len(src)):
        s, d = int(src[k]), int(dst[k])
        succ[s].append(d)
        pred[d].append(s)
        edges[(s, d)] = k
    return succ, pred, edges
