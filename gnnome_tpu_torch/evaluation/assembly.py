"""Assembly reconstruction + quality metrics.

Reference: ``evaluate.py``. Contig algebra (``evaluate.py:36-47``): the
sequence of a walk is the concatenation of per-edge prefixes
``read[src][:prefix_length]`` plus the final read in full; N50/NG50 and
reconstructed-fraction metrics as ``evaluate.py:58-104``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

# CHM13 v1.1 chromosome lengths (evaluate.py:9-33 == pipeline.py:19-43)
CHR_LENS = {
    "chr1": 248387328, "chr2": 242696752, "chr3": 201105948,
    "chr4": 193574945, "chr5": 182045439, "chr6": 172126628,
    "chr7": 160567428, "chr8": 146259331, "chr9": 150617247,
    "chr10": 134758134, "chr11": 135127769, "chr12": 133324548,
    "chr13": 113566686, "chr14": 101161492, "chr15": 99753195,
    "chr16": 96330374, "chr17": 84276897, "chr18": 80542538,
    "chr19": 61707364, "chr20": 66210255, "chr21": 45090682,
    "chr22": 51324926, "chrX": 154259566,
}


def walk_to_sequence(
    walks: List[List[int]],
    reads: Sequence[str],
    prefix_length: np.ndarray,
    edges: Dict[Tuple[int, int], int],
) -> List[Tuple[str, str]]:
    """Walks → (contig_id_header, sequence) pairs (``evaluate.py:36-47``)."""
    contigs = []
    for i, walk in enumerate(walks):
        parts = []
        for src, dst in zip(walk[:-1], walk[1:]):
            prefix = int(prefix_length[edges[(src, dst)]])
            parts.append(reads[src][:prefix])
        parts.append(reads[walk[-1]])
        seq = "".join(parts)
        contigs.append((f"contig_{i+1} length={len(seq)}", seq))
    return contigs


def save_assembly(
    contigs: List[Tuple[str, str]], data_path: str, idx: int,
    suffix: str = "", dir_name: str = "assembly",
) -> str:
    """FASTA output (``evaluate.py:50-55``)."""
    assembly_dir = os.path.join(data_path, dir_name)
    os.makedirs(assembly_dir, exist_ok=True)
    path = os.path.join(assembly_dir, f"{idx}_assembly{suffix}.fasta")
    with open(path, "w") as f:
        for header, seq in contigs:
            f.write(f">{header}\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i : i + 80] + "\n")
    return path


def calculate_n50(lengths: Sequence[int]) -> int:
    """N50 (``evaluate.py:58-73``)."""
    lengths = sorted(lengths, reverse=True)
    total = sum(lengths)
    acc = 0
    for l in lengths:
        acc += l
        if acc >= total / 2:
            return l
    return -1


def calculate_ng50(lengths: Sequence[int], ref_length: int) -> int:
    """NG50 against the reference length (``evaluate.py:76-92``)."""
    if ref_length <= 0:
        return -1
    acc = 0
    for l in sorted(lengths, reverse=True):
        acc += l
        if acc >= ref_length / 2:
            return l
    return -1


def quick_evaluation(
    contigs: List[Tuple[str, str]], chr_n: str, ref_length: int | None = None
) -> Tuple[int, int, float, int, int]:
    """(num_contigs, longest, reconstructed_frac, N50, NG50)
    (``evaluate.py:95-104``)."""
    if ref_length is None:
        ref_length = CHR_LENS.get(chr_n, 0)
    lengths = [len(seq) for _, seq in contigs]
    if not lengths:
        return 0, 0, 0.0, -1, -1
    return (
        len(contigs),
        max(lengths),
        sum(lengths) / ref_length if ref_length else 0.0,
        calculate_n50(lengths),
        calculate_ng50(lengths, ref_length),
    )


def edge_coordinate_consistent(
    strand: np.ndarray, start: np.ndarray, end: np.ndarray, a: int, b: int
) -> bool:
    """True when walk edge ``a → b`` is genomically correct: both reads on
    one strand, properly overlapping, and advancing along the genome in
    that strand's walk direction. This is the ground-truth adjacency the
    oracle's debug asserts check (``algorithms.py:12-39``), tightened to
    require advancement (so teleports between repeat copies AND stalls
    both count as misassemblies)."""
    if strand[a] != strand[b]:
        return False
    if strand[a] == 1:
        return (start[a] <= start[b] <= end[a]) and end[b] >= end[a]
    return (start[b] <= start[a] <= end[b]) and end[b] <= end[a]


def coordinate_evaluation(
    walks: List[List[int]],
    read_strand: np.ndarray,
    read_start: np.ndarray,
    read_end: np.ndarray,
    ref_length: int = 0,
) -> Dict[str, float]:
    """Ground-truth (Quast-role) assembly evaluation for synthetic data.

    ``quick_evaluation`` (the reference's built-in metrics,
    ``evaluate.py:58-104``) counts contig *bp* — a chimeric walk that
    teleports between repeat copies still scores well (even >100%
    reconstructed). The reference defers misassembly detection to external
    Quast (``README.md:114-129``); on simulated reads we can do it exactly:
    every read carries its true genome interval, so each walk edge is
    checkable (:func:`edge_coordinate_consistent`). Walks are split at
    inconsistent edges into *correct segments* — the Quast-style corrected
    contigs — and we report:

    - ``n_misassemblies``: inconsistent walk edges (≈ Quast misassemblies)
    - ``genome_fraction``: union of correct-segment genome intervals ÷ ref
      (double-counted repeats collapse, unlike raw "reconstructed %")
    - ``nga50``: NG50 over corrected segment lengths (Quast's NGA50 role)
    - ``longest_correct``: largest correct segment (bp of genome interval)
    """
    seg_intervals: List[Tuple[int, int]] = []
    n_mis = 0
    for walk in walks:
        if not walk:
            continue
        run_start = 0
        for i in range(len(walk) - 1):
            if not edge_coordinate_consistent(
                read_strand, read_start, read_end, walk[i], walk[i + 1]
            ):
                n_mis += 1
                seg = walk[run_start : i + 1]
                seg_intervals.append(
                    (min(int(read_start[n]) for n in seg),
                     max(int(read_end[n]) for n in seg))
                )
                run_start = i + 1
        seg = walk[run_start:]
        seg_intervals.append(
            (min(int(read_start[n]) for n in seg),
             max(int(read_end[n]) for n in seg))
        )
    lengths = [hi - lo for lo, hi in seg_intervals]
    # union of covered genome intervals
    union = 0
    cur_lo = cur_hi = None
    for lo, hi in sorted(seg_intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                union += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        union += cur_hi - cur_lo
    return {
        "n_walks": len(walks),
        "n_misassemblies": n_mis,
        "n_correct_segments": len(seg_intervals),
        "longest_correct": max(lengths) if lengths else 0,
        "nga50": calculate_ng50(lengths, ref_length) if ref_length else -1,
        "genome_fraction": union / ref_length if ref_length else 0.0,
    }


def print_summary(
    data_path: str, idx: int, chr_n: str,
    num_contigs: int, longest: int, reconstructed: float, n50: int, ng50: int,
    log_fn=print,
) -> str:
    """Per-graph text report (``evaluate.py:112-124``)."""
    reports_dir = os.path.join(data_path, "reports")
    os.makedirs(reports_dir, exist_ok=True)
    path = os.path.join(reports_dir, f"{idx}_report.txt")
    lines = [
        "-" * 80,
        f"Report for graph {idx} in {data_path}",
        f"Graph created from {chr_n}",
        f"Num contigs:\t{num_contigs}",
        f"Longest contig:\t{longest}",
        f"Reconstructed:\t{reconstructed * 100:2f}%",
        f"N50:\t{n50}",
        f"NG50:\t{ng50}",
    ]
    with open(path, "w") as f:
        for line in lines:
            log_fn(line)
            f.write(line + "\n")
    return path
