"""Read simulator: seqrequester-equivalent sampling of HiFi-like reads.

The reference shells out to marbl/seqrequester
(``pipeline.py:133-170``): sample reads from a chromosome FASTA at a target
coverage, lengths drawn from an empirical per-chromosome distribution file
(one observed length per line, ``data/references/lengths/chr*.txt``), then
rewrites headers to ``"<id> strand=±, start=<s>, end=<e>"``
(``pipeline.py:46-61`` change_description).

This module emits those final headers directly. A native C++ simulator with
identical semantics lives in ``native/`` (used for full chromosomes through
``data/native_bridge.py`` when built); this Python version is the spec and
the fallback.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

_COMPLEMENT = str.maketrans("ACGTacgt", "TGCAtgca")


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


def read_fasta_sequence(path: str) -> str:
    parts: List[str] = []
    with open(path) as f:
        for line in f:
            if not line.startswith(">"):
                parts.append(line.strip())
    return "".join(parts).upper()


def write_fasta(path: str, records: List[tuple[str, str]], width: int = 80) -> None:
    with open(path, "w") as f:
        for header, seq in records:
            f.write(f">{header}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + "\n")


def load_length_distribution(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.int64)


#: vendored per-chromosome HiFi read-length distributions (gzipped copies of
#: the reference's ``data/references/lengths/chr*.txt`` data files — one
#: observed read length per line; e.g. chr19 has 110,835 samples). The port
#: carries chr19 and chr21, the chromosomes every simulated split of the
#: entry points uses (``config.SplitConfig``, ``example.py``,
#: ``reproduce.py``); another chromosome's reads take the clipped-normal
#: lengths unless ``<lengths_dir>/<chr>.txt`` exists.
VENDORED_LENGTHS_DIR = os.path.join(os.path.dirname(__file__), "lengths")


def resolve_distribution(chr_n: str, lengths_dir: str) -> Optional[str]:
    """Return a path to the empirical length-distribution file for ``chr_n``.

    Prefers an existing ``<lengths_dir>/<chr_n>.txt``; otherwise inflates the
    vendored ``.txt.gz`` into ``lengths_dir`` (created on demand) so both the
    Python and native simulators can read it. Returns ``None`` when no
    empirical distribution is available (callers fall back to the
    clipped-normal synthetic distribution)."""
    import gzip
    import shutil

    txt = os.path.join(lengths_dir, f"{chr_n}.txt")
    if os.path.exists(txt):
        return txt
    gz = os.path.join(VENDORED_LENGTHS_DIR, f"{chr_n}.txt.gz")
    if os.path.exists(gz):
        os.makedirs(lengths_dir, exist_ok=True)
        tmp = txt + ".tmp"
        with gzip.open(gz, "rb") as f_in, open(tmp, "wb") as f_out:
            shutil.copyfileobj(f_in, f_out)
        os.replace(tmp, txt)
        return txt
    return None


def simulate_reads(
    genome: str,
    coverage: float,
    lengths: np.ndarray,
    seed: int = 0,
    circular: bool = False,
    error_rate: float = 0.0,
) -> List[tuple[str, str]]:
    """Sample reads to ``coverage`` × genome length.

    Returns (header, sequence) pairs with ground-truth headers. Positions
    are uniform; strand is a fair coin; a read's genomic interval is
    [start, end) on the forward strand regardless of its own strand
    (matching seqrequester's reporting, which the reference's oracle
    consumes as forward-strand coordinates).

    ``error_rate`` injects sequencing errors per base after strand
    selection (HiFi-like mix: 90% substitutions, 5% insertions, 5%
    deletions — seqrequester is error-free, so this extends it for
    exercising the noisy-read leg Raven handles in the reference). The
    header's genome interval still describes the error-free template.
    """
    rng = np.random.default_rng(seed)
    g_len = len(genome)
    target = coverage * g_len
    total = 0
    records: List[tuple[str, str]] = []
    idx = 0
    while total < target:
        length = int(lengths[rng.integers(0, len(lengths))])
        length = min(length, g_len)
        start = int(rng.integers(0, max(g_len - length, 0) + 1))
        end = start + length
        seq = genome[start:end]
        strand = "+" if rng.random() < 0.5 else "-"
        if strand == "-":
            seq = reverse_complement(seq)
        if error_rate > 0.0:
            seq = inject_errors(seq, error_rate, rng)
        records.append((f"{idx} strand={strand}, start={start}, end={end}", seq))
        total += length
        idx += 1
    return records


def inject_errors(seq: str, rate: float, rng: np.random.Generator) -> str:
    """Per-base errors: 90% substitution, 5% insertion, 5% deletion."""
    codes = np.frombuffer(seq.encode(), dtype=np.uint8)
    n = len(codes)
    err_pos = np.nonzero(rng.random(n) < rate)[0]
    if len(err_pos) == 0:
        return seq
    kinds = rng.random(len(err_pos))
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    out: List[bytes] = []
    prev = 0
    for pos, kind in zip(err_pos, kinds):
        out.append(codes[prev:pos].tobytes())
        base = codes[pos : pos + 1].tobytes()
        if kind < 0.90:  # substitution: a different base
            choices = bases[bases != codes[pos]]
            out.append(choices[rng.integers(0, len(choices))].tobytes())
        elif kind < 0.95:  # insertion: keep base + a random extra
            out.append(base)
            out.append(bases[rng.integers(0, 4)].tobytes())
        # deletion: emit nothing
        prev = pos + 1
    out.append(codes[prev:].tobytes())
    return b"".join(out).decode()


def simulate_to_file(
    genome_path: str,
    out_path: str,
    coverage: float = 32.4,
    distribution_path: Optional[str] = None,
    mean_length: int = 18000,
    std_length: int = 4000,
    seed: int = 0,
    error_rate: float = 0.0,
) -> int:
    """CLI-style entry mirroring ``seqrequester simulate -genome ...
    -coverage ... -distribution ...`` (``pipeline.py:167-168``).

    Prefers the native C++ simulator when built; falls back to Python.
    Returns the number of reads written. ``error_rate`` injects HiFi-like
    sequencing errors (see :func:`inject_errors`).
    """
    from gnnome_tpu_torch.data import native_bridge

    if native_bridge.available():
        return native_bridge.simulate_reads(
            genome_path, out_path, coverage, distribution_path or "", seed,
            error_rate,
        )

    genome = read_fasta_sequence(genome_path)
    if distribution_path and os.path.exists(distribution_path):
        lengths = load_length_distribution(distribution_path)
    else:
        rng = np.random.default_rng(seed + 1)
        lengths = np.maximum(
            rng.normal(mean_length, std_length, size=10000).astype(np.int64), 1000
        )
    records = simulate_reads(genome, coverage, lengths, seed=seed,
                             error_rate=error_rate)
    write_fasta(out_path, records)
    return len(records)
