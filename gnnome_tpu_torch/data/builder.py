"""Overlap-graph builder: Raven-equivalent OLC front end.

The reference shells out to the external C++ assembler Raven
(``graph_dataset.py:120``: ``raven --identity 0.99 -k29 -w9 -p0``) whose
``print_graphs`` branch dumps its overlap graph as CSV + GFA. This module
is the in-repo equivalent: minimizer-based overlap detection, containment
removal, transitive reduction, and emission of the same CSV/GFA contract
our parser (and the reference's) consumes.

A native C++ implementation with the same pipeline lives in
``native/graph_builder.cpp`` (OpenMP-threaded, used for chromosome-scale
inputs through ``data/native_bridge.py`` when built, as in the JAX
package); this Python version is the executable spec and the fallback.

Graph conventions (must match ``graph_parser.py:154-311``):
  * read ``i`` (GFA line ``i``) → nodes ``2i`` (as-is) and ``2i+1``
    (reverse complement);
  * every overlap edge ``u→v`` has a strand mirror ``v^1 → u^1``;
  * CSV node rows: ``"<id> [<gfa_line>] LN:i:<len>", <pair>, 0, <trim>``;
  * CSV edge rows: ``…, 1, "<edge_id> <prefix_len> <weight> <similarity>"``.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

_COMPLEMENT = str.maketrans("ACGTacgt", "TGCAtgca")
_BASE_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


def parse_fasta(path: str) -> List[Tuple[str, str]]:
    """Parse FASTA or FASTQ (by extension) into (header, seq) pairs."""
    if path.endswith(("fastq", "fq")):
        return parse_fastq(path)
    records: List[Tuple[str, str]] = []
    header = None
    chunks: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if header is not None:
                    records.append((header, "".join(chunks).upper()))
                header = line[1:]
                chunks = []
            else:
                chunks.append(line)
    if header is not None:
        records.append((header, "".join(chunks).upper()))
    return records


def parse_fastq(path: str) -> List[Tuple[str, str]]:
    records: List[Tuple[str, str]] = []
    with open(path) as f:
        while True:
            header = f.readline()
            if not header:
                break
            seq = f.readline().strip().upper()
            f.readline()  # '+'
            f.readline()  # quality
            records.append((header[1:].strip(), seq))
    return records


def _hash64(x: int) -> int:
    # Invertible 64-bit mix (Thomas Wang), the standard minimizer hash.
    mask = (1 << 64) - 1
    x = (~x + (x << 21)) & mask
    x = x ^ (x >> 24)
    x = (x + (x << 3) + (x << 8)) & mask
    x = x ^ (x >> 14)
    x = (x + (x << 2) + (x << 4)) & mask
    x = x ^ (x >> 28)
    x = (x + (x << 31)) & mask
    return x


def minimizers(seq: str, k: int, w: int) -> List[Tuple[int, int, int]]:
    """(hash, position, strand) minimizers of ``seq``.

    Canonical k-mers: strand=0 if the forward k-mer is the smaller of the
    pair. Window minimum over ``w`` consecutive k-mers (same scheme Raven's
    ram library uses with k=29, w=9).
    """
    n = len(seq)
    if n < k:
        return []
    mask = (1 << (2 * k)) - 1
    fwd = 0
    rev = 0
    shift = 2 * (k - 1)
    hashes: List[Tuple[int, int, int]] = []  # (hash, pos, strand)
    valid = 0
    for i, ch in enumerate(seq):
        code = _BASE_CODE.get(ch)
        if code is None:
            valid = 0
            fwd = rev = 0
            continue
        fwd = ((fwd << 2) | code) & mask
        rev = (rev >> 2) | ((3 - code) << shift)
        valid += 1
        if valid >= k:
            pos = i - k + 1
            if fwd <= rev:
                hashes.append((_hash64(fwd), pos, 0))
            else:
                hashes.append((_hash64(rev), pos, 1))
    out: List[Tuple[int, int, int]] = []
    last = None
    for start in range(0, max(len(hashes) - w + 1, 1)):
        window = hashes[start : start + w]
        if not window:
            break
        m = min(window)
        if m != last:
            out.append(m)
            last = m
    return out


@dataclasses.dataclass
class Overlap:
    """Oriented overlap: suffix of oriented node ``u`` matches prefix of
    oriented node ``v`` with offset ``prefix_len`` into ``u``."""

    u: int
    v: int
    prefix_len: int
    overlap_len: int
    similarity: float


def find_overlaps(
    reads: List[str],
    k: int = 15,
    w: int = 5,
    min_overlap: int = 500,
    min_matches: int = 4,
    offset_tolerance: int = 128,
    max_gap: int = 1000,
    identity: float = 0.0,
    trim_min_cov: int = 0,
    return_trims: bool = False,
):
    """All suffix→prefix overlaps between oriented reads + containment flags.

    Returns ``(overlaps, contained)`` — overlaps on *node* ids (2i / 2i+1)
    and a per-read contained flag (contained reads are dropped before graph
    emission, mirroring Raven — cf. the note at ``graph_parser.py:126``).
    With ``return_trims=True`` also returns per-read trims ``(t0, t1)``
    (``None`` = read dropped by pile trimming).

    Every candidate is *verified*: the in-cluster matched minimizers must
    span the full claimed overlap window (ends within ``max_gap``, no
    internal gap over ``max_gap``).  Without this, two reads sharing only
    an interspersed-repeat interior vote a consistent offset and produce a
    false overlap/containment between distant loci — and because every
    cross-locus edge is anchored to the *same* repeat coordinates, the
    phantom A→B→A paths they form have exactly-summing prefix lengths,
    which makes Myers transitive reduction delete the *true* local edges
    (verified empirically: at 10 Mb / 32x every missing true edge was
    explained only by paths through the repeat's other copy).  Alignment-
    based assemblers (Raven, ``graph_dataset.py:118-122``) get this for
    free from alignment extension; minimizer-chain span is the equivalent
    check.

    Noisy-read support (the role of Raven's ``--identity`` flag,
    ``graph_dataset.py:120``):

      * ``identity > 0`` gates every overlap on a k-mer identity estimate:
        the fraction of read-a minimizers inside the overlap window that
        found an offset-consistent match in b is ≈ I^k for pairwise
        alignment identity I (a k-mer match needs all k columns to agree),
        so ``I_est = match_frac ** (1/k)``.  Overlaps with ``I_est <
        identity`` are dropped, and ``I_est`` is emitted as the edge
        similarity (Raven's similarity semantics).
      * ``trim_min_cov > 0`` enables pile trimming (Raven's pile-o-gram):
        each read is trimmed to its longest region covered by ≥
        ``trim_min_cov`` span-verified overlap windows; overlap offsets,
        lengths, and containment are then re-derived in trimmed
        coordinates.  Reads with no such region are dropped.
    """
    n_reads = len(reads)
    read_lens = [len(r) for r in reads]
    index: Dict[int, List[Tuple[int, int, int]]] = defaultdict(list)
    mins: List[List[Tuple[int, int, int]]] = []
    for rid, seq in enumerate(reads):
        ms = minimizers(seq, k, w)
        mins.append(ms)
        for h, pos, strand in ms:
            index[h].append((rid, pos, strand))
    # per-read sorted minimizer positions (identity-estimate denominator)
    mins_pos = [np.asarray([p for _, p, _ in ms], dtype=np.int64) for ms in mins]

    # candidate pairs → oriented offset votes
    votes: Dict[Tuple[int, int, int], List[Tuple[int, int]]] = defaultdict(list)
    for rid, ms in enumerate(mins):
        for h, pos, strand in ms:
            for oid, opos, ostrand in index[h]:
                if oid <= rid:
                    continue
                orient = strand ^ ostrand  # 0: same strand, 1: flipped
                if orient == 0:
                    diff = pos - opos
                else:
                    diff = pos - (read_lens[oid] - k - opos)
                votes[(rid, oid, orient)].append((diff, pos))

    # pass 1: cluster votes, span-verify, estimate identity; collect piles.
    # Classification (overlap vs containment) waits for pass 2 — it
    # depends on the trims, which depend on every candidate's pile.
    candidates: List[Tuple[int, int, int, int, float]] = []  # (a,b,orient,t,sim)
    piles: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for (a, b, orient), pairs in votes.items():
        if len(pairs) < min_matches:
            continue
        # strongest offset cluster (max votes within a 2*tol window over
        # the sorted diffs), not the global median: tandem repeats and
        # noisy reads produce multi-modal vote distributions whose median
        # can land between clusters and fail the support check
        arr = np.asarray(pairs, dtype=np.int64)  # [n, 2]: (diff, pos-in-a)
        diffs = np.sort(arr[:, 0])
        j_idx = np.searchsorted(diffs, diffs + 2 * offset_tolerance, side="right")
        counts = j_idx - np.arange(len(diffs))
        bi = int(np.argmax(counts))
        t = int(diffs[bi + int(counts[bi]) // 2])
        in_cluster = np.abs(arr[:, 0] - t) <= offset_tolerance
        support = int(in_cluster.sum())
        if support < min_matches:
            continue
        la, lb = read_lens[a], read_lens[b]
        # claimed overlap window in a-forward coordinates: oriented-b spans
        # [t, t+lb); intersect with a's [0, la)
        wa_lo, wa_hi = max(0, t), min(la, t + lb)
        spanned = _verify_span(
            np.sort(arr[in_cluster, 1]), wa_lo, wa_hi, k, max_gap
        )
        if not spanned:
            continue
        ovl = wa_hi - wa_lo
        if identity > 0:
            apos = mins_pos[a]
            denom = int(np.searchsorted(apos, wa_hi) - np.searchsorted(apos, wa_lo))
            matched = int(np.unique(arr[in_cluster, 1]).size)
            ident_est = min(1.0, matched / max(denom, 1)) ** (1.0 / k)
            if ident_est < identity:
                continue
            sim = ident_est
        else:
            sim = min(1.0, support / max(1.0, 2.0 * ovl / (w + 1)))
        if trim_min_cov > 0:
            piles[a].append((wa_lo, wa_hi))
            wb_lo, wb_hi = max(0, -t), min(lb, la - t)  # oriented-b coords
            if orient == 1:
                wb_lo, wb_hi = lb - wb_hi, lb - wb_lo
            piles[b].append((wb_lo, wb_hi))
        candidates.append((a, b, orient, t, sim))

    if trim_min_cov > 0:
        trims = _pile_trims(piles, read_lens, trim_min_cov, min_overlap)
    else:
        trims = [(0, ln) for ln in read_lens]

    # pass 2: classify candidates in trimmed coordinates
    overlaps: List[Overlap] = []
    contained = [False] * n_reads
    for r in range(n_reads):
        if trims[r] is None:
            contained[r] = True  # dropped by trimming

    for a, b, orient, t, sim in candidates:
        if trims[a] is None or trims[b] is None:
            continue
        la, lb = read_lens[a], read_lens[b]
        ta0, ta1 = trims[a]
        tb0, tb1 = trims[b]
        # oriented-b trim window (reverse-complement flips intervals)
        ob0, ob1 = (tb0, tb1) if orient == 0 else (lb - tb1, lb - tb0)
        t2 = (t + ob0) - ta0  # trimmed-oriented-b start in trimmed-a coords
        la2, lb2 = ta1 - ta0, ob1 - ob0
        wa_lo, wa_hi = max(0, t2), min(la2, t2 + lb2)
        ovl = wa_hi - wa_lo
        if ovl <= 0:
            continue
        if t2 >= 0:
            if t2 + lb2 <= la2:
                contained[b] = True
                continue
            if ovl < min_overlap:
                continue
            # a's suffix → b's prefix: edge 2a → 2b+orient, mirror
            u, v = 2 * a, 2 * b + orient
            overlaps.append(Overlap(u, v, t2, ovl, sim))
            overlaps.append(Overlap(v ^ 1, u ^ 1, lb2 - ovl, ovl, sim))
        else:
            t3 = -t2
            if t3 + la2 <= lb2:
                contained[a] = True
                continue
            if ovl < min_overlap:
                continue
            # oriented-b's suffix → a's prefix
            u, v = 2 * b + orient, 2 * a
            overlaps.append(Overlap(u, v, t3, ovl, sim))
            overlaps.append(Overlap(v ^ 1, u ^ 1, la2 - ovl, ovl, sim))

    if return_trims:
        return overlaps, contained, trims
    return overlaps, contained


def _pile_trims(
    piles: Dict[int, List[Tuple[int, int]]],
    read_lens: List[int],
    min_cov: int,
    min_len: int,
) -> List[Optional[Tuple[int, int]]]:
    """Longest per-read region covered by ≥ ``min_cov`` overlap windows.

    The Python restatement of Raven's pile-o-gram trim: coverage events
    from every span-verified overlap window, swept for the longest
    contiguous ≥min_cov run. Reads whose best run is shorter than
    ``min_len`` are dropped (returned as ``None``)."""
    trims: List[Optional[Tuple[int, int]]] = []
    for r, ln in enumerate(read_lens):
        ivs = piles.get(r)
        if not ivs:
            trims.append(None)
            continue
        events = sorted(
            [(lo, 1) for lo, _ in ivs] + [(hi, -1) for _, hi in ivs]
        )
        cov = 0
        best = (0, 0)
        run_start = None
        for pos, delta in events:
            was = cov
            cov += delta
            if was < min_cov <= cov:
                run_start = pos
            elif cov < min_cov <= was and run_start is not None:
                if pos - run_start > best[1] - best[0]:
                    best = (run_start, pos)
                run_start = None
        if best[1] - best[0] < min_len:
            trims.append(None)
        else:
            trims.append(best)
    return trims


def _verify_span(
    pos_sorted: np.ndarray, lo: int, hi: int, k: int, max_gap: int
) -> bool:
    """True when matched k-mer positions cover [lo, hi): both ends reached
    within ``max_gap`` and no internal gap exceeds ``max_gap``."""
    if len(pos_sorted) == 0:
        return False
    if int(pos_sorted[0]) > lo + max_gap:
        return False
    if int(pos_sorted[-1]) + k < hi - max_gap:
        return False
    if len(pos_sorted) > 1 and int(np.diff(pos_sorted).max()) > max_gap:
        return False
    return True


def transitive_reduction(
    overlaps: List[Overlap], n_nodes: int, fuzz: int = 500
) -> List[Overlap]:
    """Myers' transitive edge reduction: drop a→c when a→b→c explains it.

    Decisions are symmetrized over strand-mirror pairs (a pair is dropped
    when EITHER orientation is explained, as Raven marks both an edge and
    its pair): the Myers mid-node traversal orders candidates by prefix
    length, which is start-order on one strand but *end*-order on the
    mirror strand — with variable read lengths the two orders differ, and
    an asymmetric drop would break the ``u→v ⇒ v^1→u^1`` invariant the
    oracle and decoder rely on (``algorithms.py:139``, ``inference.py:63``).
    ``find_overlaps`` appends every overlap and its mirror adjacently, so
    pair ``k`` is indices ``(2k, 2k+1)``.
    """
    adj: Dict[int, List[Overlap]] = defaultdict(list)
    for o in overlaps:
        adj[o.u].append(o)
    for u in adj:
        adj[u].sort(key=lambda o: o.prefix_len)

    def is_reduced(o: Overlap) -> bool:
        for mid in adj[o.u]:
            if mid.v == o.v or mid.prefix_len >= o.prefix_len:
                continue
            for far in adj.get(mid.v, []):
                if far.v == o.v and abs(
                    mid.prefix_len + far.prefix_len - o.prefix_len
                ) <= fuzz:
                    return True
        return False

    assert len(overlaps) % 2 == 0
    keep = []
    for i in range(0, len(overlaps), 2):
        o, m = overlaps[i], overlaps[i + 1]
        assert o.u == m.v ^ 1 and o.v == m.u ^ 1, "mirror pairs not adjacent"
        if not (is_reduced(o) or is_reduced(m)):
            keep.append(o)
            keep.append(m)
    return keep


def emit_graph(
    headers: List[str],
    reads: List[str],
    overlaps: List[Overlap],
    contained: List[bool],
    csv_path: str,
    gfa_path: Optional[str] = None,
    trims: Optional[List[Optional[Tuple[int, int]]]] = None,
) -> None:
    """Write CSV + GFA in the reference contract (``graph_parser.py:187-200``).

    ``trims``: per-read ``(t0, t1)`` pile trims. The GFA carries the
    *trimmed* sequences (the parser's sequences "are already trimmed",
    ``graph_parser.py:123``), node LN fields the trimmed lengths, and
    trimmed node rows the ``"t0 t1"`` payload the reference parser applies
    to the simulator headers' genome coordinates (``graph_parser.py:241-250``).
    """
    if gfa_path is None:
        gfa_path = csv_path[:-3] + "gfa"

    def trim_of(r: int) -> Tuple[int, int]:
        if trims is None or trims[r] is None:
            return (0, len(reads[r]))
        return trims[r]

    # keep non-contained reads that appear in at least one overlap
    used_reads = sorted(
        {o.u // 2 for o in overlaps} | {o.v // 2 for o in overlaps}
    )
    used_reads = [r for r in used_reads if not contained[r]]
    used = set(used_reads)
    overlaps = [o for o in overlaps if o.u // 2 in used and o.v // 2 in used]

    # new node ids: read r (gfa line g) → nodes 2g, 2g+1
    read_to_line = {r: g for g, r in enumerate(used_reads)}

    def node_id(old_node: int) -> int:
        return 2 * read_to_line[old_node // 2] + (old_node & 1)

    with open(gfa_path, "w") as f:
        for r in used_reads:
            rid = headers[r].split()[0]
            t0, t1 = trim_of(r)
            seq = reads[r][t0:t1]
            f.write(f"S\t{rid}\t{seq}\tLN:i:{len(seq)}\tRC:i:1\n")

    def node_field(node: int) -> str:
        g = node // 2
        t0, t1 = trim_of(used_reads[g])
        return f"{node} [{g}] LN:i:{t1 - t0}"

    with open(csv_path, "w") as f:
        for g, r in enumerate(used_reads):
            t0, t1 = trim_of(r)
            payload = "-" if (t0, t1) == (0, len(reads[r])) else f"{t0} {t1}"
            f.write(f"{node_field(2 * g)},{node_field(2 * g + 1)},0,{payload}\n")
        for eid, o in enumerate(overlaps):
            u, v = node_id(o.u), node_id(o.v)
            f.write(
                f"{node_field(u)},{node_field(v)},1,"
                f"{eid} {o.prefix_len} {o.overlap_len} {o.similarity:.4f}\n"
            )


def build_overlap_graph(
    reads_path: str,
    csv_path: str,
    threads: int = 32,
    identity: float = 0.99,
    k: int = 15,
    w: int = 5,
    min_overlap: int = 500,
    noisy: bool = False,
    trim_min_cov: int = 3,
) -> None:
    """End-to-end builder: reads FASTA → CSV/GFA on disk.

    Prefers the native C++ builder when available (chromosome scale);
    falls back to this Python implementation.

    ``noisy=True`` enables the error-tolerant front end (the role of
    Raven's default mode on real HiFi reads, ``graph_dataset.py:118-122``):
    the ``identity`` k-mer identity gate and pile trimming at
    ``trim_min_cov`` coverage (trim payloads + trimmed GFA sequences are
    emitted per the parser contract, ``graph_parser.py:241-250``).
    Error-free simulated reads keep the exact legacy output with
    ``noisy=False`` (vote-density similarity, no trimming).
    """
    from gnnome_tpu_torch.data import native_bridge

    if native_bridge.available():
        native_bridge.build_overlap_graph(
            reads_path, csv_path, threads, identity if noisy else 0.0,
            k, w, min_overlap, trim_min_cov if noisy else 0,
        )
        return

    records = parse_fasta(reads_path)
    headers = [h for h, _ in records]
    reads = [s for _, s in records]
    overlaps, contained, trims = find_overlaps(
        reads, k=k, w=w, min_overlap=min_overlap,
        identity=identity if noisy else 0.0,
        trim_min_cov=trim_min_cov if noisy else 0,
        return_trims=True,
    )
    # Remove contained reads BEFORE transitive reduction (Raven's order):
    # reducing first can delete an edge as "explained" by a path through a
    # read that containment-removal then deletes, leaving spurious dead
    # ends where the genome is perfectly covered.
    overlaps = [
        o for o in overlaps
        if not (contained[o.u // 2] or contained[o.v // 2])
    ]
    overlaps = transitive_reduction(overlaps, 2 * len(reads))
    emit_graph(headers, reads, overlaps, contained, csv_path,
               trims=trims if noisy else None)
