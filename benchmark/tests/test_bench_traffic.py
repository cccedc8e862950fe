"""The frozen traffic generator gives the same graphs as when the benchmark
was set up: digests of every part of each traffic file's graphs at a small
size, for a seed past 32 bits."""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.traffic import graphs

WORKLOADS = Path(__file__).resolve().parent.parent / "workloads"
TRAIN_FULL = ["6051814637aa85b6", "1b2136f66a17bc17", "26a128bf03cfda19"]
DIGESTS = {
    "train-full": TRAIN_FULL,
    # the same graphs; only the program's remat differs
    "train-full-group4": TRAIN_FULL,
    "train-cluster": ["2090c4329eecde9c", "0b490fae36cc6f3c"],
    "assemble": ["ad9f07ca4d61ac9e", "f8c46df42f5e48be"],
}


def digest(parts: dict) -> str:
    h = hashlib.sha256()
    for key in sorted(parts):
        value = parts[key]
        h.update(key.encode())
        if isinstance(value, np.ndarray):
            h.update(np.ascontiguousarray(value).tobytes())
        elif isinstance(value, dict):
            h.update(repr(sorted(value.items())[:50]).encode())
            h.update(str(len(value)).encode())
        else:
            h.update(repr(value).encode())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("traffic", sorted(DIGESTS))
def test_traffic_digests(traffic):
    tr = json.loads((WORKLOADS / f"{traffic}.json").read_text())
    tr.update(n_nodes=2000, n_edges=12000)
    got = [digest(graphs.make_graph(tr, 2**31 + 5, g, 16)) for g in range(tr["n_graphs"])]
    assert got == DIGESTS[traffic]


def test_bench_edges_digest():
    src, dst = graphs.bench_edges(2000, 12000, 3, 0.2)
    assert hashlib.sha256(src.tobytes() + dst.tobytes()).hexdigest()[:16] == "32055e290863365e"


def test_cross_locus_share():
    """11.93% of all edges join random loci at the cells' sizes' ratio."""
    n, e = 15_000, 100_000
    share = graphs.frac_long(0.1193, n, e)
    src, dst = graphs.bench_edges(n, e, 0, share)
    local = (dst - src >= 4) & (dst - src <= 22) | (np.abs(dst.astype(int) - src) == 2)
    assert abs((~local).mean() - 0.1193) < 0.01


def test_same_sizes_every_seed():
    tr = json.loads((WORKLOADS / "train-full.json").read_text())
    tr.update(n_nodes=2000, n_edges=12000)
    sizes = {tuple(len(graphs.make_graph(tr, s, g, 16)["src"]) // 100 for g in range(3))
             for s in (1, 2**31 + 11, 987654321)}
    assert len(sizes) == 1


@pytest.mark.parametrize("traffic", ["train-cluster", "assemble"])
def test_fixed_set(traffic):
    """A fixed graph set, taken in one order: every seed does the same work."""
    tr = json.loads((WORKLOADS / f"{traffic}.json").read_text())
    tr.update(n_nodes=2000, n_edges=12000)
    a, b = (digest(graphs.make_graph(tr, s, 0, 16)) for s in (1, 2**31 + 11))
    assert a == b
    assert {graphs.first_graph(tr, s) for s in range(4)} == {0}
