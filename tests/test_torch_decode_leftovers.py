"""The port's remaining host helpers against the JAX package, on the CPU:
the ``"sequential"`` decode engine and ``get_contigs_baselines``
(``decode/greedy.py``), ``random_walk_pe_np`` and the device PageRank PE
(``data/pe.py``), and ``utils/profiling.py``.

Decoding and the random-walk PE are exact (same walks, same bits). The
PageRank PE is f32 on both sides, summed in the same edge order: rtol 1e-6.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.core.graph import build_graph as jax_build_graph
from gnnome_tpu.data import pe as jax_pe
from gnnome_tpu.decode import greedy as jax_greedy
from gnnome_tpu.utils import profiling as jax_profiling
from gnnome_tpu_torch.data import pe
from gnnome_tpu_torch.decode import greedy
from gnnome_tpu_torch.utils import profiling
from test_torch_cuda import decode_problem


def _args(p):
    return (p["src"], p["dst"], p["scores"], p["succs"], p["preds"], p["edges"],
            p["prefix_length"], p["read_length"])


@pytest.mark.parametrize("min_prob", [0.0, 0.4])
def test_sequential_engine_equals_jax(min_prob):
    p = decode_problem(5)
    kwargs = dict(nb_paths=10, len_threshold=5, min_prob=min_prob, seed=3)
    ours = greedy.get_contigs(*_args(p), engine="sequential", **kwargs)
    assert ours and ours == jax_greedy.get_contigs(*_args(p), engine="sequential", **kwargs)
    assert ours == greedy.get_contigs(*_args(p), **kwargs)  # the batched engine


def test_sequential_walkers_equal_jax():
    p = decode_problem(6, n=300)
    visited = {5, 9, 40}
    for start in range(0, 300, 7):
        for ours_fn, theirs_fn, nbrs in (
                (greedy.walk_forwards, jax_greedy.walk_forwards, p["succs"]),
                (greedy.walk_backwards, jax_greedy.walk_backwards, p["preds"])):
            for floor in (float("-inf"), 0.5):
                got = ours_fn(start, p["scores"], nbrs, p["edges"], visited, floor)
                assert got == theirs_fn(start, p["scores"], nbrs, p["edges"], visited, floor)
        walk = greedy.walk_forwards(start, p["scores"], p["succs"], p["edges"], set())[0]
        assert greedy.get_contig_length(walk, p["prefix_length"], p["read_length"],
                                        p["edges"]) == jax_greedy.get_contig_length(
            walk, p["prefix_length"], p["read_length"], p["edges"])


def test_get_contigs_baselines_equals_jax():
    p = decode_problem(7)
    args = (p["src"], p["dst"], p["scores"], p["overlap_length"], p["overlap_similarity"],
            p["succs"], p["preds"], p["edges"], p["prefix_length"], p["read_length"])
    ours = greedy.get_contigs_baselines(*args, nb_paths=10, len_threshold=5, seed=2)
    assert len(ours) == 3 and all(ours)
    assert ours == jax_greedy.get_contigs_baselines(*args, nb_paths=10, len_threshold=5, seed=2)


@pytest.mark.parametrize("n,e,k", [(30, 150, 4), (200, 900, 8)])
def test_random_walk_pe_equals_jax(n, e, k):
    rng = np.random.default_rng(n)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    got = pe.random_walk_pe_np(src, dst, n, k)
    assert got.dtype == np.float32 and got.shape == (n, k)
    np.testing.assert_array_equal(got, jax_pe.random_walk_pe_np(src, dst, n, k))


@pytest.mark.parametrize("n,e,k", [(30, 150, 4), (500, 3000, 16)])
def test_pagerank_pe_torch_matches_jax(n, e, k):
    """On the padded canonical arrays of JAX's graph (padded edges masked,
    padded nodes trailing), as tests/test_misc_parity.py calls the JAX one."""
    rng = np.random.default_rng(e)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    g = jax_build_graph(src, dst, n)
    assert g.n_nodes_padded > n and g.n_edges_padded > e
    want = np.asarray(jax_pe.pagerank_pe_jnp(jnp.asarray(g.src), jnp.asarray(g.dst),
                                             g.edge_mask, g.n_nodes_padded, k, n))
    got = pe.pagerank_pe_torch(torch.tensor(np.asarray(g.src)),
                               torch.tensor(np.asarray(g.dst)),
                               torch.tensor(np.asarray(g.edge_mask)), g.n_nodes_padded, k, n)
    assert got.dtype == torch.float32 and got.shape == (g.n_nodes_padded, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.numpy()[:n], pe.pagerank_pe_np(src, dst, n, k),
                               rtol=1e-5, atol=1e-6)


def test_timers_and_timedelta_equal_jax():
    """``timedelta_to_str`` as JAX's; the port has no ``Timers`` (a host
    clock around asynchronous launches times the enqueue): its spans and
    ``trace`` take the device's own timeline instead."""
    assert hasattr(jax_profiling, "Timers") and not hasattr(profiling, "Timers")
    for s in (0, 59.9, 61, 3600, 3725.5, 90061):
        assert profiling.timedelta_to_str(s) == jax_profiling.timedelta_to_str(s)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("decode_block"):
            torch.ones(64).cumsum(0)
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(ev.get("name") == "gnnome.decode_block" for ev in events)
