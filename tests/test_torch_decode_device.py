"""The port's device decode engine (``decode/device_walker.py``) against the
JAX package's (``decode/tpu_walker.py``) and both packages' host engines,
on the CPU, where ``walk_batch`` runs its plain version.

Everything here is integers and compares on f32 scores, so every check is
exact: the padded tables, each leg's walks, lengths, base counts and
visited rows, and the contigs walk for walk. Scores are cast to f32 before
every engine, as tests/test_decode_tpu.py does (the device tables are f32).
Fixtures: the 22 kb genome of tests/test_decode_tpu.py (its overlap graph
and oracle labels, scores that favour the true edges plus noise), and a
hand-built graph with an odd node count, nodes of 40 successors and of 40
predecessors (K > 32), scores in four levels (ties everywhere), a
single-successor cycle (hops into visited nodes until the step cap) and a
random global visited set.
"""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.data.dataset import AssemblyGraphDataset as JaxDataset
from gnnome_tpu.data.simulate import simulate_reads, write_fasta
from gnnome_tpu.decode import greedy as jax_greedy
from gnnome_tpu.decode import tpu_walker
from gnnome_tpu_torch.decode import greedy
from gnnome_tpu_torch.decode.device_walker import NO_FLOOR, PaddedAdjacency, walk_batch
from test_torch_cuda import hand_graph, tiny_tables


@pytest.fixture(scope="module")
def genome_graph(tmp_path_factory):
    """The 22 kb fixture of tests/test_decode_tpu.py: the decode arguments
    with f32 scores."""
    root = tmp_path_factory.mktemp("decode_device_ds")
    rng = np.random.default_rng(13)
    genome = "".join(rng.choice(list("ACGT"), size=22_000))
    records = simulate_reads(genome, coverage=13.0,
                             lengths=np.full(380, 1_700, dtype=np.int64), seed=6)
    os.makedirs(root / "raw", exist_ok=True)
    write_fasta(str(root / "raw" / "0.fasta"), records)
    (_, sample), = JaxDataset(str(root), nb_pos_enc=8)
    info = []
    for kind in ("succ", "pred", "edges"):
        with open(root / "info" / f"0_{kind}.pkl", "rb") as f:
            info.append(pickle.load(f))
    y = np.asarray(sample.y)[: sample.graph.n_edges]
    scores = (np.where(y == 1, 2.5, -2.5)
              + np.random.default_rng(4).standard_normal(len(y)) * 2.0).astype(np.float32)
    return dict(src=np.asarray(sample.src), dst=np.asarray(sample.dst), scores=scores,
                succs=info[0], preds=info[1], edges=info[2],
                prefix_length=np.asarray(sample.prefix_length),
                read_length=np.asarray(sample.read_length))


def _tables(g, n_pad, reverse):
    """(JAX's PaddedAdjacency, the port's) of one direction."""
    nbrs = g["preds"] if reverse else g["succs"]
    return [cls(nbrs, g["edges"], g["scores"].astype(np.float64), g["prefix_length"], n_pad,
                reverse=reverse)
            for cls in (tpu_walker.PaddedAdjacency, PaddedAdjacency)]


@pytest.mark.parametrize("which", ["genome", "hand"])
@pytest.mark.parametrize("reverse", [False, True])
def test_padded_adjacency_equals_jax(genome_graph, which, reverse):
    g = genome_graph if which == "genome" else hand_graph()
    n = len(g["read_length"])
    theirs, ours = _tables(g, n + (n & 1), reverse)
    assert ours.k == theirs.k and (which == "genome" or ours.k > 32)
    for name in ("nbr", "score", "prefix", "deg"):
        got, want = getattr(ours, name), getattr(theirs, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _legs(g, min_score, seed):
    """A forward leg from every node against a random global visited set,
    then a backward leg frozen on the forward leg's marks, in both
    packages; yields (leg, ours, theirs)."""
    n = len(g["read_length"])
    n_pad, max_steps = n + (n & 1), n + 2
    rng = np.random.default_rng(seed)
    vg = (rng.random(n_pad) < 0.1).astype(np.uint8)
    starts = np.arange(n, dtype=np.int32)
    frozen = None
    for leg, reverse in (("forward", False), ("backward", True)):
        theirs_t, ours_t = _tables(g, n_pad, reverse)
        vg2 = np.broadcast_to(vg, (n, n_pad))
        if frozen is not None:
            vg2 = np.maximum(vg2, frozen)
        theirs = tpu_walker._walk_batch(
            *(jnp.asarray(getattr(theirs_t, k)) for k in ("nbr", "score", "prefix", "deg")),
            jnp.asarray(starts), jnp.asarray(vg2), jnp.float32(min_score),
            max_steps=max_steps, n_pad=n_pad)
        ours = walk_batch(ours_t.tensors("cpu"), torch.from_numpy(starts), torch.from_numpy(vg),
                          None if frozen is None else torch.from_numpy(frozen), min_score,
                          max_steps)
        yield leg, ours, [np.asarray(x) for x in theirs]
        frozen = ours.visited.numpy()


@pytest.mark.parametrize("which", ["genome", "hand"])
@pytest.mark.parametrize("floor", ["none", "finite"])
def test_walk_batch_plain_equals_jax(genome_graph, which, floor):
    g = genome_graph if which == "genome" else hand_graph()
    min_score = NO_FLOOR if floor == "none" else 0.25
    capped = False
    for leg, ours, theirs in _legs(g, min_score, seed=3):
        for name, got, want in zip(("walks", "lengths", "bp", "visited"), ours, theirs):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{leg} {name}")
        assert ours.bp.dtype == torch.int64 and ours.walks.dtype == torch.int32
        capped |= bool((ours.lengths == ours.walks.shape[1]).any())
    # the single-successor cycle runs to the step cap when nothing stops it
    assert capped == (which == "hand" and floor == "none")


def test_walk_batch_takes_the_first_max_and_single_hops():
    """Ties go to the lowest slot; a single neighbor is taken though it is
    visited; a row whose neighbors are all visited stops the walk."""
    vg = torch.tensor([0, 0, 0, 0, 0, 0, 0, 0], dtype=torch.uint8)
    starts = torch.tensor([0, 2], dtype=torch.int32)
    out = walk_batch(tiny_tables(), starts, vg, None, NO_FLOOR, 6)
    assert out.walks.tolist() == [[0, 4, 6, -1, -1, -1], [2, 0, 4, 6, -1, -1]]
    assert out.lengths.tolist() == [3, 4] and out.bp.tolist() == [80, 120]
    vg[0] = 1  # 2 still hops to 0; 0's walk is not stopped by its own start
    out = walk_batch(tiny_tables(), starts, vg, None, NO_FLOOR, 6)
    assert out.walks[:, :4].tolist() == [[0, 4, 6, -1], [2, 0, 4, 6]]
    # a floor of 2.5 stops both before their first hop, one of 1.0 neither
    out = walk_batch(tiny_tables(), starts, vg, None, 2.5, 6)
    assert out.lengths.tolist() == [1, 1]
    out = walk_batch(tiny_tables(), starts, vg, None, 1.0, 6)
    assert out.lengths.tolist() == [3, 4]


@pytest.mark.parametrize("min_prob", [0.0, 0.4])
def test_device_engine_equals_host_engines_and_jax(genome_graph, min_prob):
    g = genome_graph
    args = (g["src"], g["dst"], g["scores"], g["succs"], g["preds"], g["edges"],
            g["prefix_length"], g["read_length"])
    kwargs = dict(nb_paths=10, len_threshold=5, min_prob=min_prob)
    for seed in (7, 11):
        ours = greedy.get_contigs(*args, engine="device", device="cpu", seed=seed, **kwargs)
        assert ours, seed
        assert ours == greedy.get_contigs(*args, engine="batched", seed=seed, **kwargs)
        for engine in ("tpu", "batched"):
            assert ours == jax_greedy.get_contigs(*args, engine=engine, seed=seed,
                                                  **kwargs), (seed, engine)


def test_unknown_engine_raises(genome_graph):
    g = genome_graph
    with pytest.raises(ValueError, match="unknown decode engine"):
        greedy.get_contigs(g["src"], g["dst"], g["scores"], g["succs"], g["preds"],
                           g["edges"], g["prefix_length"], g["read_length"], engine="tpu")


def test_device_engine_without_cuda_raises(genome_graph, monkeypatch):
    """No silent fallback to the CPU: the default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = genome_graph
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        greedy.get_contigs(g["src"], g["dst"], g["scores"], g["succs"], g["preds"],
                           g["edges"], g["prefix_length"], g["read_length"], engine="device")
