"""The port's ClusterGCN regime on the CPU, held against the JAX package:
the partitioner, the induced subgraphs, the cluster sampler, a minibatch
epoch, ``train()`` under a ClusterGCN config, and the native bridge.

Inputs are made with numpy from a seed and fed to both packages. The host
side (partition, cluster order, piece arrays) must match exactly: both
packages draw from ``random.Random(seed)`` and partition with the same
algorithm. The device side runs the JAX package's xla backend and the
port's plain (CPU) kernel versions; parameters cross through
``params_from_jax``.

Tolerances (the bounds of tests/test_torch_train.py): losses, metrics and
parameters after the minibatch steps rtol = atol = 1e-5, f32 summation
order; the biases whose exact gradient is zero (a BatchNorm follows them)
are held to their start within lr per Adam step on both sides, since Adam
turns their rounding-noise gradient into steps of up to lr.
"""
import filecmp
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.config import Config as JaxConfig
from gnnome_tpu.core.graph import build_graph as jax_build_graph
from gnnome_tpu.core.graph import pad_features as jax_pad_features
from gnnome_tpu.core.graph import prepare_edge_features as jax_prepare
from gnnome_tpu.data import builder as jax_builder
from gnnome_tpu.data import native_bridge as jax_native
from gnnome_tpu.data import simulate as jax_simulate
from gnnome_tpu.data.dataset import GraphSample as JaxGraphSample
from gnnome_tpu.models.model import init_model_params as jax_init
from gnnome_tpu.parallel import partition as jax_partition
from gnnome_tpu.train import cluster as jax_cluster
from gnnome_tpu.train import loop as jax_loop
from gnnome_tpu.train.checkpoint import _flatten
from gnnome_tpu_torch.config import Config
from gnnome_tpu_torch.core.graph import build_graph, prepare_edge_features
from gnnome_tpu_torch.data import builder, native_bridge, simulate
from gnnome_tpu_torch.data.dataset import GraphSample
from gnnome_tpu_torch.parallel import partition
from gnnome_tpu_torch.train import checkpoint as ckpt
from gnnome_tpu_torch.train import cluster, loop
from gnnome_tpu_torch.train.checkpoint import params_from_jax
from test_torch_train import BN_CANCELLED, LR, genome_root  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
GENOME_RTOL = 2e-3  # train() on the genome graph: see its test


def chain_pairs(rng, n_reads, extra):
    """A double-strand overlap chain (read ``i`` is nodes ``2i``/``2i+1``)
    with ``extra`` short skip edges, in shuffled (parser) order."""
    r = np.arange(n_reads - 1)
    src = [2 * r, 2 * (r + 1) + 1]
    dst = [2 * (r + 1), 2 * r + 1]
    s = rng.integers(0, 2 * n_reads, extra)
    src.append(s)
    dst.append(np.minimum(s + 2 * rng.integers(1, 8, extra), 2 * n_reads - 1))
    src, dst = np.concatenate(src).astype(np.int32), np.concatenate(dst).astype(np.int32)
    keep = src != dst
    perm = rng.permutation(int(keep.sum()))
    return src[keep][perm], dst[keep][perm], 2 * n_reads


def both_samples(rng, n_reads=150, extra=500, nb_pos_enc=4, reorder=True):
    """The same graph as a JAX and a port GraphSample, laid out as
    ``load_sample`` lays them out: the device graph in locality order
    (``node_map``) or in parser order, features in device order, host
    arrays in parser order; random features and 70% positive labels."""
    src, dst, n = chain_pairs(rng, n_reads, extra)
    e = len(src)
    e_feat = rng.standard_normal((e, 2)).astype(np.float32)
    pe_parser = rng.standard_normal((n, nb_pos_enc + 2)).astype(np.float32)
    y = (rng.random(e) < 0.7).astype(np.float32)
    node_map = (partition.locality_order_pairs(src, dst, n) if reorder
                else np.arange(n, dtype=np.int32))
    pe = np.empty_like(pe_parser)
    pe[node_map] = pe_parser
    host = dict(
        prefix_length=rng.integers(100, 2000, e), read_length=rng.integers(1000, 3000, n),
        overlap_length=rng.integers(500, 3000, e),
        overlap_similarity=rng.random(e).astype(np.float32), src=src, dst=dst,
        node_map=node_map if reorder else None)
    jg = jax_build_graph(node_map[src], node_map[dst], n)
    jsample = JaxGraphSample(idx=0, graph=jg, e_feat=jax_prepare(jg, e_feat),
                             pe=jnp.asarray(jax_pad_features(pe, jg.n_nodes_padded)),
                             y=jax_prepare(jg, y), **host)
    g = build_graph(node_map[src], node_map[dst], n, device="cpu")
    sample = GraphSample(idx=0, graph=g, e_feat=prepare_edge_features(g, e_feat),
                         pe=torch.from_numpy(pe), y=prepare_edge_features(g, y), **host)
    return jsample, sample


# ---------------------------------------------------------------------------
# (a) the partitioner and its statistics
# ---------------------------------------------------------------------------

def _random_pairs(rng, n_reads=120, e=700):
    src = rng.integers(0, 2 * n_reads, e).astype(np.int32)
    dst = rng.integers(0, 2 * n_reads, e).astype(np.int32)
    keep = src != dst
    return src[keep], dst[keep], 2 * n_reads


PARTITION_CASES = {
    # pair-aligned on read ids, a chain and a random graph
    "partition_chain": lambda m, rng: m.partition_nodes(*chain_pairs(rng, 300, 400), 10),
    "partition_random": lambda m, rng: m.partition_nodes(*_random_pairs(rng), 7),
    # odd n: no pairing, partitioned node by node
    "partition_odd_n": lambda m, rng: m.partition_nodes(
        *_random_pairs(rng)[:2], 241, 6),
    "partition_unaligned": lambda m, rng: m.partition_nodes(
        *chain_pairs(rng, 100, 100), 9, pair_aligned=False),
    # num_parts above n (and above the read count) is clamped
    "partition_parts_above_n": lambda m, rng: m.partition_nodes(
        *chain_pairs(rng, 10, 10), 50),
    "partition_empty": lambda m, rng: m.partition_nodes(
        np.zeros(0, np.int32), np.zeros(0, np.int32), 0, 4),
    "bfs_order": lambda m, rng: m.bfs_order(*_random_pairs(rng)),
    "edge_cut_fraction": lambda m, rng: m.edge_cut_fraction(
        rng.integers(0, 5, 240), *_random_pairs(rng)[:2]),
    "edge_cut_fraction_empty": lambda m, rng: m.edge_cut_fraction(
        np.zeros(4, np.int32), np.zeros(0, np.int32), np.zeros(0, np.int32)),
    "band_statistics": lambda m, rng: m.band_statistics(*_random_pairs(rng)[:2]),
    "band_statistics_empty": lambda m, rng: m.band_statistics(
        np.zeros(0, np.int32), np.zeros(0, np.int32)),
}


@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
def test_partition_matches_jax(case):
    fn = PARTITION_CASES[case]
    got = fn(partition, np.random.default_rng(3))
    want = fn(jax_partition, np.random.default_rng(3))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
    if case.startswith("partition") and case != "partition_empty":
        assert got.min() == 0
        if case != "partition_unaligned" and case != "partition_odd_n":
            np.testing.assert_array_equal(got[0::2], got[1::2])  # strand mates together


# ---------------------------------------------------------------------------
# (b) induced subgraphs, (c) the sampler
# ---------------------------------------------------------------------------

def test_induced_subgraph_matches_jax():
    rng = np.random.default_rng(5)
    jsample, sample = both_samples(rng)
    for node_ids in (np.arange(0, 120), np.sort(rng.choice(300, 77, replace=False)),
                     np.zeros(0, np.int64)):
        got = cluster.induced_subgraph(sample, node_ids)
        want = jax_cluster.induced_subgraph(jsample, node_ids)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        sub_src, sub_dst, edge_ids, _ = got
        np.testing.assert_array_equal(node_ids[sub_src], sample.src[edge_ids])
        np.testing.assert_array_equal(node_ids[sub_dst], sample.dst[edge_ids])


def _recorded(monkeypatch, module):
    """Record the part counts and the induced subgraphs ``module``'s
    sampler asks for."""
    calls = {"k": [], "sub": []}
    part, induce = module.partition_nodes, module.induced_subgraph

    def partition_nodes(src, dst, n, k, *a, **kw):
        calls["k"].append(k)
        return part(src, dst, n, k, *a, **kw)

    def induced_subgraph(sample, node_ids):
        calls["sub"].append(induce(sample, node_ids))
        return calls["sub"][-1]

    monkeypatch.setattr(module, "partition_nodes", partition_nodes)
    monkeypatch.setattr(module, "induced_subgraph", induced_subgraph)
    return calls


@pytest.mark.parametrize("regime", ["recluster_jitter", "eval_cached", "parser_order"])
def test_cluster_sampler_matches_jax(regime, monkeypatch):
    """Three calls of one sampler: the same part counts, cluster order,
    pieces (ids, padded sizes, canonical graph arrays, features, labels,
    host arrays) as the JAX sampler's."""
    rng = np.random.default_rng(11)
    jsample, sample = both_samples(rng, reorder=regime != "parser_order")
    kw = dict(num_parts=12, batch_size=3, nb_pos_enc=4, seed=4, jitter=5,
              recluster=regime != "eval_cached")
    ours, theirs = _recorded(monkeypatch, cluster), _recorded(monkeypatch, jax_cluster)
    sampler, jsampler = cluster.make_cluster_sampler(**kw), jax_cluster.make_cluster_sampler(**kw)
    n_pieces = []
    for _ in range(3):
        got, want = sampler(sample), jsampler(jsample)
        assert len(got) == len(want) > 1
        n_pieces.append(len(got))
        for p, q in zip(got, want):
            g, jg = p.graph, q.graph
            assert (g.n_nodes, g.n_edges, g.n_nodes_padded, g.n_edges_padded) == \
                (jg.n_nodes, jg.n_edges, jg.n_nodes_padded, jg.n_edges_padded)
            assert g.n_nodes_padded % 512 == 0 and g.n_edges_padded % 1024 == 0
            np.testing.assert_array_equal(g.src.numpy(), np.asarray(jg.src))
            np.testing.assert_array_equal(g.dst.numpy(), np.asarray(jg.dst))
            for name in ("e_feat", "pe", "y"):
                np.testing.assert_array_equal(getattr(p, name).numpy(),
                                              np.asarray(getattr(q, name)), err_msg=name)
            for name in ("src", "dst", "prefix_length", "read_length", "overlap_length",
                         "overlap_similarity"):
                np.testing.assert_array_equal(getattr(p, name), getattr(q, name),
                                              err_msg=name)
    assert ours["k"] == theirs["k"]
    if regime == "eval_cached":
        assert ours["k"] == [12]  # partitioned once, then cached
    else:
        assert len(ours["k"]) == 3 and all(7 <= k < 17 for k in ours["k"])
    assert len(ours["sub"]) == len(theirs["sub"]) == sum(n_pieces)
    for a, b in zip(ours["sub"], theirs["sub"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # every call covers every node exactly once
    covered = np.concatenate([s[3] for s in ours["sub"][-n_pieces[-1]:]])
    np.testing.assert_array_equal(np.sort(covered), np.arange(sample.graph.n_nodes))


# ---------------------------------------------------------------------------
# (d) a minibatch epoch, (e) train() under ClusterGCN
# ---------------------------------------------------------------------------

def _configs(**train_kw):
    model = dict(hidden_features=32, num_gnn_layers=3, nb_pos_enc=4, hidden_edge_scores=16)
    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        for k, v in model.items():
            setattr(c.model, k, v)
        for k, v in train_kw.items():
            setattr(c.train, k, v)
    jcfg.train.backend = "xla"
    return jcfg, cfg


def _check_params(got, want, start, n_steps):
    for k, w in want.items():
        if k.endswith(BN_CANCELLED):
            for p in (got[k], w):
                assert np.abs(p - start[k]).max() <= n_steps * LR * (1 + 1e-3), k
        else:
            np.testing.assert_allclose(got[k], w, **TOL, err_msg=k)


def test_cluster_epoch_matches_jax():
    """One training epoch over two graphs' pieces, then one
    cluster-validation pass: losses, metrics and parameters as JAX's."""
    rng = np.random.default_rng(21)
    pairs = [both_samples(rng, nb_pos_enc=4) for _ in range(2)]
    for i, (js, s) in enumerate(pairs):
        js.idx = s.idx = i
    jcfg, cfg = _configs()
    jparams = jax_init(jax.random.PRNGKey(6), jcfg.model)
    start = _flatten(jparams)
    params = params_from_jax(start, device="cpu")
    opt = loop.make_optimizer(params, LR)
    jstate = jax_loop.set_lr(jax_loop.make_optimizer().init(jparams), LR)

    kw = dict(num_parts=10, batch_size=3, nb_pos_enc=4, seed=2, jitter=3)
    train_fn = cluster.make_cluster_sampler(**kw)
    steps = []

    def counted(sample):
        steps.append(len(pieces := train_fn(sample)))
        return pieces

    got = loop._epoch_pass([(s.idx, s) for _, s in pairs], params, opt,
                           torch.tensor(0.5), cfg, True, counted)
    jparams, jstate, want = jax_loop._epoch_pass(
        [(js.idx, js) for js, _ in pairs], jparams, jstate, jnp.float32(0.5), jcfg, True,
        jax_cluster.make_cluster_sampler(**kw))
    assert set(got) == set(want) and len(steps) == 2 and sum(steps) > 4
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    _check_params(ckpt.flatten_params(params), _flatten(jparams), start, sum(steps))

    kw = dict(num_parts=6, batch_size=2, nb_pos_enc=4, seed=3, jitter=0, recluster=False)
    got = loop._epoch_pass([(s.idx, s) for _, s in pairs], params, opt,
                           torch.tensor(0.5), cfg, False, cluster.make_cluster_sampler(**kw))
    _, _, want = jax_loop._epoch_pass(
        [(js.idx, js) for js, _ in pairs], jparams, jstate, jnp.float32(0.5), jcfg, False,
        jax_cluster.make_cluster_sampler(**kw))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


def _record_steps(monkeypatch, module, losses):
    step = module.train_step

    def train_step(*args, **kw):
        out = step(*args, **kw)
        losses.append(float(out[-2]))
        return out

    monkeypatch.setattr(module, "train_step", train_step)


def test_train_cluster_regime_matches_jax(genome_root, tmp_path, monkeypatch):
    """train() on the 60 kb genome under a ClusterGCN config (with cluster
    validation) in both packages, from the same initial weights (the
    packages draw them from different generators), then a resume.

    The first piece step's loss is held to 1e-5. Every later step, and the
    epoch histories, to rtol = GENOME_RTOL: this graph is nearly a chain,
    its PageRank features nearly constant, and the first node BatchNorm
    divides by a variance that is f32 rounding noise, so the packages'
    gradients differ by up to 1.7e-2 per leaf here (tests/test_torch_train.py
    ``DEEP_GRAD_TOL``) and Adam turns that into different steps (measured:
    the first step's loss 7e-8 apart, later steps and the histories up to
    3e-4 relative). test_cluster_epoch_matches_jax holds a minibatch epoch
    to 1e-5 on a well-conditioned graph."""
    jcfg, cfg = _configs(num_epochs=2, num_parts_train=16, batch_size_train=4,
                         cluster_jitter=4, cluster_validation=True, num_parts_eval=8,
                         batch_size_eval=3)
    cfg.model.nb_pos_enc = jcfg.model.nb_pos_enc = 16  # the dataset's PE
    start = _flatten(jax_init(jax.random.PRNGKey(cfg.train.seed), jcfg.model))
    monkeypatch.setattr(loop, "init_model_params",
                        lambda gen, model_cfg, device: params_from_jax(start, device=device))
    runs, steps = {}, {"jax": [], "port": []}
    for name, c, module, kw in (("jax", jcfg, jax_loop, {}),
                                ("port", cfg, loop, {"device": "cpu"})):
        _record_steps(monkeypatch, module, steps[name])
        c.train.checkpoint_dir = str(tmp_path / name / "ckpt")
        c.train.pretrained_dir = str(tmp_path / name / "pre")
        runs[name] = module.train(genome_root, None, out="cl", overfit=True, cfg=c,
                                  log_fn=lambda m: None, **kw)
    assert len(steps["port"]) == len(steps["jax"]) > 4
    np.testing.assert_allclose(steps["port"][0], steps["jax"][0], **TOL)
    np.testing.assert_allclose(steps["port"], steps["jax"], rtol=GENOME_RTOL)
    for key in ("loss_train", "loss_valid"):
        assert len(runs["port"][key]) == 2
        np.testing.assert_allclose(runs["port"][key], runs["jax"][key], rtol=GENOME_RTOL,
                                   err_msg=key)
    assert runs["port"]["pos_to_neg_ratio"] == pytest.approx(runs["jax"]["pos_to_neg_ratio"])

    logs = []
    cfg.train.num_epochs = 3
    again = loop.train(genome_root, None, out="cl", overfit=True, cfg=cfg,
                       log_fn=logs.append, device="cpu")
    assert any(m.startswith("Resumed from") and m.endswith("at epoch 2") for m in logs)
    assert again["loss_train"][:2] == runs["port"]["loss_train"]
    assert len(again["loss_train"]) == 3 and np.isfinite(again["loss_train"]).all()


# ---------------------------------------------------------------------------
# (f) the native bridge
# ---------------------------------------------------------------------------

@pytest.fixture
def bridges(monkeypatch):
    """Both packages' bridges, their library caches cleared before and
    after (the environment is restored by monkeypatch)."""
    monkeypatch.delenv("GNNOME_FORCE_PYTHON", raising=False)
    for m in (native_bridge, jax_native):
        m._load.cache_clear()
    yield monkeypatch
    monkeypatch.undo()
    for m in (native_bridge, jax_native):
        m._load.cache_clear()


def test_native_bridge_without_library(bridges, tmp_path):
    bridges.setenv("GNNOME_NATIVE_LIB", str(tmp_path / "missing.so"))
    src, dst, n = chain_pairs(np.random.default_rng(0), 20, 10)
    for m in (native_bridge, jax_native):
        assert not m.available()
        assert m.partition_graph(src, dst, n, 4) is None
    with pytest.raises(RuntimeError, match="make -C native"):
        native_bridge.simulate_reads("g.fa", "r.fa", 10.0, "", 0)
    # the callers fall back to the Python paths
    np.testing.assert_array_equal(partition.partition_nodes(src, dst, n, 4),
                                  jax_partition.partition_nodes(src, dst, n, 4))


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """The library built from ``native/`` into a temporary directory
    (about 5 s); skips where there is no C++ toolchain."""
    if not (shutil.which("g++") and shutil.which("make")):
        pytest.skip("no g++ / make: the native library cannot be built here")
    build = tmp_path_factory.mktemp("native_build")
    subprocess.run(["make", "-s", "-C", os.path.join(ROOT, "native"), f"BUILD={build}",
                    "CXX=g++"],
                   check=True, capture_output=True, timeout=600)
    return str(build / "libgnnome_native.so")


def test_native_bridge_matches_jax(bridges, native_lib, tmp_path):
    """Through the library both packages load: the same partitions, the
    same simulated reads and the same overlap graph, by the bridge's
    entries and by the callers that prefer them."""
    bridges.setenv("GNNOME_NATIVE_LIB", native_lib)
    assert native_bridge.available() and jax_native.available()
    rng = np.random.default_rng(8)
    for src, dst, n in (chain_pairs(rng, 400, 900), _random_pairs(rng)):
        got = native_bridge.partition_graph(src, dst, n, 8)
        np.testing.assert_array_equal(got, jax_native.partition_graph(src, dst, n, 8))
        assert got.dtype == np.int32 and got.shape == (n,) and got.max() == 7
        np.testing.assert_array_equal(partition.partition_nodes(src, dst, n, 8),
                                      jax_partition.partition_nodes(src, dst, n, 8))
    with pytest.raises(ValueError):
        native_bridge.partition_graph(np.array([0, 5], np.int32), np.array([1, 2], np.int32),
                                      4, 2)

    genome = rng.choice(list("ACGT"), size=80_000)
    genome[50_000:54_000] = genome[2_000:6_000]
    simulate.write_fasta(str(tmp_path / "genome.fa"), [("chrT", "".join(genome))])
    outs = {}
    for name, sim, build in (("port", simulate, builder), ("jax", jax_simulate, jax_builder)):
        reads, csv = str(tmp_path / f"{name}.fa"), str(tmp_path / f"{name}_graph_1.csv")
        n_reads = sim.simulate_to_file(str(tmp_path / "genome.fa"), reads, coverage=10.0,
                                       mean_length=3000, std_length=500, seed=3)
        build.build_overlap_graph(reads, csv, threads=2)
        outs[name] = (n_reads, reads, csv)
    assert outs["port"][0] == outs["jax"][0] > 30
    assert filecmp.cmp(outs["port"][1], outs["jax"][1], shallow=False)
    assert filecmp.cmp(outs["port"][2], outs["jax"][2], shallow=False)
    assert os.path.getsize(outs["port"][2]) > 0
    # the bridge's own entries, called directly
    n = native_bridge.simulate_reads(str(tmp_path / "genome.fa"), str(tmp_path / "d.fa"),
                                     10.0, "", 3)
    assert n == jax_native.simulate_reads(str(tmp_path / "genome.fa"),
                                          str(tmp_path / "e.fa"), 10.0, "", 3)
    assert filecmp.cmp(tmp_path / "d.fa", tmp_path / "e.fa", shallow=False)
    native_bridge.build_overlap_graph(str(tmp_path / "d.fa"), str(tmp_path / "d.csv"),
                                      2, 0.0, 15, 5, 500)
    jax_native.build_overlap_graph(str(tmp_path / "d.fa"), str(tmp_path / "e.csv"),
                                   2, 0.0, 15, 5, 500)
    assert filecmp.cmp(tmp_path / "d.csv", tmp_path / "e.csv", shallow=False)
    # GNNOME_FORCE_PYTHON keeps the callers on the Python paths
    bridges.setenv("GNNOME_FORCE_PYTHON", "1")
    assert not native_bridge.available() and not jax_native.available()
