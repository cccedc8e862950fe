"""``inference()`` of the port against the JAX package, from reads to contigs.

The genome is the one the repository's end-to-end drive uses: 60 kb with
a planted 4 kb repeat, 200 read lengths of 2.2 kb at coverage 14.
The port simulates the reads and builds the overlap graph (its Python
builder); the JAX package then reads the same processed cache, so both
score the same graph with the same tiny model (one JAX parameter set saved
as ``.npz``). Edge probabilities must agree to 1e-4 (f32 sums in another
order, through the layers; see tests/test_torch_model.py) and the decoded
walks and contigs must be identical.

The host-only modules the port copies (simulator, builder, parser,
oracle, greedy decoders) are held to the JAX package's outputs as well.
"""
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from gnnome_tpu.config import Config as JaxConfig
from gnnome_tpu.core.graph import extract_edge_values as jax_extract
from gnnome_tpu.data import builder as jax_builder
from gnnome_tpu.data import simulate as jax_simulate
from gnnome_tpu.data.dataset import AssemblyGraphDataset as JaxDataset
from gnnome_tpu.decode import greedy as jax_greedy
from gnnome_tpu.decode.inference import inference as jax_inference
from gnnome_tpu.decode.inference import load_model as jax_load_model
from gnnome_tpu.decode.inference import score_graph as jax_score_graph
from gnnome_tpu.models.model import init_model_params as jax_init
from gnnome_tpu.train.checkpoint import save_params as jax_save_params
from gnnome_tpu_torch.config import Config
from gnnome_tpu_torch.core.graph import extract_edge_values
from gnnome_tpu_torch.data import builder
from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset
from gnnome_tpu_torch.data.simulate import simulate_reads, write_fasta
from gnnome_tpu_torch.decode import greedy
from gnnome_tpu_torch.decode.inference import inference, load_model, score_graph

MODEL = dict(num_gnn_layers=3, hidden_features=32, nb_pos_enc=8)


def _genome(size=60_000, repeat=(30_000, 5_000, 4_000)):
    rng = np.random.default_rng(0)
    genome = rng.choice(list("ACGT"), size=size)
    at, src, length = repeat
    genome[at: at + length] = genome[src: src + length]  # planted repeat
    return "".join(genome)


def _configs():
    cfg, jcfg = Config(), JaxConfig()
    for c in (cfg.model, jcfg.model):
        for k, v in MODEL.items():
            setattr(c, k, v)
    return cfg, jcfg


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """Port inference on the drive genome, then JAX inference on its cache."""
    root = tmp_path_factory.mktemp("drive")
    genome = _genome()
    records = simulate_reads(genome, coverage=14.0,
                             lengths=np.full(200, 2200, dtype=np.int64), seed=1)
    os.makedirs(root / "raw")
    write_fasta(str(root / "raw" / "0.fasta"), records)
    cfg, jcfg = _configs()
    model_path = str(root / "tiny.npz")
    jax_save_params(model_path, jax_init(jax.random.PRNGKey(0), jcfg.model))

    logs = []
    walks, contigs = inference(str(root), model_path, cfg, log_fn=logs.append,
                               ref_lengths={0: len(genome)}, device="cpu")
    with open(root / "inference" / "0_walks.pkl", "rb") as f:
        saved_walks = pickle.load(f)
    with open(root / "assembly" / "0_assembly.fasta") as f:
        fasta = f.read()
    jwalks, jcontigs = jax_inference(str(root), model_path, jcfg, log_fn=logs.append,
                                     ref_lengths={0: len(genome)})
    return dict(root=root, cfg=cfg, jcfg=jcfg, model_path=model_path, walks=walks,
                contigs=contigs, jwalks=jwalks, jcontigs=jcontigs, logs=logs,
                saved_walks=saved_walks, fasta=fasta, records=records)


def test_inference_walks_and_contigs_match_jax(drive):
    assert drive["walks"] == drive["jwalks"]
    assert drive["contigs"] == drive["jcontigs"]
    assert len(drive["walks"][0]) >= 1 and all(len(w) >= 20 for w in drive["walks"][0])
    # the artifacts of the reference layout were written by the port's run
    assert drive["saved_walks"] == drive["walks"][0]
    assert drive["fasta"].startswith(">")


def test_edge_probabilities_match_jax(drive):
    root, cfg, jcfg = str(drive["root"]), drive["cfg"], drive["jcfg"]
    (_, sample), = AssemblyGraphDataset(root, cfg.model.nb_pos_enc, device="cpu")
    (_, jsample), = JaxDataset(root, nb_pos_enc=jcfg.model.nb_pos_enc)
    g, jg = sample.graph, jsample.graph
    assert (g.n_nodes, g.n_edges) == (jg.n_nodes, jg.n_edges)
    labels = sample.y.numpy()
    assert 0 < labels.sum() < len(labels), "degenerate fixture: the repeat gives negatives"
    np.testing.assert_array_equal(extract_edge_values(g, sample.e_feat),
                                  jax_extract(jg, jsample.e_feat))
    np.testing.assert_array_equal(extract_edge_values(g, labels),
                                  jax_extract(jg, jsample.y))
    np.testing.assert_array_equal(sample.pe.numpy(), np.asarray(jsample.pe)[: g.n_nodes])

    logits = score_graph(load_model(drive["model_path"], cfg, "cpu"), g,
                         sample.e_feat, sample.pe)
    jlogits = jax_score_graph(jax_load_model(drive["model_path"], jcfg), jg,
                              jsample.e_feat, jsample.pe)
    prob = torch.sigmoid(torch.from_numpy(extract_edge_values(g, logits))).numpy()
    jprob = 1.0 / (1.0 + np.exp(-jax_extract(jg, jlogits)))
    np.testing.assert_allclose(prob, jprob, rtol=1e-4, atol=1e-4)


def test_copied_host_modules_match_jax(drive, tmp_path, monkeypatch):
    """Simulator, builder (Python path) and greedy decoders give the JAX
    package's results."""
    monkeypatch.setenv("GNNOME_FORCE_PYTHON", "1")  # the JAX builder's Python path
    genome = _genome(20_000, (10_000, 2_000, 2_000))
    lengths = np.full(60, 2000, dtype=np.int64)
    recs = simulate_reads(genome, 12.0, lengths, seed=3)
    assert recs == jax_simulate.simulate_reads(genome, 12.0, lengths, seed=3)
    write_fasta(str(tmp_path / "r.fasta"), recs)
    builder.build_overlap_graph(str(tmp_path / "r.fasta"), str(tmp_path / "a.csv"))
    jax_builder.build_overlap_graph(str(tmp_path / "r.fasta"), str(tmp_path / "b.csv"))
    for suffix in ("csv", "gfa"):
        assert (tmp_path / f"a.{suffix}").read_text() == \
            (tmp_path / f"b.{suffix}").read_text()

    # the greedy decoders on the drive graph, with random scores
    root = drive["root"]
    rng = np.random.default_rng(5)
    (_, s), = AssemblyGraphDataset(str(root), drive["cfg"].model.nb_pos_enc, device="cpu")
    scores = rng.standard_normal(len(s.src))
    info = []
    for kind in ("succ", "pred", "edges"):
        with open(root / "info" / f"0_{kind}.pkl", "rb") as f:
            info.append(pickle.load(f))
    args = (s.src, s.dst, scores, *info, s.prefix_length, s.read_length)
    for min_prob in (0.0, 0.3):
        walks = greedy.get_contigs(*args, nb_paths=10, len_threshold=5, min_prob=min_prob)
        assert walks
        for engine in ("batched", "sequential"):  # the JAX package's host engines
            assert walks == jax_greedy.get_contigs(
                *args, nb_paths=10, len_threshold=5, min_prob=min_prob,
                engine=engine), (min_prob, engine)
