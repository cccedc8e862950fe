"""The port's pipeline entry points on the CPU, held against the JAX
package: the stages' directory trees, pickles and caches must be the JAX
package's, byte for byte where they are files (the two packages read each
other's runs), and the offline example must run end to end.

The graph builder and the simulator take their Python paths here (no
native library is built by these tests; ``tests/test_torch_cluster.py``
holds the native paths of both packages to each other).
"""
import dataclasses
import filecmp
import os
import pickle
import random

import numpy as np
import pytest
import torch

from gnnome_tpu import pipeline as jax_pipeline
from gnnome_tpu import reproduce as jax_reproduce
from gnnome_tpu.config import Config as JaxConfig
from gnnome_tpu.data import dataset as jax_dataset
from gnnome_tpu_torch import example, generate, pipeline, reproduce
from gnnome_tpu_torch.config import Config
from gnnome_tpu_torch.data import dataset
from gnnome_tpu_torch.data.simulate import simulate_reads, write_fasta
from gnnome_tpu_torch.utils.seed import set_seed


def tree(root):
    """Relative paths of every directory and file under ``root``."""
    out = set()
    for d, dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        out.update(os.path.join(rel, x) for x in dirs + files)
    return out


def same_files(a, b):
    assert tree(a) == tree(b)
    for rel in tree(a):
        if os.path.isfile(os.path.join(a, rel)):
            assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel


@pytest.mark.parametrize("dicts", [
    ({"chr19": 3}, {"chr19": 1, "chr21": 2}, {"chr21": 1}),
    ({}, {"chr1_r": 1}, {}),
])
def test_merge_dicts_matches_jax(dicts):
    assert pipeline.merge_dicts(*dicts) == jax_pipeline.merge_dicts(*dicts)


def test_file_structure_setup_matches_jax(tmp_path):
    for name, m in (("port", pipeline), ("jax", jax_pipeline)):
        for _ in range(2):  # idempotent
            m.file_structure_setup(str(tmp_path / name / "data"), str(tmp_path / name / "refs"))
    same_files(tmp_path / "port", tmp_path / "jax")
    assert os.path.isdir(tmp_path / "port" / "data" / "real" / "chrX" / "builder_output")


def _fake_processed(data):
    sim = os.path.join(data, "simulated", "chr19")
    for sub in ("processed", "info"):
        os.makedirs(os.path.join(sim, sub))
    for i in range(4):
        with open(os.path.join(sim, "processed", f"{i}.npz"), "w") as f:
            f.write(f"graph {i}")
        for kind in ("succ", "pred", "edges", "reads"):
            with open(os.path.join(sim, "info", f"{i}_{kind}.pkl"), "wb") as f:
                pickle.dump({kind: i}, f)
    real = os.path.join(data, "real", "chr21")
    for sub in ("processed", "info"):
        os.makedirs(os.path.join(real, sub))
    with open(os.path.join(real, "processed", "0.npz"), "w") as f:
        f.write("real graph")
    for kind in ("succ", "pred", "edges", "reads"):
        with open(os.path.join(real, "info", f"0_{kind}.pkl"), "wb") as f:
            pickle.dump({kind: "real"}, f)
    os.makedirs(os.path.join(data, "experiments"))


def test_train_valid_split_matches_jax(tmp_path):
    paths = {}
    for name, m in (("port", pipeline), ("jax", jax_pipeline)):
        data = str(tmp_path / name)
        _fake_processed(data)
        paths[name] = m.train_valid_split(data, {"chr19": 2}, {"chr19": 1},
                                          {"chr19": 1, "chr21_r": 2}, out="t",
                                          log_fn=lambda msg: None)
    assert [os.path.relpath(p, tmp_path / "port") for p in paths["port"]] == \
        [os.path.relpath(p, tmp_path / "jax") for p in paths["jax"]]
    same_files(tmp_path / "port", tmp_path / "jax")
    with open(os.path.join(paths["port"][2], "info", "g_to_chr.pkl"), "rb") as f:
        assert pickle.load(f) == {0: "chr19", 1: "chr21"}


def _genome(rng, size, repeat=3000):
    genome = rng.choice(list("ACGT"), size=size)
    genome[size // 2 : size // 2 + repeat] = genome[1000 : 1000 + repeat]
    return "".join(genome)


def test_simulate_stage_matches_jax(tmp_path):
    cfg, jcfg = Config(), JaxConfig()
    cfg.data.coverage = jcfg.data.coverage = 4.0
    genome = _genome(np.random.default_rng(1), 12_000)
    for name, m, c in (("port", pipeline, cfg), ("jax", jax_pipeline, jcfg)):
        data, refs = str(tmp_path / name / "data"), str(tmp_path / name / "refs")
        m.file_structure_setup(data, refs)
        write_fasta(os.path.join(refs, "chromosomes", "chr21.fasta"), [("chr21", genome)])
        m.simulate_reads(data, refs, {"chr21": 2, "chr19_r": 1}, c, log_fn=lambda msg: None)
    same_files(tmp_path / "port", tmp_path / "jax")
    assert sorted(os.listdir(tmp_path / "port" / "data" / "simulated" / "chr21" / "raw")) \
        == ["0.fasta", "1.fasta"]


@pytest.fixture(scope="module")
def raw_reads(tmp_path_factory):
    """Reads of a 20 kb genome with a planted repeat, in a raw/ directory."""
    root = tmp_path_factory.mktemp("raw_reads")
    records = simulate_reads(_genome(np.random.default_rng(2), 20_000), coverage=10.0,
                             lengths=np.full(100, 2000, dtype=np.int64), seed=3)
    os.makedirs(root / "raw")
    write_fasta(str(root / "raw" / "0.fasta"), records)
    return root


def test_generate_matches_jax(raw_reads, tmp_path):
    """``AssemblyGraphDataset(generate=True)`` and ``generate.main`` write the
    JAX package's processed graph and info pickles, and load nothing."""
    roots = {}
    for name in ("jax", "port_dataset", "port_main"):
        roots[name] = tmp_path / name
        os.makedirs(roots[name] / "raw")
        os.link(raw_reads / "raw" / "0.fasta", roots[name] / "raw" / "0.fasta")
    jds = jax_dataset.AssemblyGraphDataset(str(roots["jax"]), nb_pos_enc=None,
                                           generate=True, specs={"threads": 2})
    ds = dataset.AssemblyGraphDataset(str(roots["port_dataset"]), nb_pos_enc=None,
                                      generate=True, specs={"threads": 2})
    generate.main(["--data", str(roots["port_main"]), "--threads", "2"])
    assert ds.graph_list == jds.graph_list == [] and len(ds) == len(jds) == 1
    for name in ("port_dataset", "port_main"):
        z, jz = (np.load(r / "processed" / "0.npz") for r in (roots[name], roots["jax"]))
        assert set(z.files) == set(jz.files)
        for k in jz.files:
            np.testing.assert_array_equal(z[k], jz[k], err_msg=k)
        for kind in ("succ", "pred", "edges", "reads"):
            rel = os.path.join("info", f"0_{kind}.pkl")
            assert filecmp.cmp(roots[name] / rel, roots["jax"] / rel, shallow=False), rel
    assert float(np.load(roots["jax"] / "processed" / "0.npz")["y"].min()) == 0.0

    # the decode-time helpers over that cache
    info = dataset.load_graph_data(1, str(roots["port_main"]), use_reads=True)
    assert info == jax_dataset.load_graph_data(1, str(roots["jax"]), use_reads=True)
    lines, jlines = [], []
    (idx, s), = dataset.AssemblyGraphDataset(str(roots["port_main"]), nb_pos_enc=8,
                                             device="cpu")
    (jidx, js), = jax_dataset.AssemblyGraphDataset(str(roots["jax"]), nb_pos_enc=8)
    dataset.print_graph_info(idx, s, log_fn=lines.append)
    jax_dataset.print_graph_info(jidx, js, log_fn=jlines.append)
    assert lines == jlines and len(lines) == 4


def test_set_seed_seeds_every_generator():
    draws = []
    for _ in range(2):
        set_seed(5)
        draws.append((random.random(), np.random.rand(), float(torch.rand(()))))
    assert draws[0] == draws[1]


@pytest.mark.parametrize("mode", ["synthetic", "real"])
def test_reproduce_drives_the_pipeline_as_jax_does(mode, tmp_path, monkeypatch):
    """The reproduction entries call the same stages with the same splits
    and paths as the JAX package's (the stages recorded, not run)."""
    calls = {}
    for name, m in (("port", pipeline), ("jax", jax_pipeline)):
        calls[name] = []
        for stage in ("run_pipeline", "file_structure_setup", "generate_graphs",
                      "train_valid_split", "predict"):
            def record(*args, _stage=stage, _calls=calls[name], **kw):
                cfg = kw.pop("cfg", None) or next(
                    (a for a in args if dataclasses.is_dataclass(a)), None)
                _calls.append((_stage, [a for a in args if not dataclasses.is_dataclass(a)],
                               {k: v for k, v in kw.items() if k != "device"},
                               None if cfg is None else (cfg.split.train, cfg.split.valid,
                                                         cfg.split.test)))
                return ("train", "valid", "test")
            monkeypatch.setattr(m, stage, record)
    data, refs = str(tmp_path / "data"), str(tmp_path / "refs")
    if mode == "synthetic":
        reproduce.untangle_synthetic(data, refs, device="cpu")
        jax_reproduce.untangle_synthetic(data, refs)
    else:
        reproduce.untangle_real(data, refs, device="cpu")
        jax_reproduce.untangle_real(data, refs)
    assert calls["port"] == calls["jax"] and calls["port"]


def test_pipeline_main_passes_the_device(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(pipeline, "run_pipeline",
                        lambda *args, **kw: seen.update(args=args, **kw))
    cfg_path = str(tmp_path / "cfg.json")
    Config().to_json(cfg_path)
    pipeline.main(["--data", "d", "--refs", "r", "--out", "o", "--config", cfg_path,
                   "--device", "cpu"])
    assert seen["device"] == "cpu" and seen["args"][:4] == ("d", "r", "o", False)
    assert seen["args"][4] == Config()


def test_synthetic_example_writes_an_assembly(tmp_path):
    """The offline example end to end on the CPU (one epoch instead of 15):
    simulate, build, split, train, assemble; then the baseline decoders."""
    root = str(tmp_path / "example")
    cfg = example.synthetic_config(root)
    assert (cfg.model.num_gnn_layers, cfg.model.hidden_features, cfg.train.num_epochs) == \
        (8, 128, 15)
    cfg.train.num_epochs = 1
    results = example.synthetic_example(root, cfg=cfg, device="cpu")
    test_path = os.path.join(root, "data", "experiments", "test_example")
    fasta = os.path.join(test_path, "assembly", "0_assembly.fasta")
    assert len(results) == 1 and results[0][0] >= 1  # contigs
    with open(fasta) as f:
        assert f.read().count(">") == results[0][0]
    assert os.path.exists(os.path.join(root, "pretrained", "model_example.npz"))
    base = pipeline.predict_baselines(test_path, "example", cfg=cfg, log_fn=lambda m: None,
                                      device="cpu")
    assert set(base) == {(0, ""), (0, "_ol_len"), (0, "_ol_sim")}
    assert all(r["coord"] is not None for r in base.values())
