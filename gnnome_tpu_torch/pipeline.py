"""End-to-end pipeline orchestration (counterpart of ``gnnome_tpu/pipeline.py``).

Reference: ``pipeline.py`` (403 LoC): directory setup, CHM13 download,
read simulation, graph generation, train/valid/test split, training,
prediction + evaluation. Stages are idempotent-by-counting (each compares
what exists on disk with what is needed and only does the delta,
``pipeline.py:149-170,191-193``), so a crashed run resumes by re-running.

Differences from the reference by design:
  * simulation and graph construction use the in-repo native tools
    (``native/``) or their Python specs — no ``git clone`` + build of
    vendored third-party repos at runtime (``pipeline.py:140-143,177-181``);
  * configuration is a :class:`gnnome_tpu_torch.config.Config` instead of
    edit-the-source dicts;
  * the stages that touch tensors (training, prediction) take ``device``,
    ``"cuda"`` unless the caller says otherwise; the files every stage
    writes are the JAX package's, so either package resumes the other's run.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import pickle
import shutil
import urllib.request
from typing import Dict, Optional

from gnnome_tpu_torch.config import Config

CHM13_URL = (
    "https://s3-us-west-2.amazonaws.com/human-pangenomics/T2T/CHM13/assemblies/"
    "chm13.draft_v1.1.fasta.gz"
)  # pipeline.py:104


def merge_dicts(*dicts: Dict[str, int]) -> Dict[str, int]:
    keys = {k for d in dicts for k in d}
    return {k: sum(d.get(k, 0) for d in dicts) for k in keys}


def create_chr_dirs(path: str) -> None:
    for i in list(range(1, 23)) + ["X"]:
        for sub in ("raw", "processed", "info", "builder_output"):
            os.makedirs(os.path.join(path, f"chr{i}", sub), exist_ok=True)


def file_structure_setup(data_path: str, ref_path: str) -> None:
    """Create the data tree (``pipeline.py:79-97``)."""
    os.makedirs(data_path, exist_ok=True)
    os.makedirs(os.path.join(ref_path, "CHM13"), exist_ok=True)
    os.makedirs(os.path.join(ref_path, "chromosomes"), exist_ok=True)
    for sub in ("simulated", "real"):
        p = os.path.join(data_path, sub)
        if not os.path.isdir(p):
            os.makedirs(p)
            create_chr_dirs(p)
    os.makedirs(os.path.join(data_path, "experiments"), exist_ok=True)


def download_reference(ref_path: str, log_fn=print) -> None:
    """Fetch CHM13 v1.1 and split per chromosome (``pipeline.py:101-129``)."""
    chm_path = os.path.join(ref_path, "CHM13")
    chr_path = os.path.join(ref_path, "chromosomes")
    chm13_gz = os.path.join(chm_path, "chm13.draft_v1.1.fasta.gz")

    if not os.listdir(chm_path):
        log_fn(f"SETUP::download:: CHM13 not found, downloading {CHM13_URL}")
        urllib.request.urlretrieve(CHM13_URL, chm13_gz)

    if not os.listdir(chr_path):
        log_fn("SETUP::download:: splitting CHM13 per chromosome")
        current_file = None
        with gzip.open(chm13_gz, "rt") as f:
            for line in f:
                if line.startswith(">"):
                    if current_file:
                        current_file.close()
                    name = line[1:].split()[0]
                    current_file = open(
                        os.path.join(chr_path, f"{name}.fasta"), "w"
                    )
                current_file.write(line)
        if current_file:
            current_file.close()


def simulate_reads(
    data_path: str, ref_path: str, chr_dict: Dict[str, int],
    cfg: Optional[Config] = None, log_fn=print,
) -> None:
    """Simulate per-chromosome read sets to the needed counts
    (``pipeline.py:133-170``)."""
    from gnnome_tpu_torch.data.simulate import resolve_distribution, simulate_to_file

    cfg = cfg or Config()
    chr_path = os.path.join(ref_path, "chromosomes")
    len_path = os.path.join(ref_path, "lengths")
    sim_path = os.path.join(data_path, "simulated")
    for chr_n, n_need in chr_dict.items():
        if "_r" in chr_n:
            continue  # real data is downloaded, not simulated
        chr_raw_path = os.path.join(sim_path, chr_n, "raw")
        os.makedirs(chr_raw_path, exist_ok=True)
        n_have = len(os.listdir(chr_raw_path))
        for i in range(max(n_need - n_have, 0)):
            idx = n_have + i
            out = os.path.join(chr_raw_path, f"{idx}.fasta")
            log_fn(f"SETUP::simulate:: {chr_n} dataset {idx} -> {out}")
            simulate_to_file(
                os.path.join(chr_path, f"{chr_n}.fasta"),
                out,
                coverage=cfg.data.coverage,
                distribution_path=resolve_distribution(chr_n, len_path),
                seed=idx,
            )


def generate_graphs(
    data_path: str, chr_dict: Dict[str, int], cfg: Optional[Config] = None,
    real: bool = False, log_fn=print,
) -> None:
    """Build + process assembly graphs for every raw read set
    (``pipeline.py:174-227``)."""
    from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset

    cfg = cfg or Config()
    sub = "real" if real else "simulated"
    for chr_n in chr_dict:
        if ("_r" in chr_n) != real:
            continue
        name = chr_n[:-2] if chr_n.endswith("_r") else chr_n
        chr_root = os.path.join(data_path, sub, name)
        log_fn(f"SETUP::generate:: graphs for {chr_root}")
        AssemblyGraphDataset(
            chr_root,
            nb_pos_enc=None,
            specs={"threads": cfg.data.threads, "filter": cfg.data.identity_filter},
            generate=True,
        )


def _copy_graph(src_root: str, i: int, dst_root: str, n_have: int) -> None:
    shutil.copy(
        os.path.join(src_root, "processed", f"{i}.npz"),
        os.path.join(dst_root, "processed", f"{n_have}.npz"),
    )
    for kind in ("succ", "pred", "edges", "reads"):
        shutil.copy(
            os.path.join(src_root, "info", f"{i}_{kind}.pkl"),
            os.path.join(dst_root, "info", f"{n_have}_{kind}.pkl"),
        )


def train_valid_split(
    data_path: str,
    train_dict: Dict[str, int],
    valid_dict: Dict[str, int],
    test_dict: Optional[Dict[str, int]] = None,
    out: Optional[str] = None,
    log_fn=print,
):
    """Copy processed graphs into experiment train/valid/test dirs
    (``pipeline.py:231-327``)."""
    test_dict = test_dict or {}
    exp_path = os.path.join(data_path, "experiments")
    suffix = f"_{out}" if out else ""
    paths = {
        "train": os.path.join(exp_path, f"train{suffix}"),
        "valid": os.path.join(exp_path, f"valid{suffix}"),
        "test": os.path.join(exp_path, f"test{suffix}"),
    }
    splits = {"train": train_dict, "valid": valid_dict, "test": test_dict}

    for split, chr_dict in splits.items():
        if split == "test" and not chr_dict:
            continue
        root = paths[split]
        for sub in ("raw", "processed", "info"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        g_to_chr: Dict[int, str] = {}
        g_to_org_g: Dict[int, int] = {}
        n_have = 0
        for chr_n, n_need in chr_dict.items():
            real = chr_n.endswith("_r")
            name = chr_n[:-2] if real else chr_n
            if real and n_need > 1:
                log_fn(f"SETUP::split:: warning: only 1 real graph for {chr_n}")
                n_need = 1
            src_root = os.path.join(data_path, "real" if real else "simulated", name)
            for i in range(n_need):
                # graphs are consumed in order: train gets 0..t-1, valid the
                # next v, test after that (pipeline.py:284,314)
                if real:
                    k = 0
                elif split == "train":
                    k = i
                elif split == "valid":
                    k = i + train_dict.get(chr_n, 0)
                else:
                    k = i + train_dict.get(chr_n, 0) + valid_dict.get(chr_n, 0)
                log_fn(f"SETUP::split:: {src_root}[{k}] -> {root}[{n_have}]")
                _copy_graph(src_root, k, root, n_have)
                g_to_chr[n_have] = name
                g_to_org_g[n_have] = k
                n_have += 1
        with open(os.path.join(root, "info", "g_to_chr.pkl"), "wb") as f:
            pickle.dump(g_to_chr, f)
        with open(os.path.join(root, "info", "g_to_org_g.pkl"), "wb") as f:
            pickle.dump(g_to_org_g, f)

    return paths["train"], paths["valid"], paths["test"]


def train_model(train_path, valid_path, out, overfit=False, cfg=None, device="cuda"):
    """Stage 3 (``pipeline.py:331-333``)."""
    from gnnome_tpu_torch.train.loop import train

    return train(train_path, valid_path, out, overfit, cfg, device=device)


def predict(
    test_path: str, out: str, model_path: Optional[str] = None,
    cfg: Optional[Config] = None, baselines: bool = False, log_fn=print,
    device="cuda",
):
    """Stage 4: inference + quick evaluation (``pipeline.py:337-368``)."""
    from gnnome_tpu_torch.decode.inference import inference
    from gnnome_tpu_torch.evaluation import assembly as asm

    cfg = cfg or Config()
    if model_path is None:
        model_path = os.path.join(cfg.train.pretrained_dir, f"model_{out}.npz")
    with open(os.path.join(test_path, "info", "g_to_chr.pkl"), "rb") as f:
        g_to_chr = pickle.load(f)
    ref_lengths = {idx: asm.CHR_LENS.get(chr_n, 0)
                   for idx, chr_n in g_to_chr.items()}
    walks, contigs_per_graph = inference(
        test_path, model_path, cfg, baselines=baselines, log_fn=log_fn,
        ref_lengths=ref_lengths, device=device,
    )
    results = []
    for idx, contigs in enumerate(contigs_per_graph):
        chr_n = g_to_chr[idx]
        stats = asm.quick_evaluation(contigs, chr_n)
        asm.print_summary(test_path, idx, chr_n, *stats, log_fn=log_fn)
        results.append(stats)
    return results


def predict_baselines(
    test_path: str, out: str, model_path: Optional[str] = None,
    cfg: Optional[Config] = None, log_fn=print, device="cuda",
):
    """Stage 4 with non-learned controls: additionally decodes by raw
    overlap_length / overlap_similarity and reports all three
    (``pipeline.py:349-368``; note the reference's version crashes on a
    typo, ``pipeline.py:352`` — fixed here)."""
    from gnnome_tpu_torch.data.builder import parse_fasta
    from gnnome_tpu_torch.decode.inference import inference
    from gnnome_tpu_torch.evaluation import assembly as asm

    cfg = cfg or Config()
    if model_path is None:
        model_path = os.path.join(cfg.train.pretrained_dir, f"model_{out}.npz")
    with open(os.path.join(test_path, "info", "g_to_chr.pkl"), "rb") as f:
        g_to_chr = pickle.load(f)
    ref_lengths = {idx: asm.CHR_LENS.get(chr_n, 0)
                   for idx, chr_n in g_to_chr.items()}
    inference(test_path, model_path, cfg, baselines=True, log_fn=log_fn,
              ref_lengths=ref_lengths, device=device)
    results = {}
    for idx, chr_n in g_to_chr.items():
        for label, suffix in (("GNN scores", ""),
                              ("Baseline: overlap length", "_ol_len"),
                              ("Baseline: overlap similarity", "_ol_sim")):
            fasta = os.path.join(test_path, "assembly", f"{idx}_assembly{suffix}.fasta")
            contigs = parse_fasta(fasta) if os.path.exists(fasta) else []
            log_fn(f"{label}:")
            stats = asm.quick_evaluation(contigs, chr_n)
            asm.print_summary(test_path, f"{idx}{suffix}", chr_n, *stats, log_fn=log_fn)
            coord_path = os.path.join(
                test_path, "inference", f"{idx}_coord{suffix}.json")
            coord = None
            if os.path.exists(coord_path):
                with open(coord_path) as f:
                    coord = json.load(f)
                log_fn(
                    f"Coordinate (Quast-role) metrics: "
                    f"misassemblies={coord['n_misassemblies']} "
                    f"genome_fraction={coord['genome_fraction']:.4f} "
                    f"NGA50={coord['nga50']:,}"
                )
            results[(idx, suffix)] = {"quick": stats, "coord": coord}
    return results


def run_pipeline(
    data_path: str = "data",
    ref_path: str = "data/references",
    out: Optional[str] = None,
    overfit: bool = False,
    cfg: Optional[Config] = None,
    device="cuda",
) -> None:
    """Full pipeline (``pipeline.py:371-402``)."""
    cfg = cfg or Config()
    out = out or "run"
    train_dict = cfg.split.train
    valid_dict = cfg.split.valid
    test_dict = cfg.split.test
    all_chr = merge_dicts(train_dict, valid_dict, test_dict)

    file_structure_setup(data_path, ref_path)
    download_reference(ref_path)
    simulate_reads(data_path, ref_path, all_chr, cfg)
    generate_graphs(data_path, all_chr, cfg)
    generate_graphs(data_path, all_chr, cfg, real=True)
    train_path, valid_path, test_path = train_valid_split(
        data_path, train_dict, valid_dict, test_dict, out
    )
    train_model(train_path, valid_path, out, overfit, cfg, device=device)
    predict(test_path, out, cfg=cfg, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(description="gnnome_tpu_torch full pipeline")
    parser.add_argument("--data", type=str, default="data")
    parser.add_argument("--refs", type=str, default="data/references")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--overfit", action="store_true")
    parser.add_argument("--config", type=str, default=None, help="JSON config path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of training and prediction")
    args = parser.parse_args(argv)
    cfg = Config.from_json(args.config) if args.config else Config()
    run_pipeline(args.data, args.refs, args.out, args.overfit, cfg, device=args.device)


if __name__ == "__main__":
    main()
