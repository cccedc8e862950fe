"""Quick-start example: train on chr19 graphs, assemble chr21.

Counterpart of ``gnnome_tpu/example.py`` (reference ``example.py:4-29``:
train 3× chr19, valid 1× chr19, test 1× chr21, then the full
train→assemble flow). :func:`example` needs the CHM13 chromosomes
(``pipeline.download_reference``); :func:`synthetic_example` runs offline
on two synthetic mini-chromosomes.

    python -m gnnome_tpu_torch.example --synthetic [--device cuda]
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from gnnome_tpu_torch import pipeline
from gnnome_tpu_torch.config import Config, ModelConfig, SplitConfig, TrainConfig


def example(data_path: str = "data", refs_path: str = "data/references",
            device="cuda") -> None:
    cfg = Config(split=SplitConfig(
        train={"chr19": 3}, valid={"chr19": 1}, test={"chr21": 1}
    ))
    pipeline.run_pipeline(data_path, refs_path, out="example", cfg=cfg, device=device)


def synthetic_config(root: str = "data/synthetic_example") -> Config:
    """The offline example's configuration: an 8-layer, 128-wide model,
    15 full-graph epochs, 2/1/1 graphs, coverage 12."""
    cfg = Config(
        model=ModelConfig(num_gnn_layers=8, hidden_features=128),
        train=TrainConfig(
            num_epochs=15, batch_size_train=1,
            checkpoint_dir=os.path.join(root, "checkpoints"),
            pretrained_dir=os.path.join(root, "pretrained"),
        ),
        split=SplitConfig(train={"chr19": 2}, valid={"chr19": 1}, test={"chr21": 1}),
    )
    cfg.data.coverage = 12.0
    return cfg


def synthetic_example(root: str = "data/synthetic_example",
                      cfg: Optional[Config] = None, device="cuda"):
    """Offline variant: two synthetic mini-chromosomes stand in for
    chr19/chr21 so the whole flow runs with zero downloads. ``cfg``
    defaults to :func:`synthetic_config`; returns ``predict``'s results
    (one quick-evaluation tuple per test graph)."""
    from gnnome_tpu_torch.data.simulate import write_fasta

    cfg = cfg or synthetic_config(root)
    refs = os.path.join(root, "references", "chromosomes")
    os.makedirs(refs, exist_ok=True)
    rng = np.random.default_rng(0)
    for chr_n, size in (("chr19", 120_000), ("chr21", 90_000)):
        base = "".join(rng.choice(list("ACGT"), size=size))
        # plant a repeat so the graph has negative edges to learn
        genome = base[: size // 3] + base[size // 6 : size // 6 + 8000] + base[size // 3 :]
        write_fasta(os.path.join(refs, f"{chr_n}.fasta"), [(chr_n, genome)])

    data = os.path.join(root, "data")
    ref_root = os.path.join(root, "references")
    all_chr = pipeline.merge_dicts(cfg.split.train, cfg.split.valid, cfg.split.test)
    pipeline.file_structure_setup(data, ref_root)
    pipeline.simulate_reads(data, ref_root, all_chr, cfg)
    pipeline.generate_graphs(data, all_chr, cfg)
    train_path, valid_path, test_path = pipeline.train_valid_split(
        data, cfg.split.train, cfg.split.valid, cfg.split.test, "example"
    )
    pipeline.train_model(train_path, valid_path, "example", False, cfg, device=device)
    return pipeline.predict(test_path, "example", cfg=cfg, device=device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", default="data")
    parser.add_argument("--refs", default="data/references")
    parser.add_argument("--synthetic", action="store_true",
                        help="offline run on synthetic mini-chromosomes")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.synthetic:
        synthetic_example(device=args.device)
    else:
        example(args.data, args.refs, device=args.device)
