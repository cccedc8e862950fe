"""Paper-reproduction entry points (counterpart of ``gnnome_tpu/reproduce.py``).

Reference: ``reproduce.py`` — (a) ``untangle_synthetic``: train on 15× chr19
and assemble synthetic chromosomes (``reproduce.py:6-27``); (b)
``untangle_real``: use a pretrained model to assemble all 23 real
chromosomes (``reproduce.py:30-52``, pretrained ``model_15xchr19``).
"""
from __future__ import annotations

import argparse
import os

from gnnome_tpu_torch import pipeline
from gnnome_tpu_torch.config import Config, SplitConfig

ALL_CHR_REAL = {f"chr{i}_r": 1 for i in list(range(1, 23)) + ["X"]}


def untangle_synthetic(data_path="data", refs_path="data/references",
                       out="15xchr19", cfg: Config | None = None, device="cuda"):
    cfg = cfg or Config()
    cfg.split = SplitConfig(
        train={"chr19": 15},
        valid={"chr19": 3},
        test={"chr19": 1, "chr21": 1},
    )
    pipeline.run_pipeline(data_path, refs_path, out=out, cfg=cfg, device=device)


def untangle_real(data_path="data", refs_path="data/references",
                  model_path=None, out="15xchr19", cfg: Config | None = None,
                  device="cuda"):
    cfg = cfg or Config()
    cfg.split = SplitConfig(train={}, valid={}, test=dict(ALL_CHR_REAL))
    all_chr = dict(ALL_CHR_REAL)
    pipeline.file_structure_setup(data_path, refs_path)
    pipeline.generate_graphs(data_path, all_chr, cfg, real=True)
    _, _, test_path = pipeline.train_valid_split(
        data_path, {}, {}, all_chr, out=f"real_{out}"
    )
    if model_path is None:
        model_path = os.path.join(cfg.train.pretrained_dir, f"model_{out}.npz")
    pipeline.predict(test_path, out, model_path=model_path, cfg=cfg, device=device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", choices=["synthetic", "real"], default="synthetic")
    parser.add_argument("--data", default="data")
    parser.add_argument("--refs", default="data/references")
    parser.add_argument("--model", default=None)
    parser.add_argument("--out", default="15xchr19")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.mode == "synthetic":
        untangle_synthetic(args.data, args.refs, args.out, device=args.device)
    else:
        untangle_real(args.data, args.refs, args.model, args.out, device=args.device)
