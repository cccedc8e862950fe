#!/usr/bin/env python3
"""Time the port's edge-walk kernel entries of one checkout on the card.

    python3 scripts/torch_bench_walks.py [--root DIR] [--seed N] [--shapes ...]
                                         [--cluster]

Runs ``chip_smoke.py``'s phase-2 walk measurements (``phase_walks``: the
seven entries that walk edges, ``epilog_bwd`` and ``epilog_bwd_pregathered``,
``rev_bwd``, ``opp_bwd`` and the three σ-aggregate backwards, each checked
against its plain version and timed with CUDA events beside its byte bound)
on the local 150k / 1M bench graph, the padded ClusterGCN piece shape and the
hub graph, with the ``gnnome_tpu_torch`` package found under ``--root``
(default: this checkout). Pointing ``--root`` at an unpacked copy of another
commit (``git archive``) times that commit's kernels with this checkout's
shapes and byte counts, so two versions are compared in one call, in turns.
``--cluster`` then runs ``chip_smoke.py``'s phase 7 (two ClusterGCN epochs
and a validation pass under the default ``Config``) with that package,
after building its ``native/`` library. The last line is one JSON object:
the card, the root and the kernel times.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", nargs="*", default=["local", "piece", "hub"],
                    choices=["local", "piece", "hub"])
    ap.add_argument("--cluster", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    # the package from --root first; chip_smoke (shapes, timing) from here
    sys.path[:0] = [str(root), str(REPO)]
    import torch

    if not torch.cuda.is_available():
        print("torch_bench_walks: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gnnome_tpu_torch.data.synthetic import build_bench_graph
    from gnnome_tpu_torch.ops import cuda_lib

    if not cuda_lib.PACKAGE_DIR.resolve().is_relative_to(root):
        raise RuntimeError(f"gnnome_tpu_torch came from {cuda_lib.PACKAGE_DIR}, not {root}")
    cuda_lib.library()
    makers = {"local": lambda: build_bench_graph(cs.N_NODES, cs.N_EDGES, seed=args.seed,
                                                 device="cuda")[0],
              "piece": lambda: cs.piece_graph(args.seed),
              "hub": lambda: cs.hub_graph(args.seed)}
    times = {}
    with torch.inference_mode():
        for label in args.shapes:
            graph = makers[label]()
            walks = cs.phase_walks(torch, graph, args.seed, label)
            times[label] = {name: {k: m[k] for k in ("ms", "plain_ms", "bound_ms")}
                            for name, m in walks.items()}
            del graph
            torch.cuda.empty_cache()
    if args.cluster:
        import subprocess

        from gnnome_tpu_torch.data import native_bridge

        subprocess.run(["make", "-s", "-j3", "-C", str(root / "native"), "CXX=g++"],
                       check=True)
        native_bridge._load.cache_clear()
        cs.phase_cluster(torch, args.seed)
    print(json.dumps({"card": cs.card_name_and_power(), "root": str(root),
                      "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
