"""Standalone graph generation CLI (counterpart of ``gnnome_tpu/generate.py``;
reference ``generate.py:9-22``): pre-build assembly-graph caches without
training. Host work only: nothing goes to a device.

    python -m gnnome_tpu_torch.generate --data <dir with raw/>
"""
from __future__ import annotations

import argparse

from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset


def main(argv=None):
    parser = argparse.ArgumentParser(description="build assembly graphs")
    parser.add_argument("--data", type=str, required=True,
                        help="directory with a raw/ subdir of read FASTA/Qs")
    parser.add_argument("--threads", type=int, default=32)
    parser.add_argument("--filter", type=float, default=0.99)
    args = parser.parse_args(argv)
    AssemblyGraphDataset(
        args.data, nb_pos_enc=None, generate=True,
        specs={"threads": args.threads, "filter": args.filter},
    )


if __name__ == "__main__":
    main()
