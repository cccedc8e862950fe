#!/usr/bin/env python3
"""Readings for the limits of ``correct``: the program's, and its control's
and planted faults', over many seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... [--controls 3]

For each seed it builds the cell's inputs and runs its set-up (for a
training cell the program's first three steps, the steps a run checks;
for ``assemble`` the scoring of one graph), then prints one JSON line:
the program's numbers against the reference (the lower readings), and on
the first ``--controls`` seeds the same numbers of

* ``control``: the reference put in the program's place with the operands
  of every product rounded to the nearest precision below the
  configuration's ``compute_dtype`` (``benchmark/reference/model.py``
  ``bits``): TF32 below float32, fp8 E4M3's significand below bfloat16;
* ``half_batch`` (training): the reference with its loss the mean over the
  first half of each graph's edges, the rest left out;
* ``frozen`` (training): a step that leaves the parameters as they were.

The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys

import run
import torch


def half_batch_loss(bce):
    def loss(logits, y, pos_weight):
        half = logits.shape[0] // 2
        return bce(logits[:half], y[:half], pos_weight)
    return loss


def readings(cell, controls: bool) -> dict:
    from benchmark.reference import model as ref_model

    out = dict(program=cell.numbers())
    if hasattr(cell, "reference_readings"):
        # how many first-gradient elements the two sides give opposite signs,
        # and how many lie where Adam's eps is not small against them
        flips = tiny = total = 0
        for k, g in cell.first["grad1"].items():
            r = cell.ref["grad1"][k]
            flips += int((torch.sign(g) != torch.sign(r)).sum())
            tiny += int((r.abs() < 1e-7).sum())
            total += r.numel()
        out["first_gradient"] = {"sign_flips": flips, "below_1e-7": tiny, "elements": total}
    if not controls:
        return out
    bits = ref_model.CONTROL_BITS[cell.config["compute_dtype"]]
    if hasattr(cell, "reference_readings"):
        out["control"] = cell.numbers(cell.reference_readings(bits))
        bce = ref_model.bce_loss
        ref_model.bce_loss = half_batch_loss(bce)
        try:
            half = cell.reference_readings()
        finally:
            ref_model.bce_loss = bce
        out["half_batch"] = cell.numbers(half)
        frozen = dict(cell.first, theta3=cell.theta0)
        out["frozen"] = cell.numbers(frozen)
    else:
        out["control"] = cell.numbers(cell.reference_logits(cell.checked()[0], bits))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--controls", type=int, default=3)
    args = parser.parse_args(argv)
    run._paths_and_caches()
    spec = run.load_spec(args.workload)

    import torch

    from benchmark import cells
    from benchmark.reference import model as ref_model
    from benchmark.trace import Recorder

    ref_model.exact_f32_products()
    torch.set_num_threads(run.THREADS)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if spec["traffic"]["mode"] == "train" and device == "cuda" \
            and spec["traffic"]["train"].get("num_parts_train", 500) > 1:
        run.build_native()
    for k, seed in enumerate(args.seeds):
        cell = cells.make(spec["config"], spec["traffic"], seed, device, Recorder(False))
        cell.setup()
        if spec["traffic"]["mode"] == "assemble":
            cell.unit(decode=False)
        cell.free()
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              **readings(cell, k < args.controls))), flush=True)
        del cell
    return 0


if __name__ == "__main__":
    sys.exit(main())
