#!/usr/bin/env python3
"""Device time of one full-scale training step of the port, by PyTorch op.

    python3 scripts/torch_profile_step.py [--seed N]

The BatchNorm model of the default ``ModelConfig`` (16 layers, D = 256) on
``chip_smoke.py``'s local bench graph (150k nodes, 999,995 edges) under
``remat="layer"``, a warm-up step, then one step under torch.profiler, in
f32 and in bf16. Prints, for each dtype, the step's device ms and the 30
ops (aten ops and the port's kernel entries, by name and input shapes)
that launched the most device time (their self device time: kernels
launched inside a child op count for the child). Needs an NVIDIA card.
It says what ``chip_smoke.py``'s kernel groups cannot: which op an
unfused elementwise kernel belongs to.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_step: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    from gnnome_tpu_torch.config import ModelConfig
    from gnnome_tpu_torch.data.synthetic import bench_features, bench_labels, build_bench_graph
    from gnnome_tpu_torch.models.model import init_model_params
    from gnnome_tpu_torch.train.loop import make_optimizer, train_step

    graph, _ = build_bench_graph(150_000, 1_000_000, seed=args.seed, device="cuda")
    cfg = ModelConfig()
    e_feat, pe = bench_features(graph, args.seed, cfg.nb_pos_enc)
    y = bench_labels(graph, args.seed)
    pos_weight = torch.tensor(0.5, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for dtype in ("float32", "bfloat16"):
        params = init_model_params(torch.Generator().manual_seed(args.seed), cfg, "cuda")
        opt = make_optimizer(params, 1e-3)

        def step():
            train_step(params, opt, graph, e_feat, pe, y, pos_weight, compute_dtype=dtype)
            torch.cuda.synchronize()

        step()
        with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
            step()
        rows = []
        for evt in prof.key_averages(group_by_input_shape=True):
            if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CPU:
                continue
            ms = evt.self_device_time_total / 1e3
            if ms > 0:
                rows.append((ms, evt.count, evt.key, str(evt.input_shapes)[:110]))
        total = sum(r[0] for r in rows)
        print(f"== {dtype}, remat='layer': {total:.3f} device ms in the step, "
              f"by op (self device ms, calls, op, input shapes):", flush=True)
        for ms, count, key, shapes in sorted(rows, reverse=True)[:30]:
            print(f"  {ms:9.3f} {count:5d}  {key[:40]:40s} {shapes}", flush=True)
        del params, opt
        torch.cuda.empty_cache()
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
