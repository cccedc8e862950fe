#!/usr/bin/env python3
"""Host cost of one of the program's spans (``utils/profiling.py`` ``span``).

    python3 scripts/torch_span_cost.py [--count N]

Opens and closes ``N`` empty spans with no profiler recording, then under
``torch.profiler`` (host and, where there is a card, device activity), and
prints the host µs a span in each state, with the device's name. The first
is the cost every training step pays; the second only a traced run.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def per_span_us(count: int) -> float:
    from gnnome_tpu_torch.utils.profiling import span

    t0 = time.perf_counter()
    for _ in range(count):
        with span("norm"):
            pass
    return (time.perf_counter() - t0) / count * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--count", type=int, default=20_000)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    per_span_us(1000)
    off = per_span_us(args.count)
    with torch.profiler.profile(activities=acts):
        on = per_span_us(args.count)
    device = torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"
    print(f"span host cost ({device}, torch {torch.__version__}, {args.count} spans): "
          f"off {off:.4f} us, on {on:.3f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
