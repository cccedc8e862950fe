#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``gnnome_tpu_torch``): one cell,
one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration file, its traffic file (``benchmark/workloads/<traffic>.json``),
its limits (``benchmark/limits/<cell>.json``) and the readers of its
per-layer metrics (``benchmark/metrics/<metric>.py``) are found by name. A
run builds its inputs and weights from ``--seed`` and warms up (set-up),
then either measures for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics) or profiles a few units (``--trace 1``: its per-layer
metrics), then holds what the program produced against the plain
reference model that the configuration's key ``reference`` names (a file of
``benchmark/reference/``). The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of that object.

Exits non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), or when ``jax``, ``jaxlib``, ``flax`` or the JAX package is
loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gnnome_tpu")
CACHE = ROOT / ".bench_cache"  # fixed, inside the checkout, git-ignored


# host threads of the run: few, and waiting without spinning, so that the
# host-bound cells read the program and not the host's other load
THREADS = 2


def _paths_and_caches() -> None:
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path[0] = str(ROOT)
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)


def load_spec(cell: str, work: dict | None = None, root: Path = ROOT) -> dict:
    """Everything a run of ``cell`` takes, found by the names in
    ``BENCHMARK.json``; ``work`` stands for its entry there (a cell the
    file does not hold yet)."""
    from benchmark import reference

    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = work or next((w for w in bench["workloads"] if w["name"] == cell), None)
    if work is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((root / conf["file"]).read_text())
    reference.load(config)  # a configuration without a sound reference fails here

    def listed(metric):
        return cell in metric.get("workloads", [cell])

    return dict(
        cell=cell, chips=work["chips"], config=config,
        traffic=json.loads((HERE / "workloads" / f"{work['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{cell}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if listed(m)],
        per_layer=[m for m in bench["per_layer"] if listed(m)])


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def build_native() -> None:
    """The native partitioner (``make -C native``), once per checkout; with
    ``CXX=g++`` given, as a compiler named in the environment may lack
    OpenMP."""
    import subprocess

    if not (ROOT / "native" / "build" / "libgnnome_native.so").exists():
        done = subprocess.run(["make", "-s", "-j3", "-C", str(ROOT / "native"), "CXX=g++"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"make -C native failed:\n{done.stdout}")


class TracedWindow:
    """What the per-layer readers take from one traced window."""

    def __init__(self, summary: dict, rec, model: dict):
        self.window_s, self.busy_s = summary["window_s"], summary["busy_s"]
        self.kernels, self.launches = summary["kernels"], rec.launches
        self.spans, self.steps, self.model = rec.spans, rec.steps, model


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None) -> dict:
    """One run of the cell ``spec`` describes; returns the result object."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    torch.set_num_threads(THREADS)

    from benchmark import cells, metrics
    from benchmark.trace import Recorder, profile_summary

    cuda = device == "cuda"
    traffic, config = spec["traffic"], spec["config"]
    if cuda:
        from gnnome_tpu_torch.ops import cuda_lib

        cuda_lib.library()
    if cuda and traffic["mode"] == "train" and traffic["train"].get("num_parts_train", 500) > 1:
        build_native()
    rec = Recorder(profiling=trace)
    cell = cells.make(config, traffic, seed, device, rec)
    cell.reference.exact_f32_products()
    cell.setup()
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    result = dict(correct=False, attempted=0, failed=0, metrics={})
    if trace:
        rec.spans.clear()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        attempted = failed = 0
        with torch.profiler.profile(activities=acts) as prof, rec.launch_log(), cell.traced():
            with torch.profiler.record_function("benchmark.window"):
                for _ in range(traffic["trace_units"]):
                    s, f, _ = cell.unit()
                    attempted, failed = attempted + s, failed + f
                if cuda:
                    torch.cuda.synchronize()
        summary = profile_summary(prof)
        view = TracedWindow(summary, rec, config)
        for m in spec["per_layer"]:
            value = metrics.load(m["name"])(view)
            if value is not None:
                result["metrics"][m["name"]] = dict(value=value, unit=m["unit"])
        result.update(attempted=attempted, failed=failed)
        window = dict(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = summary["breakdown"]
    else:
        win = cells.run_window(cell, seconds)
        values = dict(setup_s=setup_s)
        if traffic.get("rate_metric"):
            values[traffic["rate_metric"]] = win["edges"] / win["window_s"]
        if traffic.get("unit_metric"):
            values[traffic["unit_metric"]] = win["window_s"] / win["units"]
        if cuda:
            values["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        for m in spec["end_to_end"]:
            if cuda or m["name"] in values:  # no device memory reading on the CPU
                result["metrics"][m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
        result.update(attempted=win["steps"], failed=win["failed"])
        window, breakdown = {}, None

    result["device"] = dict(platform="gpu" if cuda else "cpu",
                            kind=torch.cuda.get_device_name() if cuda else "cpu",
                            count=spec["chips"],
                            memory_peak_bytes=max(setup_peak, torch.cuda.max_memory_allocated())
                            if cuda else 0, **window)
    if breakdown is not None:
        result["breakdown"] = breakdown
    cell.free()
    numbers = cell.numbers()
    compared = {k: dict(value=numbers[k], limit=limit) for k, limit in spec["limits"].items()}
    result["correct"] = bool(result["attempted"] > 0 and result["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in compared.values()))
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    t_start = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _paths_and_caches()
    spec = load_spec(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"benchmark: needs {spec['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed % 2**63, args.seconds, bool(args.trace),
                      t_start=t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"benchmark: the process holds {leaked} once the window has closed",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
