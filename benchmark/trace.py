"""What a traced run records, and its reduction to the numbers the per-layer
readers take.

* Spans: the benchmark's own, around its calls into the program's layers
  (``span("step")``, ``span("sampler")``, ``span("score")``,
  ``span("decode")``): host seconds, and a ``record_function`` range of
  the same name, so the profiler's timeline can say what the host was
  doing while the device waited.
* Launches: every launch of one of the program's kernel entries
  (``gnnome_tpu_torch/ops/cuda_lib.py`` ``Kernel``) with its integer
  arguments and the graph it ran on, for the operations and bytes of
  ``benchmark/costs/``.
* The device timeline from ``torch.profiler``: kernels by name, busy time
  (the union of the device's intervals), the port's kernels (every
  ``__global__`` function of ``gnnome_tpu_torch/csrc``), cuBLAS's, and the
  rest.

The reduction (``profile_summary``) takes ``chip_smoke.py``'s
``profile_run`` / ``kernel_group`` arithmetic, with busy time taken as the
union of intervals rather than a sum, so that it never passes the window.
"""
from __future__ import annotations

import contextlib
import re
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
# idle gaps named by the host range open at their middle: the longest few
# hundred; the many short ones between launches are counted together
NAMED_GAPS, SHORT_GAP_US = 300, 20


class Recorder:
    """Spans, launches and the graph of the current step, for one run."""

    def __init__(self, profiling: bool):
        self.profiling = profiling
        self.spans = defaultdict(list)
        self.launches = []
        self.graph = None  # dims of the graph the current step runs on
        self.steps = []  # dims of each optimizer step's graph

    @contextlib.contextmanager
    def span(self, name: str):
        if self.profiling:
            import torch

            ctx = torch.profiler.record_function(f"benchmark.{name}")
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.spans[name].append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def launch_log(self):
        """Every kernel-entry launch, with its integer arguments, while open."""
        from gnnome_tpu_torch.ops import cuda_lib

        call = cuda_lib.Kernel.__call__
        recorder = self

        def logged(kernel, device, *args):
            call(kernel, device, *args)
            ints = tuple(a for a, t in zip(args, kernel.argtypes) if t is not cuda_lib.P)
            recorder.launches.append((kernel.name, ints, recorder.graph))

        cuda_lib.Kernel.__call__ = logged
        try:
            yield
        finally:
            cuda_lib.Kernel.__call__ = call


def graph_dims(graph, host=None) -> dict:
    """Sizes the costs and FLOP counts take: padded and real nodes and
    edges, and the distinct sources and destinations of the real edges
    (from the host edge list where the benchmark has it)."""
    dims = dict(n=graph.n_nodes_padded, e=graph.n_edges_padded, nr=graph.n_nodes,
                er=graph.n_edges)
    if host is not None:
        dims.update(u_src=int(np.unique(host["src"]).size),
                    u_dst=int(np.unique(host["dst"]).size))
    return dims


def port_kernel_names() -> set:
    """The program's device kernels: every identifier ending in ``_kernel``
    in its CUDA sources (most are defined through macros, so the
    ``__global__`` lines do not all name them)."""
    names = set()
    for path in sorted((ROOT / "gnnome_tpu_torch" / "csrc").glob("*.cu*")):
        names.update(re.findall(r"\b(\w+_kernel)\b", path.read_text()))
    return names


def _base(name: str) -> str:
    """The function identifier of a device kernel's (demangled) name."""
    found = re.search(r"(\w+)\s*[<(]", name.replace("(anonymous namespace)", ""))
    return found.group(1) if found else name


def group_of(name: str, port: set) -> str:
    low = name.lower()
    if low.startswith("memcpy") or low.startswith("memset"):
        return "copy"
    if _base(name) in port:
        return "port"
    if "gemm" in low or "cutlass" in low or name.startswith("nvjet") or "cublas" in low:
        return "cublas"
    return "other"


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_summary(prof) -> dict:
    """The device timeline of a ``torch.profiler`` run whose window is the
    ``benchmark.window`` range: kernels ``[(name, group, seconds)]``,
    ``busy_s``, ``window_s``, and the ``breakdown`` the result line carries
    (the ten device operations that took most time, and idle time inside
    the window by the innermost host range open at each gap's middle)."""
    from torch.autograd import DeviceType

    port = port_kernel_names()
    device, host, window = [], [], None
    for evt in prof.events():
        rng = evt.time_range
        if evt.device_type == DeviceType.CUDA:
            # ranges of record_function on the device's timeline are no work
            annotation = getattr(evt, "is_user_annotation", False) or evt.name.startswith(
                "benchmark.")
            if rng.end > rng.start and not annotation:
                device.append((rng.start, rng.end, evt.name))
        else:
            host.append((rng.start, rng.end, evt.name))
            if evt.name == "benchmark.window":
                window = (rng.start, rng.end)
    if window is None or not device:
        raise RuntimeError("profile: no device time or no window range recorded")
    lo, hi = window
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in device if b > lo and a < hi]
    busy = _merge([(a, b) for a, b, _ in inside])
    busy_us = sum(b - a for a, b in busy)
    by_name = defaultdict(float)
    kernels = []
    for a, b, n in inside:
        by_name[n] += (b - a) / 1e6
        kernels.append((n, group_of(n, port), (b - a) / 1e6))
    gaps = defaultdict(float)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    spans = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                   reverse=True)
    h_start = np.array([s for s, _, n in host if n != "benchmark.window"], dtype=np.float64)
    h_end = np.array([e for _, e, n in host if n != "benchmark.window"], dtype=np.float64)
    h_name = [n for _, _, n in host if n != "benchmark.window"]
    h_len = h_end - h_start
    for k, (length, a, b) in enumerate(spans):
        if k >= NAMED_GAPS or length < SHORT_GAP_US:
            gaps[f"gaps under {SHORT_GAP_US} us or past the {NAMED_GAPS} longest"] += length / 1e6
            continue
        mid = (a + b) / 2
        open_ = np.nonzero((h_start <= mid) & (h_end >= mid))[0]
        name = (h_name[open_[np.argmin(h_len[open_])]] if open_.size
                else "host outside any recorded range")
        gaps[name] += length / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(kernels=kernels, busy_s=busy_us / 1e6, window_s=(hi - lo) / 1e6,
                breakdown=dict(device_ops=[[n[:160], s] for n, s in top],
                               idle_gaps=[[n[:160], s] for n, s in idle]))
