"""Structured profiling (counterpart of ``gnnome_tpu/utils/profiling.py``;
the reference imports torch.profiler but never uses it, ``train.py:16``;
its only timing is ad-hoc wall clock, ``utils.py:143-146``). Here:
torch.profiler traces + a timer registry."""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the host and, where there is a
    card, its kernels; written on exit as a Chrome trace
    (``<log_dir>/trace_<pid>_<ns>.json``, viewable in Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region that shows up inside traces."""
    return torch.profiler.record_function(name)


class Timers:
    """Wall-clock stage timers (`timedelta_to_str`-style reporting,
    ``utils.py:143-146``, but aggregated)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t:.2f}s total, {c}x, {t / max(c,1):.3f}s avg")
        return "\n".join(lines)


def timedelta_to_str(seconds: float) -> str:
    """``utils.timedelta_to_str`` parity (``utils.py:143-146``)."""
    hours, rem = divmod(int(seconds), 3600)
    minutes, secs = divmod(rem, 60)
    return f"{hours}h {minutes}m {secs}s"
