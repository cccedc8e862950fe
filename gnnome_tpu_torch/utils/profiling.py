"""Structured profiling (counterpart of ``gnnome_tpu/utils/profiling.py``;
the reference imports torch.profiler but never uses it, ``train.py:16``;
its only timing is ad-hoc wall clock, ``utils.py:143-146``). Here: the
program's spans and a torch.profiler trace exporter.

A span (:func:`span`) marks where a part of the program runs: the training
step's forward, backward and optimizer, each GatedGCN layer, the norms. It
costs one flag check while no profiler records, and is a ``gnnome.<name>``
range on the profiler's own timeline while one does, so the device time of
the kernels each part launches can be put down to it.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "gnnome."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``gnnome.<name>`` range while a profiler records; otherwise a shared
    no-op context, after one check of the profiler's flag. Changes no value,
    adds no autograd node and saves no tensor."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the host and, where there is a
    card, its kernels, with the program's spans; written on exit as a
    Chrome trace (``<log_dir>/trace_<pid>_<ns>.json``, viewable in
    Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def timedelta_to_str(seconds: float) -> str:
    """``utils.timedelta_to_str`` parity (``utils.py:143-146``)."""
    hours, rem = divmod(int(seconds), 3600)
    minutes, secs = divmod(rem, 60)
    return f"{hours}h {minutes}m {secs}s"
