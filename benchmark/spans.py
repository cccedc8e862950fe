"""Device time of the program's own spans in a traced window.

The program opens ``gnnome.<name>`` ranges while a profiler records
(``gnnome_tpu_torch/utils/profiling.py`` ``span``): ``train.step`` with its
phases ``train.forward``, ``train.backward`` and ``train.optimizer``
(``train/loop.py``), ``model.layer`` around each GatedGCN layer inside the
checkpointed function (``models/model.py``), and ``norm`` (``ops/norm.py``,
the BatchNorm gate's affine in ``models/gated_gcn.py``).

Each device operation is put down to a span by the host call that
enqueued it (the profiler's link from a kernel to its launch), never by
time overlap, since the host runs ahead of the device:

* phase: the ``train.*`` span on the step's own thread whose interval holds
  the launch. Autograd may run the backward on a thread of its own, whose
  launches fall inside ``train.backward`` on the step's thread;
* module: the program spans open around the launching op on its own
  thread. A launch inside an autograd node with no module span of its own
  takes those of the forward op that created the node, found by the
  node's ``(fwd_thread, sequence_nr)``;
* recompute: a launch under ``model.layer`` in the backward phase (the
  checkpointed layer's forward run again), counted apart from the
  backward.

A kernel under nested spans (``masked_batch_norm`` calls
``masked_moments``) is counted once.
"""
from __future__ import annotations

import re
import sys
from bisect import bisect_right

PREFIX = "gnnome."
STEP = PREFIX + "train.step"
PHASES = {PREFIX + "train.forward": "forward", PREFIX + "train.backward": "backward",
          PREFIX + "train.optimizer": "optimizer"}
LAYER, NORM = PREFIX + "model.layer", PREFIX + "norm"
NODE = "autograd::engine::evaluate_function: "
KINDS = ("forward", "backward", "recompute", "optimizer")
# CUDA API calls: cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...
# (no op of the program or of PyTorch is named so)
CUDA_CALL = re.compile(r"cu(da)?[A-Z]")


def device_launches(events) -> list:
    """``[(launching host call, device seconds)]`` of every device operation
    of a profile. The call is the CUDA API call that enqueued
    the operation (``cudaLaunchKernel``, ``cuLaunchKernel``,
    ``cudaMemcpyAsync``, ...: the profiler gives both the same correlation
    id), so it sits inside the op and the spans that made it, on its own
    thread. Operations with no such call are left out
    (:func:`unlinked_seconds`); ranges of ``record_function`` on the
    device's timeline are no work, as ``benchmark/trace.py`` has it."""
    calls = {e.id: e for e in _host(events) if CUDA_CALL.match(e.name)}
    return [(calls[k.id], seconds) for k, seconds in _device_work(events) if k.id in calls]


def unlinked_seconds(events) -> float:
    """Device seconds of the operations :func:`device_launches` leaves out."""
    calls = {e.id for e in _host(events) if CUDA_CALL.match(e.name)}
    return sum(seconds for k, seconds in _device_work(events) if k.id not in calls)


def _device_work(events) -> list:
    from torch.autograd import DeviceType

    return [(e, (e.time_range.end - e.time_range.start) / 1e6) for e in events
            if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start
            and not (getattr(e, "is_user_annotation", False) or e.name.startswith("benchmark."))]


def _host(events) -> list:
    """The host's events: the program's ranges also appear on the device's
    timeline, under the same names."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CPU]


class _Stacks:
    """The program spans open around a host event on its own thread,
    innermost first, and the autograd node it runs in (memoized per
    event: launches share their ancestors)."""

    def __init__(self):
        self.memo = {}

    def __call__(self, event):
        chain, e = [], event
        while e is not None and id(e) not in self.memo:
            chain.append(e)
            e = e.cpu_parent
        names, node = self.memo[id(e)] if e is not None else ((), None)
        for e in reversed(chain):
            if e.name.startswith(PREFIX):
                names = (e.name,) + names
            elif e.name.startswith(NODE):
                node = e
            self.memo[id(e)] = (names, node)
        return self.memo[id(event)]


class _Intervals:
    """Disjoint ``(start, end, label)`` intervals of one thread."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t):
        i = bisect_right(self.starts, t) - 1
        return self.spans[i][2] if i >= 0 and t <= self.spans[i][1] else None


def attribute(events, launches) -> list:
    """``[(op, seconds, phase, modules)]`` of the launches made inside a
    ``train.step`` span: phase one of ``KINDS`` or None (inside the step,
    in no phase), modules the program's non-phase spans, innermost first."""
    events = _host(events)
    steps = [e for e in events if e.name == STEP]
    if not steps:
        return []
    main = steps[0].thread
    step_at = _Intervals((e.time_range.start, e.time_range.end, True)
                         for e in steps if e.thread == main)
    phase_at = _Intervals((e.time_range.start, e.time_range.end, PHASES[e.name])
                          for e in events if e.thread == main and e.name in PHASES)
    stacks = _Stacks()

    def modules(e):
        return tuple(n for n in stacks(e)[0] if n != STEP and n not in PHASES)

    # the forward op that created each autograd node: the last one to start
    # with the node's number (an outer op, or one that made no node, starts
    # earlier with the same number)
    created = {}
    for e in sorted((e for e in events if e.sequence_nr >= 0 and e.thread == main),
                    key=lambda e: e.time_range.start):
        if phase_at.at(e.time_range.start) == "forward":
            created[(e.thread, e.sequence_nr)] = e
    out = []
    for op, seconds in launches:
        t = op.time_range.start
        if not step_at.at(t):
            continue
        phase, mods, node = phase_at.at(t), modules(op), stacks(op)[1]
        if phase == "backward" and LAYER in mods:
            phase = "recompute"
        elif not mods and node is not None:
            fwd = created.get((node.fwd_thread, node.sequence_nr))
            mods = modules(fwd) if fwd is not None else ()
        out.append((op, seconds, phase, mods))
    return out


def reduce(events, launches=None) -> dict:
    """Seconds of device time in the window's ``train.step`` spans: in
    all (``step``), by phase (``KINDS``, and ``unphased``), and under
    ``norm`` (``norm``, and by phase ``norm_<kind>``); ``steps`` counts the
    ``train.step`` spans. ``launches`` defaults to the device's
    (:func:`device_launches`)."""
    launches = device_launches(events) if launches is None else launches
    out = dict(steps=sum(e.name == STEP for e in _host(events)), step=0.0, unphased=0.0,
               norm=0.0)
    out.update({k: 0.0 for k in KINDS}, **{f"norm_{k}": 0.0 for k in KINDS})
    for _, seconds, phase, mods in attribute(events, launches):
        out["step"] += seconds
        out[phase or "unphased"] += seconds
        if NORM in mods:
            out["norm"] += seconds
            if phase is not None:
                out[f"norm_{phase}"] += seconds
    return out


def _profile_on_stack():
    """The ``torch.profiler.profile`` that recorded the window, held by a
    caller (``benchmark/run.py`` ``run_cell``'s ``prof``), or None."""
    import torch

    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, torch.profiler.profile):
                return value
        frame = frame.f_back
    return None


def of_view(view):
    """The reduction of a traced window (``benchmark/run.py``
    ``TracedWindow``), made once per window: ``view.program_spans`` where
    the window carries it, else from the profiler that recorded it; None
    where there is no profile to read."""
    if not hasattr(view, "program_spans"):
        prof = _profile_on_stack()
        view.program_spans = None if prof is None else reduce(prof.events())
    return view.program_spans


def per_step_ms(view, key: str):
    """Device ms a traced step under ``key`` of :func:`reduce`; None where
    the window holds no ``train.step`` span (a program without spans)."""
    spans = of_view(view)
    if not spans or not spans["steps"]:
        return None
    return 1e3 * spans[key] / spans["steps"]
