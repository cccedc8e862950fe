"""Device time of the program's spans inside a GatedGCN layer in a traced
window: ``gate`` (the edge gate's assembly) and ``aggregate`` (the σ sums
to ``a1h + h_fwd + h_bwd``), opened in ``gnnome_tpu_torch/models/
gated_gcn.py`` beside the ``norm`` spans.

A kernel is put down to a span as ``benchmark/spans.py`` ``attribute``
puts it: by the host call that enqueued it, a backward kernel by its
forward op's spans, a recompute kept apart from the backward. A span
counts the kernels of the forward, the recompute and the backward that
it, or its forward op, holds.
"""
from __future__ import annotations

from benchmark import spans

TRAINING = ("forward", "recompute", "backward")


def reduce(events) -> dict:
    """``steps``: the ``train.step`` spans; ``seen``: the program spans the
    host opened; ``(name, phase)``: device seconds of the launches under the
    program span ``name`` (without its prefix) in each phase of
    :data:`TRAINING`."""
    host = spans._host(events)
    out = dict(steps=sum(e.name == spans.STEP for e in host),
               seen={e.name[len(spans.PREFIX):] for e in host
                     if e.name.startswith(spans.PREFIX)})
    for _, seconds, phase, mods in spans.attribute(events, spans.device_launches(events)):
        if phase not in TRAINING:
            continue
        for name in mods:
            key = (name[len(spans.PREFIX):], phase)
            out[key] = out.get(key, 0.0) + seconds
    return out


def of_view(view):
    """The reduction of a traced window, made once per window, from the
    profiler that recorded it; None where there is no profile to read."""
    if not hasattr(view, "layer_spans"):
        prof = spans._profile_on_stack()
        view.layer_spans = None if prof is None else reduce(prof.events())
    return view.layer_spans


def per_step_ms(view, name: str):
    """Device ms a traced step of the kernels under the span ``name``, its
    forward, recompute and backward; None where the window holds no
    ``train.step`` span or the program never opened ``name`` (a program
    without that span)."""
    red = of_view(view)
    if not red or not red["steps"] or name not in red["seen"]:
        return None
    return 1e3 * sum(red.get((name, p), 0.0) for p in TRAINING) / red["steps"]
