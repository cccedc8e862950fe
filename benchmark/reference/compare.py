"""The numbers that decide ``correct``, from the program's readings and the
reference's. Nothing here imports the program.

Training (the first three optimizer steps of the run, which set-up drives
through the window's own call):

* ``loss_gap``: the largest ``|L - L_ref| / |L_ref|`` over the three steps;
* ``grad_gap``: the first step's gradient as the optimizer got it (the
  program's Adam first moment after one step, over ``1 - beta1``), by the
  worst leaf: ``| |g| - |g_ref| |`` over the larger of ``|g_ref|`` for that
  leaf and for the median leaf;
* ``change_gap``: the parameters' change over the three steps, by the worst
  leaf, the same way. Leaves whose reference gradient is under a thousandth
  of the median leaf's are left out: their exact gradient is nought (a bias
  before a BatchNorm), and Adam moves them by round-off alone;
* ``grad_cos_gap_median``: the first gradient's direction, by the median
  leaf: ``1 - cos(g, g_ref)`` over the same leaves as ``change_gap`` (a
  nought gradient has no direction). Norms can agree where directions do
  not: a loss over half of the edges has a gradient of about the same
  size. The median leaf, as a bf16 model's worst leaf (``grad_cos_gap``)
  is whichever gradient the BatchNorm's backward nearly cancels, and swings
  with it from seed to seed.

Decoding: ``logit_gap``, the largest ``|logit - logit_ref|`` over a graph's
edges, and ``walks_differ``, the number of contig walks that differ from
the reference decoder's on the program's own scores (exact).
"""
from __future__ import annotations

import statistics

import torch

NOISE_LEAF = 1e-3


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _gaps(got: dict, ref: dict, keys) -> dict:
    """Per leaf ``| |got| - |ref| |`` over the larger of the leaf's and the
    median leaf's reference norm."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def training_numbers(prog: dict, ref: dict, theta0: dict) -> dict:
    """``prog`` and ``ref``: ``losses`` (three floats), ``grad1``
    ({name: tensor}) and ``theta3`` ({name: tensor}); ``theta0``: the
    parameters both started from. Besides the compared numbers, the
    first step's loss gap and the median leaf's gaps, and the worst leaves'
    names, for the choice of the limits."""
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    g_ref = _norms(ref["grad1"])
    grad = _gaps(_norms(prog["grad1"]), g_ref, list(g_ref))
    med = statistics.median(g_ref.values())
    moved = [k for k, v in g_ref.items() if v >= NOISE_LEAF * med]
    change = _gaps(_norms({k: prog["theta3"][k] - theta0[k] for k in moved}),
                   _norms({k: ref["theta3"][k] - theta0[k] for k in moved}), moved)
    cos = {k: 1.0 - float(torch.nn.functional.cosine_similarity(
        prog["grad1"][k].double().flatten(), ref["grad1"][k].double().flatten(), dim=0,
        eps=1e-300)) for k in moved}
    return dict(loss_gap=max(loss_gaps), loss_gap_first=loss_gaps[0],
                grad_gap=max(grad.values()), grad_gap_median=statistics.median(grad.values()),
                change_gap=max(change.values()),
                change_gap_median=statistics.median(change.values()),
                grad_cos_gap=max(cos.values()),
                grad_cos_gap_median=statistics.median(cos.values()),
                grad_worst=max(grad, key=grad.get), change_worst=max(change, key=change.get))


def logit_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref.double()).abs().max())


def walks_differ(got: list, ref: list) -> int:
    """Walks that differ position by position, and every walk one side has
    and the other lacks."""
    return sum(a != b for a, b in zip(got, ref)) + abs(len(got) - len(ref))
