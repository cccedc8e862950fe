"""Masked normalization layers (counterpart of ``gnnome_tpu/ops/norm.py``).

The reference uses ``nn.BatchNorm1d(..., track_running_stats=False)``
(``layers/gated_gcn_full.py:55-56``): statistics come from the current
batch in train and eval mode alike. Rows may be padded, so the moments are
taken over valid rows only, always in f32.

Where the rows are sharded over ranks (``parallel/sharded.py``), a process
group takes the place of JAX's ``axis_name``: the count, Σx and Σx² are
all-reduced over it in f32 (one differentiable all-reduce), so every rank
sees the statistics of the whole row set.

Each function runs inside a ``norm`` span (``utils/profiling.py``).
"""
from __future__ import annotations

import torch

from gnnome_tpu_torch.core.collectives import all_reduce_sum
from gnnome_tpu_torch.utils.profiling import span


def masked_moments(x: torch.Tensor, mask: torch.Tensor, group=None):
    """Per-feature mean and (biased) variance over rows where ``mask``,
    over the rows of every rank of ``group`` when one is given."""
    with span("norm"):
        x = x.to(torch.float32)
        m = mask.to(torch.float32)[:, None]
        count, s, ss = m.sum(), (x * m).sum(0), (x * x * m).sum(0)
        if group is not None:
            d = s.shape[0]
            count, s, ss = all_reduce_sum(torch.cat([count[None], s, ss]), group).split(
                [1, d, d])
            count = count[0]
        count = torch.clamp(count, min=1.0)
        mean = s / count
        var = ss / count - mean * mean
        return mean, torch.clamp(var, min=0.0)


def masked_batch_norm(x, mask, scale, bias, eps: float = 1e-5, group=None):
    """BatchNorm1d with per-batch statistics (track_running_stats=False);
    ``group``: the process group the rows are sharded over."""
    with span("norm"):
        mean, var = masked_moments(x, mask, group)
        out = (x.to(torch.float32) - mean) * torch.rsqrt(var + eps) * scale.to(torch.float32)
        return (out + bias.to(torch.float32)).to(x.dtype)


def masked_layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the feature axis (the ``batch_norm=False`` branch,
    ``layers/gated_gcn_full.py:57-59``). Row-wise, so padding is harmless."""
    with span("norm"):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * scale + bias
