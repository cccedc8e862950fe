"""Masked normalization layers (counterpart of ``gnnome_tpu/ops/norm.py``).

The reference uses ``nn.BatchNorm1d(..., track_running_stats=False)``
(``layers/gated_gcn_full.py:55-56``): statistics come from the current
batch in train and eval mode alike. Rows may be padded, so the moments are
taken over valid rows only, always in f32.
"""
from __future__ import annotations

import torch


def masked_moments(x: torch.Tensor, mask: torch.Tensor):
    """Per-feature mean and (biased) variance over rows where ``mask``."""
    x = x.to(torch.float32)
    m = mask.to(torch.float32)[:, None]
    count = torch.clamp(m.sum(), min=1.0)
    mean = (x * m).sum(0) / count
    var = (x * x * m).sum(0) / count - mean * mean
    return mean, torch.clamp(var, min=0.0)


def masked_batch_norm(x, mask, scale, bias, eps: float = 1e-5):
    """BatchNorm1d with per-batch statistics (track_running_stats=False)."""
    mean, var = masked_moments(x, mask)
    out = (x.to(torch.float32) - mean) * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return (out + bias.to(torch.float32)).to(x.dtype)


def masked_layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the feature axis (the ``batch_norm=False`` branch,
    ``layers/gated_gcn_full.py:57-59``). Row-wise, so padding is harmless."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias
