"""Parameter initialization and small dense helpers.

Counterpart of ``gnnome_tpu/models/common.py``: ``torch.nn.Linear``-style
initialization (Kaiming-uniform weights, uniform bias in ±1/sqrt(fan_in)).
Parameters are plain dictionaries of tensors with the JAX package's tree
layout (``w`` is ``[fan_in, fan_out]``), so checkpoints map key for key.
Draws come from an explicit CPU ``torch.Generator`` and are then moved to
the target device, so a seed gives the same weights on every device.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from gnnome_tpu_torch.ops.dense import matmul


def init_linear(gen: torch.Generator, fan_in: int, fan_out: int,
                device="cuda", dtype=torch.float32) -> Dict[str, torch.Tensor]:
    bound = 1.0 / math.sqrt(fan_in)
    w = (torch.rand((fan_in, fan_out), generator=gen, dtype=dtype) * 2 - 1) \
        * (math.sqrt(3) * bound)
    b = (torch.rand((fan_out,), generator=gen, dtype=dtype) * 2 - 1) * bound
    return {"w": w.to(device), "b": b.to(device)}


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``; under bf16 ``d_w`` keeps an f32 result
    (``ops/dense.py``)."""
    return matmul(x, p["w"]) + p["b"]


def init_norm(dim: int, device="cuda", dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}
