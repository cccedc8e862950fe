"""Standalone node/edge encoders (counterpart of
``gnnome_tpu/models/encoders.py``).

Reference: ``layers/node_encoder.py:4-28`` and ``layers/edge_encoder.py:4-28``
— single-linear encoders that the reference's live model does not use
(``models/full_graph.py:14,16``); kept for API parity.
"""
from __future__ import annotations

from typing import Dict

import torch

from gnnome_tpu_torch.models.common import init_linear, linear


def init_node_encoder(gen: torch.Generator, in_features: int, out_features: int,
                      device="cuda") -> Dict:
    return init_linear(gen, in_features, out_features, device)


def node_encoder(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return linear(params, x)


def init_edge_encoder(gen: torch.Generator, in_features: int, out_features: int,
                      device="cuda") -> Dict:
    return init_linear(gen, in_features, out_features, device)


def edge_encoder(params: Dict, e: torch.Tensor) -> torch.Tensor:
    return linear(params, e)
