"""Reproducibility helpers (reference: ``utils.set_seed``, ``utils.py:14-34``)."""
from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 0) -> None:
    """Seed Python's, numpy's and torch's global generators (torch's on every
    device). The port's own draws take explicit generators and do not read
    these; this is for callers' code that does."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
