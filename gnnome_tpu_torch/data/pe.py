"""PageRank positional encoding (counterpart of ``gnnome_tpu/data/pe.py``).

Reference: ``utils.py:97-140``. With A[i,j]=1 for edge i→j and D the
out-degrees, P = (D^-1 A)^T; iterate x ← α·P·x + (1-α)/n and keep every
iterate as one PE channel. α = 0.95, k = nb_pos_enc. Host numpy, run once
per graph at load time.
"""
from __future__ import annotations

import numpy as np


def pagerank_pe_np(
    src: np.ndarray, dst: np.ndarray, n: int, k: int, alpha: float = 0.95
) -> np.ndarray:
    out_deg = np.bincount(src, minlength=n).astype(np.float64)
    inv_out = np.where(out_deg > 1e-9, 1.0 / (out_deg + 1e-9), 0.0)
    x = np.full(n, 1.0 / n)
    cols = []
    for _ in range(k):
        # x[i] ← α Σ_{j→i} x[j]/outdeg(j) + (1-α)/n
        contrib = x[src] * inv_out[src]
        x = alpha * np.bincount(dst, weights=contrib, minlength=n) + (1.0 - alpha) / n
        # the reference appends after each update (utils.py:134-136)
        cols.append(x.astype(np.float32))
    return np.stack(cols, axis=-1)
