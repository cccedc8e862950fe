"""Positional encodings: k-step PageRank (default) and random-walk PE
(counterpart of ``gnnome_tpu/data/pe.py``).

Reference: ``utils.py:97-140``. With A[i,j]=1 for edge i→j and D the
out-degrees, P = (D^-1 A)^T; iterate x ← α·P·x + (1-α)/n and keep every
iterate as one PE channel. α = 0.95, k = nb_pos_enc. ``pagerank_pe_np`` is
host numpy, run once per graph at load time; ``pagerank_pe_torch`` is the
same iteration on the tensors' device, for graphs already there.
"""
from __future__ import annotations

import numpy as np
import torch

from gnnome_tpu_torch.core.graph import CSR, PAD_SEGMENT
from gnnome_tpu_torch.ops.segment_sum import segment_sum


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


def random_walk_pe_np(
    src: np.ndarray, dst: np.ndarray, n: int, k: int
) -> np.ndarray:
    """Random-walk diagonal PE (``utils.py:107-120``), kept for parity with
    the reference's unused 'RW' branch."""
    import scipy.sparse as sp

    a = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    in_deg = np.maximum(np.bincount(dst, minlength=n), 1).astype(np.float64)
    rw = a @ sp.diags(1.0 / in_deg)
    m_power = rw.copy()
    cols = [m_power.diagonal().astype(np.float32)]
    for _ in range(k - 1):
        m_power = m_power @ rw
        cols.append(m_power.diagonal().astype(np.float32))
    return np.stack(cols, axis=-1)


def _csr_by(key: torch.Tensor, edge_mask: torch.Tensor, n_pad: int) -> CSR:
    """A CSR over the edges keyed on ``key`` (any edge order): stably sorted,
    padded edges keyed ``PAD_SEGMENT`` and in no segment."""
    key = torch.where(edge_mask, key.to(torch.int32), PAD_SEGMENT).contiguous()
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    offsets = torch.searchsorted(
        sorted_key, torch.arange(n_pad + 1, dtype=torch.int32, device=key.device))
    return CSR(key=key, order=order.to(torch.int32), segment_ids=sorted_key,
               offsets=offsets.to(torch.int32))


def pagerank_pe_torch(
    src: torch.Tensor, dst: torch.Tensor, edge_mask: torch.Tensor, n_pad: int, k: int,
    n_real: int, alpha: float = 0.95
) -> torch.Tensor:
    """PageRank PE over a padded graph on the tensors' device (the numpy
    version's math in f32; ``pagerank_pe_jnp``). Both segment sums are the
    port's fixed-order CSR walk (``ops/segment_sum.py``), so two calls on
    the card give the same bits: no float atomics. f32[n_pad, k]."""
    by_src, by_dst = _csr_by(src, edge_mask, n_pad), _csr_by(dst, edge_mask, n_pad)
    valid = edge_mask.to(torch.float32)
    out_deg = segment_sum(valid[:, None].contiguous(), by_src)[:, 0]
    inv_out = torch.where(out_deg > 1e-9, 1.0 / (out_deg + 1e-9), 0.0)
    x = torch.full((n_pad,), 1.0 / n_real, dtype=torch.float32, device=src.device)
    src_ids = src.long()
    cols = []
    for _ in range(k):
        contrib = (x * inv_out)[src_ids] * valid
        x = alpha * segment_sum(contrib[:, None].contiguous(), by_dst)[:, 0] \
            + (1.0 - alpha) / n_real
        cols.append(x)
    return torch.stack(cols, dim=1)
