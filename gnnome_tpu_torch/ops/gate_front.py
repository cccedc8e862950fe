"""GatedGCN gate front: endpoint gathers + the B3 edge projection + the
BatchNorm moments over real edges, in one pass.

Counterpart of ``gnnome_tpu/ops/spmm_pallas.py:gate_front_pallas``. The
CUDA kernel is ``csrc/gate_front.cu`` (the ``e·W3`` product runs inside
it); the plain version below is its CPU form and its reference on the card.
"""
from __future__ import annotations

import torch

from gnnome_tpu_torch.ops.cuda_lib import (
    I32, I64, P, Kernel, check_cuda_args, on_cpu, register)

GATE_FRONT = register(Kernel(
    "gate_front", "gnnome_gate_front_f32",
    [P, P, P, P, P, P, P, P, P, P, I64, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/gate_front.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:2669 gate_front_pallas"))

# blocks that walk the 64-edge row tiles (csrc/gate_front.cu); each leaves
# one partial moments row, summed in a fixed order by a second kernel
_ROW_TILE = 64
_MAX_PARTS = 1024


def gate_front_plain(b1h, b2h, e, w3, b3, src, dst, n_real: int):
    b3e = e @ w3 + b3
    gate = b1h[src] + b2h[dst] + b3e
    g = gate[:n_real].to(torch.float32)
    return gate, torch.stack([g.sum(0), (g * g).sum(0)])


def gate_front(b1h: torch.Tensor, b2h: torch.Tensor, e: torch.Tensor,
               w3: torch.Tensor, b3: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, n_real: int):
    """``(gate, mom)``: ``gate = b1h[src] + b2h[dst] + (e·W3 + b3)`` per
    edge ([E, D]) and ``mom = [Σ gate ‖ Σ gate²]`` over the first
    ``n_real`` edges (f32 [2, D]). ``src``/``dst`` must be valid node ids
    (padding clamped to 0, as ``AssemblyGraph`` stores them)."""
    if on_cpu(b1h, b2h, e, w3, b3, src, dst):
        return gate_front_plain(b1h, b2h, e, w3, b3, src, dst, n_real)
    check_cuda_args("gate_front", [b1h, b2h, e, w3, b3], [src, dst])
    n_rows, d = e.shape
    if w3.shape != (d, d) or b1h.shape[1] != d or b2h.shape[1] != d:
        raise ValueError("gate_front: width mismatch")
    n_parts = max(1, min(_MAX_PARTS, -(-n_rows // _ROW_TILE)))
    gate = torch.empty_like(e)
    partial = torch.empty((n_parts, 2, d), dtype=torch.float32, device=e.device)
    mom = torch.empty((2, d), dtype=torch.float32, device=e.device)
    GATE_FRONT(e.device, b1h.data_ptr(), b2h.data_ptr(), e.data_ptr(),
               w3.data_ptr(), b3.data_ptr(), src.data_ptr(), dst.data_ptr(),
               gate.data_ptr(), partial.data_ptr(), mom.data_ptr(),
               n_rows, n_real, d, n_parts)
    return gate, mom
