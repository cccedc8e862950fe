"""GatedGCN gate epilog fused with the forward (by-destination) σ-weighted
aggregation and its neighbour gather.

Counterpart of ``gnnome_tpu/ops/spmm_pallas.py:fused_gate_sigma_gather_pallas``.
The CUDA kernel is ``csrc/gate_epilog.cu``; the plain version below is its
CPU form and its reference on the card.
"""
from __future__ import annotations

import torch

from gnnome_tpu_torch.core.graph import CSR
from gnnome_tpu_torch.ops.cuda_lib import (
    I32, I64, P, Kernel, check_cuda_args, on_cpu, register, vec4_ok)

GATE_SIGMA_GATHER = register(Kernel(
    "gate_sigma_gather", "gnnome_gate_sigma_gather_f32",
    [P, P, P, P, P, P, P, P, I64, I64, I32, I32],
    source="gnnome_tpu_torch/csrc/gate_epilog.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:3020 fused_gate_sigma_gather_pallas"))


def gate_sigma_gather_plain(gate, e_in, values, affine, by_dst: CSR, src):
    n, d = values.shape
    pre = gate * affine[0] + affine[1]
    e_new = torch.relu(pre) + e_in
    sigma = torch.sigmoid(e_new)
    stacked = torch.cat([sigma * values[src], sigma], dim=-1)
    valid = by_dst.key < n
    sums = torch.zeros((n, 2 * d), dtype=torch.float32, device=values.device)
    sums.index_add_(0, by_dst.key[valid], stacked[valid])
    return sums, e_new


def gate_sigma_gather(gate: torch.Tensor, e_in: torch.Tensor,
                      values: torch.Tensor, affine: torch.Tensor,
                      by_dst: CSR, src: torch.Tensor):
    """``(sums, e_new)``: ``e_new = relu(gate·affine[0] + affine[1]) + e_in``
    per canonical edge, and per destination node
    ``sums = [Σ σ(e_new)·values[src] ‖ Σ σ(e_new)]`` (f32 [N, 2D]) over its
    in-edges; padded edges (key ``PAD_SEGMENT``) join no sum. ``by_dst``
    must be the canonical (identity) layout."""
    if not by_dst.identity:
        raise ValueError("gate_sigma_gather runs on the canonical (by_dst) layout")
    if on_cpu(gate, e_in, values, affine, by_dst.key, by_dst.offsets, src):
        return gate_sigma_gather_plain(gate, e_in, values, affine, by_dst, src)
    check_cuda_args("gate_sigma_gather", [gate, e_in, values, affine],
                    [by_dst.offsets, src])
    n, d = values.shape
    n_rows = gate.shape[0]
    if by_dst.offsets.shape[0] != n + 1 or gate.shape != e_in.shape \
            or gate.shape[1] != d or affine.shape != (2, d):
        raise ValueError("gate_sigma_gather: shape mismatch")
    sums = torch.empty((n, 2 * d), dtype=torch.float32, device=gate.device)
    e_new = torch.empty_like(e_in)
    vec4 = vec4_ok(d, gate, e_in, values, affine, sums, e_new)
    GATE_SIGMA_GATHER(gate.device, gate.data_ptr(), e_in.data_ptr(),
                      values.data_ptr(), affine.data_ptr(),
                      by_dst.offsets.data_ptr(), src.data_ptr(),
                      sums.data_ptr(), e_new.data_ptr(), n, n_rows, d, int(vec4))
    return sums, e_new
