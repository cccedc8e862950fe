"""GatedGCN gate front: endpoint gathers + the B3 edge projection + the
BatchNorm moments over real edges, in one pass. Both norm branches of the
layer take their gate from it; the LayerNorm's leaves the moments unread.

Counterpart of ``gnnome_tpu/ops/spmm_pallas.py:gate_front_pallas``. The
CUDA kernel is ``csrc/gate_front.cu``: the ``e·W3`` product runs inside it,
on the tensor cores as a 3-pass split-TF32 product with f32 accuracy, as
the TPU kernel runs it on the MXU at ``Precision.HIGHEST``. The plain
version below is its CPU form and its reference on the card. Under bf16
(``compute_dtype="bfloat16"``) its own entry runs the product as one bf16
tensor-core product with an f32 accumulator, and rounds where the TPU
kernel rounds (``gnnome_tpu/ops/spmm_pallas.py:2619-2655``): the product
to bf16, ``+ b3`` in bf16, the endpoint rows added in f32, the gate stored
in bf16, the moments taken of the stored gate in f32.
Its backward (:class:`GateFront`, the JAX ``_gate_front_bwd``) runs
``csrc/gate_front_bwd.cu`` (``gate_front_bwd_stream_pallas``) and the two
endpoint segment sums; the B3 gradients are matrix products.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gnnome_tpu_torch.core.graph import CSR
from gnnome_tpu_torch.ops.cuda_lib import (
    I32, I64, P, Kernel, check_cuda_args, entry, on_cpu, register, vec_ok)
from gnnome_tpu_torch.ops.dense import weight_grad
from gnnome_tpu_torch.ops.segment_sum import segment_sum

GATE_FRONT = register(Kernel(
    "gate_front", "gnnome_gate_front_f32",
    [P, P, P, P, P, P, P, P, P, P, P, I64, I64, I32, I32, I32],
    source="gnnome_tpu_torch/csrc/gate_front.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:2669 gate_front_pallas"))
GATE_FRONT_BF16 = register(Kernel(
    "gate_front_bf16", "gnnome_gate_front_bf16",
    [P, P, P, P, P, P, P, P, P, P, I64, I64, I32, I32, I32, I32],
    source="gnnome_tpu_torch/csrc/gate_front.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:2669 gate_front_pallas", dtype=torch.bfloat16))
GATE_FRONT_BWD = register(Kernel(
    "gate_front_bwd", "gnnome_gate_front_bwd_f32",
    [P, P, P, P, P, P, I64, I64, I32, I32, I32],
    source="gnnome_tpu_torch/csrc/gate_front_bwd.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:1031 gate_front_bwd_stream_pallas"))
GATE_FRONT_BWD_BF16 = register(Kernel(
    "gate_front_bwd_bf16", "gnnome_gate_front_bwd_bf16",
    [P, P, P, P, P, P, I64, I64, I32, I32, I32],
    source="gnnome_tpu_torch/csrc/gate_front_bwd.cu",
    replaces="gnnome_tpu/ops/spmm_pallas.py:1031 gate_front_bwd_stream_pallas",
    dtype=torch.bfloat16))

# csrc/gate_front.cu: one block per SM walks the 128-edge row tiles and
# leaves one partial moments row, summed in a fixed order by a second
# kernel; W3 is split into tf32 hi/lo parts, padded to 256-column blocks
# and K slices of 16 (an even count of them), in scratch the wrapper gives
_FRONT_ROW_TILE, _FRONT_COLS, _FRONT_K = 128, 256, 16
# the shared memory a block may take on the H100 (bytes)
SMEM_MAX = 232448


class GateFrontBf16Plan(NamedTuple):
    """How the bf16 entry of ``csrc/gate_front.cu`` runs for one call.

    ``bn`` > 0 runs ``bfh::gate_front_bf16_tma_kernel``: the e slices by TMA
    into a ring of ``stages``, wgmma products on a W3 column slice of ``bn``
    columns kept in shared memory for the whole walk. ``bn`` = 0 runs
    ``bf::gate_front_bf16_kernel``: any d, element by element, its W3 slice
    of 128 columns in K tiles above d = 512. ``grid`` is (row walkers,
    column blocks); the column blocks of a row tile walk at one pace, so
    the e slice one of them loads, the others find in the L2. The C entry
    takes the shared memory of its own layout and refuses a plan past
    :data:`SMEM_MAX`."""
    bn: int
    stages: int
    grid: Tuple[int, int]


# the TMA instance: 64-row tiles, K slices of 64 (one 128-byte swizzle row
# of bf16), a ring of 4 to 8 of them; BN from 256 down to 32
_TMA_ROWS, _TMA_K, _TMA_STAGES = 64, 64, (4, 8)
_TMA_BNS = (256, 128, 64, 32)
# the element-wise instance: 64-row tiles, 128-column blocks, two blocks an SM
_EW_ROWS, _EW_COLS = 64, 128


def tma_smem(d: int, bn: int, stages: int) -> int:
    """A block's shared memory in the TMA instance (``bfh::smem_bytes``):
    alignment slack, the ring and its two barriers a stage, the W3 slice
    [64·ceil(d/64), bn], two staging tiles [64, bn] and the consumers' two
    order barriers."""
    slice_bytes = _TMA_ROWS * _TMA_K * 2
    return (1024 + stages * (slice_bytes + 16) + -(-d // _TMA_K) * _TMA_K * bn * 2
            + 2 * _TMA_ROWS * bn * 2 + 16)


def gate_front_bf16_plan(d: int, n_rows: int, sms: int, vec: bool) -> GateFrontBf16Plan:
    """The bf16 gate front's launch plan, from the shape. ``vec``: d % 8 == 0
    and every row tensor's base 16-byte aligned, which TMA needs. Then the
    TMA instance takes the widest BN (at most d rounded up to a power of
    two, at least 32) whose W3 slice fits with a ring of 4 stages, and the
    deepest ring up to 8 that fits beside it, and one walker a column block
    per SM, at most one a row tile. Otherwise, or past the widest d BN = 32
    fits (d > 2944), the element-wise instance, two blocks an SM."""
    if vec and d % 8 == 0:
        lo, hi = _TMA_STAGES
        for bn in _TMA_BNS:
            if bn > 32 and bn // 2 >= d:
                continue
            fits = [s for s in range(lo, hi + 1) if tma_smem(d, bn, s) <= SMEM_MAX]
            if fits:
                n_cb = -(-d // bn)
                parts = max(1, min(sms // n_cb, -(-n_rows // _TMA_ROWS)))
                return GateFrontBf16Plan(bn, fits[-1], (parts, n_cb))
    n_cb = -(-d // _EW_COLS)
    parts = max(1, min(max(1, 2 * sms // n_cb), -(-n_rows // _EW_ROWS)))
    return GateFrontBf16Plan(0, 0, (parts, n_cb))


# csrc/gate_front_bwd.cu: blocks that walk its 64-edge row tiles
_ROW_TILE = 64
_MAX_PARTS = 1024


def gate_front_plain(b1h, b2h, e, w3, b3, src, dst, n_real: int):
    if e.dtype == torch.float32:
        b3e = e @ w3 + b3
        gate = b1h[src] + b2h[dst] + b3e
    else:
        # the product of bf16 values summed in f32 and rounded once, then
        # the TPU kernel's cast points
        f32 = torch.float32
        proj = (e.to(f32) @ w3.to(f32)).to(e.dtype)
        pb = (proj.to(f32) + b3.to(f32)).to(e.dtype)
        gate = ((pb.to(f32) + b1h[src].to(f32)) + b2h[dst].to(f32)).to(e.dtype)
    g = gate[:n_real].to(torch.float32)
    return gate, torch.stack([g.sum(0), (g * g).sum(0)])


def gate_front(b1h: torch.Tensor, b2h: torch.Tensor, e: torch.Tensor,
               w3: torch.Tensor, b3: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, n_real: int):
    """``(gate, mom)``: ``gate = b1h[src] + b2h[dst] + (e·W3 + b3)`` per
    edge ([E, D]) and ``mom = [Σ gate ‖ Σ gate²]`` over the first
    ``n_real`` edges (f32 [2, D]). ``src``/``dst`` must be valid node ids
    (padding clamped to 0, as ``AssemblyGraph`` stores them). float32 or
    bfloat16 data (one dtype for all five); ``mom`` is f32 either way."""
    if on_cpu(b1h, b2h, e, w3, b3, src, dst):
        return gate_front_plain(b1h, b2h, e, w3, b3, src, dst, n_real)
    kernel = entry(e.dtype, GATE_FRONT, GATE_FRONT_BF16)
    check_cuda_args(kernel.name, [b1h, b2h, e, w3, b3], [src, dst], dtype=kernel.dtype)
    n_rows, d = e.shape
    if w3.shape != (d, d) or b1h.shape[1] != d or b2h.shape[1] != d:
        raise ValueError("gate_front: width mismatch")
    sms = torch.cuda.get_device_properties(e.device).multi_processor_count
    if kernel is GATE_FRONT_BF16:
        return _gate_front_bf16(b1h, b2h, e, w3, b3, src, dst, n_real, sms)
    n_parts = max(1, min(sms, -(-n_rows // _FRONT_ROW_TILE)))
    n_ks = 2 * -(-d // (2 * _FRONT_K))
    n_cb = -(-d // _FRONT_COLS)
    gate = torch.empty_like(e)
    partial = torch.empty((n_parts, 2, d), dtype=torch.float32, device=e.device)
    mom = torch.empty((2, d), dtype=torch.float32, device=e.device)
    w3_split = torch.empty((2, n_cb * n_ks * _FRONT_K * _FRONT_COLS), dtype=torch.float32,
                           device=e.device)
    GATE_FRONT(e.device, b1h.data_ptr(), b2h.data_ptr(), e.data_ptr(),
               w3.data_ptr(), b3.data_ptr(), src.data_ptr(), dst.data_ptr(),
               gate.data_ptr(), partial.data_ptr(), mom.data_ptr(), w3_split.data_ptr(),
               n_rows, n_real, d, n_parts, int(vec_ok(d, b1h, b2h, e, b3, gate)))
    return gate, mom


def _gate_front_bf16(b1h, b2h, e, w3, b3, src, dst, n_real: int, sms: int):
    n_rows, d = e.shape
    gate = torch.empty_like(e)
    plan = gate_front_bf16_plan(d, n_rows, sms, vec_ok(d, b1h, b2h, e, w3, b3, gate))
    n_parts = plan.grid[0]
    partial = torch.empty((n_parts, 2, d), dtype=torch.float32, device=e.device)
    mom = torch.empty((2, d), dtype=torch.float32, device=e.device)
    GATE_FRONT_BF16(e.device, b1h.data_ptr(), b2h.data_ptr(), e.data_ptr(), w3.data_ptr(),
                    b3.data_ptr(), src.data_ptr(), dst.data_ptr(), gate.data_ptr(),
                    partial.data_ptr(), mom.data_ptr(), n_rows, n_real, d, n_parts,
                    plan.bn, plan.stages)
    return gate, mom


def gate_front_bwd_plain(d_gate, gate, d_mom, n_real: int):
    real = (torch.arange(gate.shape[0], device=gate.device) < n_real)[:, None]
    f32 = torch.float32
    d_total = d_gate.to(f32) + torch.where(real, d_mom[0] + 2.0 * gate.to(f32) * d_mom[1],
                                           0.0)
    return d_total.to(gate.dtype), d_total.sum(0)


def gate_front_bwd(d_gate: torch.Tensor, gate: torch.Tensor, d_mom: torch.Tensor,
                   n_real: int):
    """``(d_total, d_bias3)``: the gate's total cotangent
    ``d_gate + [k < n_real]·(d_mom[0] + 2·gate·d_mom[1])`` ([E, D]) and its
    f32 column sum over all rows ([D]). For bfloat16 ``d_gate`` and ``gate``
    (``d_mom`` is f32), ``d_total`` is computed in f32 and stored rounded,
    and ``d_bias3`` sums the unrounded values, as the JAX VJP does."""
    if on_cpu(d_gate, gate, d_mom):
        return gate_front_bwd_plain(d_gate, gate, d_mom, n_real)
    kernel = entry(gate.dtype, GATE_FRONT_BWD, GATE_FRONT_BWD_BF16)
    if kernel is GATE_FRONT_BWD:
        check_cuda_args(kernel.name, [d_gate, gate, d_mom], [])
    else:
        check_cuda_args(kernel.name, [d_gate, gate], [], dtype=kernel.dtype, f32=[d_mom])
    n_rows, d = gate.shape
    if d_gate.shape != gate.shape or d_mom.shape != (2, d):
        raise ValueError("gate_front_bwd: shape mismatch")
    n_parts = max(1, min(_MAX_PARTS, -(-n_rows // _ROW_TILE)))
    d_total = torch.empty_like(gate)
    partial = torch.empty((n_parts, d), dtype=torch.float32, device=gate.device)
    d_bias3 = torch.empty((d,), dtype=torch.float32, device=gate.device)
    kernel(gate.device, d_gate.data_ptr(), gate.data_ptr(), d_mom.data_ptr(),
           d_total.data_ptr(), partial.data_ptr(), d_bias3.data_ptr(),
           n_rows, n_real, d, n_parts, int(vec_ok(d, d_gate, gate, d_mom, d_total)))
    return d_total, d_bias3


class GateFront(torch.autograd.Function):
    """:func:`gate_front` with the gradient of the JAX ``fused_gate_front``
    (``gnnome_tpu/ops/segment.py:939-993``): ``d_b1h`` / ``d_b2h`` are the
    by_src / by_dst segment sums of ``d_total``, ``d_e = d_total·W3ᵀ``,
    ``d_W3 = eᵀ·d_total``, ``d_bias3 = Σ d_total``. Saves ``(gate, e, w3)``,
    as ``_gate_front_fwd`` does. Under bf16 the f32 sums (the segment sums,
    ``d_bias3``) are returned rounded to their inputs' dtype, as the JAX VJP
    returns them, ``d_e`` is a bf16 product and ``d_W3`` an f32-result
    product rounded once (``ops/dense.py``), as JAX takes them.

    ``moments=False`` (the LayerNorm layer, which reads only ``gate``):
    ``mom`` is still returned but takes no gradient, so ``d_total`` is
    ``d_gate`` itself and ``d_bias3`` its f32 column sum; the gate is not
    saved and :func:`gate_front_bwd` does not run."""

    @staticmethod
    def forward(ctx, b1h, b2h, e, w3, b3, src, dst, n_real: int,
                by_src: CSR, by_dst: CSR, moments: bool = True):
        gate, mom = gate_front(b1h, b2h, e, w3, b3, src, dst, n_real)
        if moments:
            ctx.save_for_backward(gate, e, w3)
        else:
            ctx.save_for_backward(e, w3)
            ctx.mark_non_differentiable(mom)
            ctx.set_materialize_grads(False)
        ctx.moments, ctx.n_real, ctx.by_src, ctx.by_dst = moments, n_real, by_src, by_dst
        ctx.dtypes = b1h.dtype, b2h.dtype, b3.dtype
        return gate, mom

    @staticmethod
    def backward(ctx, d_gate, d_mom):
        if ctx.moments:
            gate, e, w3 = ctx.saved_tensors
            d_total, d_bias3 = gate_front_bwd(d_gate.contiguous(), gate,
                                              d_mom.contiguous(), ctx.n_real)
        else:
            e, w3 = ctx.saved_tensors
            d_total = d_gate.contiguous()
            d_bias3 = d_total.sum(0, dtype=torch.float32)
        need = ctx.needs_input_grad
        t1, t2, t3 = ctx.dtypes
        d_b1h = segment_sum(d_total, ctx.by_src).to(t1) if need[0] else None
        d_b2h = segment_sum(d_total, ctx.by_dst).to(t2) if need[1] else None
        d_e = d_total @ w3.T if need[2] else None
        d_w3 = weight_grad(e, d_total) if need[3] else None
        return (d_b1h, d_b2h, d_e, d_w3, d_bias3.to(t3), None, None, None, None, None,
                None)
