#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gnnome_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printed as it starts (flush=True, so a cut run shows where it
stopped); any failure raises and exits non-zero:

1. build   — compile ``gnnome_tpu_torch/csrc/*.cu`` with nvcc (sm_90a) into
             ``gnnome_tpu_torch/_build/`` (cached by source hash), and beside
             it the native host library (``make -C native``: partitioner,
             overlap-graph builder, read simulator) that the later phases
             use as the JAX package would.
2. parity  — each kernel entry against its plain PyTorch version on the
             card, at the shapes the main paths give it, with a stated
             tolerance; kernel, plain and (where one exists) library-call
             times with CUDA events. Run on two chr19-size synthetic graphs
             (150k nodes, ~1M edges): the bench graph, whose skip edges all
             land within 22 node ids (rows gathered near each other), and
             the same graph with 11.93% of its edges rewired to random loci,
             the cross-locus share of real graphs. The row gather is held at
             the score head's 64, the ``"src"`` wide path's dst gather at
             D = 256 and the wide-gather width 2D = 512; the segment sums
             at D and 2D.
             Every entry runs again on the shape of the ClusterGCN piece
             with the most padding in phase 7 (14,336 / 91,136 rows, 26,638
             of them padded edges), and the seven entries that walk fixed
             tiles of edges (rows 8, 9, 13 and the backwards of 10 and 11)
             on the local graph with a hub row of 10,000 in- and 10,000
             out-edges; each walk's outputs (d_affine among them) alike bit
             for bit in two calls. The LayerNorm row kernel
             (``csrc/layer_norm.cu``, forward and backward) runs at the
             LayerNorm model's edge and node shapes beside its plain
             version and ``torch.nn.functional.layer_norm`` + relu + add;
             the BatchNorm entries (``csrc/batch_norm.cu``: the moments,
             the apply pass, the backward's column sums and dx) at the
             node norm's [N, 256] in f32 here and in bf16 in phase 10,
             beside their plain versions and, for the forward,
             ``torch.nn.functional.batch_norm(training=True)`` + relu + add.
3. scoring — the serving path: ``score_graph`` of the 16-layer, D=256
             GatedGCN on both graphs, with the shipped BatchNorm weights
             (``pretrained/model_hardfull40.npz``) and with seeded random
             weights of the ``batch_norm=False`` (LayerNorm) model; every
             launch counter is reset just before and read just after each
             forward, each forward kernel must have run, and a second
             forward must give the same logits bit for bit (every sum is a
             fixed-order walk); torch.profiler then breaks the forward down
             by kernel group.
4. training — the training paths at full scale: ``train_step`` (forward,
             BCE with pos_weight 0.5, backward, Adam at lr 1e-3) of the
             16-layer, D=256 model from seeded random weights on the local
             graph with ``bench_labels``: the BatchNorm model under
             ``remat="layer"`` and ``remat="none"``, and under
             ``remat="layer"`` the LayerNorm model, the BatchNorm model with
             ``wide_gathers=True`` and the LayerNorm model with it (the only
             path through the by_dst pregathered σ-aggregate). Each: launch
             counts of one step against the stated counts, the median of 3
             steps after a warm-up, peak memory, a torch.profiler breakdown
             and a finite loss on every step.
5. end to end — ``inference()`` from simulated reads to contigs on a 60 kb
             genome with a planted repeat (graph by the native builder);
             its edge probabilities are held against the port's CPU path
             (the plain versions) on that graph.
6. gradients and the loop — on that genome, the 16-layer, D=256 model's
             parameter gradients on the card against the port's CPU path
             (per leaf, relative norm) for the BatchNorm, LayerNorm,
             ``wide_gathers=True``, ``wide_gathers="src"`` and LayerNorm +
             wide models, with their launch counts, then ``train()`` for 2
             epochs and a resume to 4, for the BatchNorm and the LayerNorm
             model.
7. ClusterGCN — the default ``Config`` (16 layers, D=256, 500 parts in
             batches of 50, jitter 100, ``remat="layer"``) on the local bench
             graph: two training epochs and one cluster-validation pass of
             ``_epoch_pass`` with the port's samplers on the native
             partitioner; per epoch the drawn part count, edge cut, pieces
             and their sizes, sampler host seconds, piece-step ms (CUDA
             events), wall seconds; the second epoch under torch.profiler
             (idle share, device ms, launches and ms per launch of every
             kernel entry, the slowest piece step over the median);
             launches of one piece step against the stated counts; peak
             memory.
8. ClusterGCN on the genome — the sampler's pieces equal on the card and
             the CPU, one piece's gradients card vs CPU, ``train()`` under a
             ClusterGCN config with a resume.
9. pipeline — ``example.synthetic_example`` on the card (native simulator
             and builder, 15 epochs of an 8-layer, 128-wide model, then
             ``predict``): an assembly with contigs.
10. bf16 — ``compute_dtype="bfloat16"``: the seventeen bf16 entries
             (rows 1-9, then rows 10 and 11 and their backwards) against
             their plain versions on bf16 inputs at the main paths' shapes
             (the local graph, D = 256, the score head's gathers at 64) and
             on the most padded piece's shape, bf16 outputs to one bf16 ulp
             and f32 outputs to 1e-5 (the gate front to the bound its
             product's rounding allows, its moments to those of its own
             bf16 gate), every edge walk alike bit for bit in two calls;
             16-layer scoring of the BatchNorm model with the shipped
             weights through ``eval_step`` and of the seeded LayerNorm
             model (launches of bf16 entries only, ms, peak, two forwards
             bit for bit alike, the probabilities against the f32 forward);
             the full-scale bf16 training steps of phase 4's five paths
             (BatchNorm under ``"layer"`` and ``"none"``, LayerNorm, wide,
             LayerNorm + wide under ``"layer"``: launches of bf16 entries
             only, ms, edges/s, peak, idle share, the four losses beside
             phase 4's f32 losses); the bf16 gate front at D = 640 (five
             column blocks of 128, each W3 slice resident) against its
             plain version, timed beside its bound, and a bf16
             BatchNorm step of a 4-layer, D = 640 model; one ClusterGCN
             training epoch under the default ``Config`` in bf16 (ms per
             piece step).

11. decode — ``greedy.get_contigs`` at chromosome scale: the distinct
             edges of both bench graphs (local and cross-locus) with
             seeded read and prefix lengths, scored by the shipped weights
             in f32; the host ``"batched"`` engine and the ``"device"``
             engine (``csrc/walk.cu``, one launch per leg) with the
             default ``DecodeConfig`` (50 paths), their seconds, the walk
             kernel's ms (CUDA events) and its steps per µs against one
             dependent global read a step (a one-thread pointer chase),
             contigs and the longest walk; the two engines' contigs must be
             equal, walk for walk. Before that the kernel against
             ``walk_batch_plain`` on the card (walks, lengths, base counts
             and visited rows equal) on phase 5's genome graph and on a
             bench graph with 40-neighbour hubs (K > 32), and
             ``pagerank_pe_torch`` twice alike bit for bit.
12. sharded — the sharded step (``parallel/sharded.py``) through
             ``initialize_distributed``, ``make_mesh``, ``prepare_batch``,
             ``shard_batch`` and ``make_sharded_train_step``: (a) P = 1 over
             NCCL on the local graph padded as the sharded batch pads it,
             the 16-layer, D=256 BatchNorm model under ``remat="layer"`` in
             f32 and bf16, its loss and gradients against ``train_step``'s
             on the same graph and weights (bit for bit: the same route),
             launches, the median ms of 3 steps beside ``train_step``'s,
             peak memory; (b) P = 2 ranks on this one card over gloo (NCCL
             refuses two ranks on one device), each a process of this
             script (``--sharded-worker``) that builds its graphs from the
             seed, on the cross-locus and the local graph, the 16-layer
             BatchNorm and a 4-layer LayerNorm model in f32: P·H, the halo
             rows and ``halo_comm_bytes``, the loss and rank 0's gradients
             against the single card's step (worst and median leaf, each
             graph to its own limits),
             both ranks' parameters alike bit for bit after the step, two
             forwards alike bit for bit, rank 0's launches of one step, the
             median ms of 3 steps (two ranks share one card and gloo stages
             the halo through the host: not a scaling number).

The line before last is the kernel table as JSON, the bf16 entries after
the f32 ones, the walk kernel last (``launches``: one training step, under ``remat="layer"``,
of the first of the BatchNorm, LayerNorm, wide and LayerNorm + wide steps,
in f32 and then in bf16, that runs the kernel; every
count in ``launches_by_path``, the ClusterGCN piece step, phases 7
and 9 as a whole and phase 12's sharded steps (``sharded_*``) among
them; rows 12-13 are not on a model path, and say so; the walk kernel's: both decodes of phase 11, and it is not a TPU
kernel), the one before that the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the package beside it, the script prints
no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "pretrained" / "model_hardfull40.npz"
WORK = ROOT / "runs" / "chip_smoke"  # git-ignored

N_NODES, N_EDGES = 150_000, 1_000_000  # chr19-size graph (PERFORMANCE.md:565)
# share of real edges joining loci > 100 kb apart (PERFORMANCE.md:18);
# bench_edges rewires a share of its ~N_EDGES - N_NODES skip edges
CROSS_LOCUS = 0.1193
FRAC_LONG = CROSS_LOCUS * N_EDGES / (N_EDGES - N_NODES)
LOCAL_REACH = 22  # the farthest a bench skip edge reaches (2 * 11)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
TF32_TC_OPS_PER_S = 495e12  # H100 SXM, TF32 on the tensor cores (dense)
BF16_TC_OPS_PER_S = 989e12  # H100 SXM, bf16 on the tensor cores (dense)
KERNEL_TOL = 1e-5  # rtol = atol; the kernels sum in f32 in another order
# bf16 outputs of the bf16 entries: one bf16 ulp of the larger magnitude
# plus this atol. Kernel and plain version round the same f32 value, which
# differs by a few f32 ulps (sum order, a fused multiply-add), so it can
# fall on either side of a rounding boundary; their f32 outputs (sums,
# moments, d_affine, d_bias3) are held to KERNEL_TOL as in f32.
BF16_ATOL = 1e-5
# edge probabilities, CUDA path vs CPU path (atol; the inference parity of
# tests/test_torch_inference.py). Logits are not held tighter than the JAX package agrees with the
# port on the CPU: on the e2e graph with the shipped 16-layer model the two
# differ by up to 4.1e-4 in a logit from f32 summation order alone.
PROB_TOL = 1e-4
# parameter gradients of the 16-layer, D=256 model on the 60 kb genome,
# card vs CPU, per leaf as ||g - g_cpu|| / ||g_cpu||: the bound that
# tests/test_torch_train.py::test_deep_model_grads_on_genome_match_jax holds
# the port's CPU path to against JAX on the same graph (measured 1.7e-2:
# the first layer's BatchNorm sees near-constant features there and
# amplifies f32 rounding). Leaves whose CPU gradient is below 1e-6 of the
# whole gradient's norm are rounding noise (the biases feeding a BatchNorm,
# whose exact gradient is zero) and are held to 1e-5 of that norm instead.
GRAD_TOL = 5e-2
NOISE = 1e-6
LAYERS, SCORE_HEAD_GATHERS = 16, 2
LR, POS_WEIGHT = 1e-3, 0.5  # bench.py's step
VARIANTS = {  # name: (batch_norm, wide_gathers)
    "batchnorm": (True, False), "layernorm": (False, False), "wide": (True, True),
    "wide_src": (True, "src"), "layernorm_wide": (False, True)}
# full-scale training steps, in the order the kernel table takes its counts
TRAIN_RUNS = (("batchnorm", "layer"), ("batchnorm", "none"), ("layernorm", "layer"),
              ("wide", "layer"), ("layernorm_wide", "layer"))


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = 10, warmup: int = 2, min_ms: float = 20.0) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after ``warmup``, with CUDA
    events; a run shorter than ``min_ms`` (a small kernel, whose first
    launches after host work find the clocks low) is warmed up and timed
    again over enough calls to last ``min_ms``."""
    def run(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    run(warmup)
    ms = run(iters)
    if ms * iters < min_ms:
        n = int(min_ms / max(ms, 1e-3)) + 1
        run(n)
        ms = run(n)
    return ms


def bound(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or operations
    over the peak rate of the units that run them, the larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name: str, torch, got, ref, rtol: float, atol: float) -> float:
    err = (got - ref).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    bad = int((err > atol + rtol * ref.abs()).sum())
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {bad} elements outside rtol={rtol} "
                             f"atol={atol} (max abs err {max_err:.3e})")
    return max_err


def card_name_and_power() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def measure(torch, kernel, max_err, tol, fn, plain, library, n_bytes, n_ops, what="",
            ops_per_s=FP32_OPS_PER_S) -> dict:
    """Kernel, plain-version and library-call ms (CUDA events) beside the
    bound of the work, printed and returned."""
    ms = time_ms(torch, fn)
    plain_ms = time_ms(torch, plain)
    library_ms = time_ms(torch, library) if library else None
    b_ms, b_by = bound(n_bytes, n_ops, ops_per_s)
    log(f"  {kernel.name}{what}: max_abs_err={max_err:.3e} ({tol}) "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
        f"{'null' if library_ms is None else f'{library_ms:.4f}'} "
        f"bound_ms={b_ms:.4f} ({b_by})")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def bf16_ulp(torch, x):
    """The spacing of bf16 at |x| (8 significant bits), as f32."""
    return torch.exp2(torch.floor(torch.log2(x.abs().float().clamp_min(2.0 ** -126))) - 7)


def check_bf16(name: str, torch, got, ref, atol: float = BF16_ATOL) -> float:
    """A bf16 output against its plain version: one bf16 ulp plus atol."""
    if got.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: dtypes {got.dtype}, {ref.dtype}; bf16 expected")
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    bad = int((err > bf16_ulp(torch, torch.maximum(g.abs(), r.abs())) + atol).sum())
    if bad or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: {bad} elements beyond one bf16 ulp + {atol} "
                             f"(max abs err {float(err.max()):.3e})")
    return float(err.max())


def check_gate_front_bf16(torch, got, ref, args) -> float:
    """The bf16 gate front against its plain version. The product e·W3 is
    summed in f32 in another order (tensor cores against cuBLAS in f32) and
    rounded to bf16: where its rounding flips (at most 1% of the elements),
    proj + b3 and the gate may move by one ulp each, so the gate is held to
    one ulp of proj, of proj + b3 and of itself. The moments are held to
    KERNEL_TOL of the f32 moments of the kernel's own bf16 gate (the TPU
    kernel takes them of the rounded gate), and to the plain version's
    within what the gates' differences allow."""
    (gate, mom), (ref_gate, ref_mom) = got, ref
    _, _, e, w3, b3, _, _, n_real = args
    g, r = gate.float(), ref_gate.float()
    err = (g - r).abs()
    proj = e.float() @ w3.float()
    pb = proj.to(torch.bfloat16).float() + b3.float()
    allowed = bf16_ulp(torch, proj) + bf16_ulp(torch, pb) + \
        bf16_ulp(torch, torch.maximum(g.abs(), r.abs()))
    del proj, pb
    flips = float((err > 0).float().mean())
    bad = int((err > allowed).sum())
    if bad or flips > 1e-2 or not torch.isfinite(g).all():
        raise AssertionError(f"gate_front_bf16.gate: {bad} elements beyond the bound, "
                             f"{flips:.2%} differ (max abs err {float(err.max()):.3e})")
    real = g[:n_real].double()
    own = torch.stack([real.sum(0), (real * real).sum(0)]).float()
    err_mom = check_close("gate_front_bf16.mom/E (own gate)", torch, mom / n_real,
                          own / n_real, KERNEL_TOL, KERNEL_TOL)
    dg = err[:n_real].double()
    slack = torch.stack([dg.sum(0), (dg * 2 * (g[:n_real].abs() + err[:n_real])).sum(0)])
    if bool(((mom - ref_mom).abs() > slack + KERNEL_TOL * (1 + ref_mom.abs())).any()):
        raise AssertionError("gate_front_bf16.mom: the kernel's and the plain version's "
                             "moments differ beyond what their gates' differences allow")
    return max(float(err.max()), err_mom)


def phase_parity_bf16(torch, graph, seed: int) -> list[dict]:
    """The bf16 entries against their plain versions at the model's shapes
    (D = 256, the score head's gathers at 64), on bf16 inputs: rows 1-9
    (the BatchNorm narrow path), then rows 10 and 11 and their backwards
    (the LayerNorm and wide paths); every edge walk also alike bit for bit
    in two calls. Bounds count 2 bytes a bf16 element, 4 an f32 one or an
    id."""
    from gnnome_tpu_torch.ops.gate_epilog import (
        EPILOG_BWD_BF16, EPILOG_BWD_PREGATHERED_BF16, GATE_SIGMA_AGGREGATE_BF16,
        GATE_SIGMA_GATHER_BF16, epilog_bwd, epilog_bwd_plain, gate_sigma_gather,
        gate_sigma_gather_plain)
    from gnnome_tpu_torch.ops.sigma_aggregate import (
        SIGMA_AGGREGATE_BF16, SIGMA_AGGREGATE_BWD_BF16, SIGMA_AGGREGATE_BWD_BY_SRC_BF16,
        SIGMA_AGGREGATE_BWD_GATHER_BF16, SIGMA_AGGREGATE_BY_SRC_BF16,
        SIGMA_AGGREGATE_GATHER_BF16, sigma_aggregate, sigma_aggregate_bwd,
        sigma_aggregate_bwd_plain, sigma_aggregate_plain)
    from gnnome_tpu_torch.ops.gate_front import (
        GATE_FRONT_BF16, GATE_FRONT_BWD_BF16, gate_front, gate_front_bwd, gate_front_bwd_plain,
        gate_front_plain)
    from gnnome_tpu_torch.ops.reverse_sum import (
        REV_BWD_BF16, SIGMA_REVERSE_SUM_BF16, rev_bwd, rev_bwd_plain, sigma_reverse_sum,
        sigma_reverse_sum_plain)
    from gnnome_tpu_torch.ops.segment_sum import (
        SEGMENT_SUM_BY_DST_BF16, SEGMENT_SUM_BY_SRC_BF16, segment_sum, segment_sum_plain)
    from gnnome_tpu_torch.ops.take import TAKE_ROWS_BF16, take_rows, take_rows_plain

    dev, bf = graph.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, e, d, d_score = graph.n_nodes_padded, graph.n_edges_padded, 256, 64
    er = graph.n_edges
    u_src = int(torch.unique(graph.src[:er]).numel())
    u_dst = int(torch.unique(graph.dst[:er]).numel())
    ulp_tol = f"tol one bf16 ulp + {BF16_ATOL}"
    f32_tol = f"tol rtol=atol={KERNEL_TOL}"
    rows_out = []

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(kernel, err, tol, *args, key=None, **kw):
        m = measure(torch, kernel, err, tol, *args, **kw)
        if key is None:
            rows_out.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                                 replaces=kernel.replaces, launches=0, **m))
        else:
            rows_out[-1][key] = m

    # 4: the score head's two gathers at 64, and a [N, D] table
    for key, width in ((None, d_score), ("at_d", d)):
        table = randn(n, width)
        err = check_close(f"take_rows_bf16[{width}]", torch, take_rows(table, graph.src).float(),
                          take_rows_plain(table, graph.src).float(), 0.0, 0.0)
        record(TAKE_ROWS_BF16, err, "exact", lambda: take_rows(table, graph.src),
               lambda: take_rows_plain(table, graph.src),
               lambda: table.index_select(0, graph.src),
               u_src * width * 2 + e * 4 + e * width * 2, 0, key=key,
               what="" if key is None else f" [N, {width}]")
    del table

    # 1: gate front (the product on the tensor cores in bf16)
    args = (randn(n, d), randn(n, d), randn(e, d), randn(d, d, scale=d ** -0.5), randn(d),
            graph.src, graph.dst, er)
    got, ref = gate_front(*args), gate_front_plain(*args)
    err = check_gate_front_bf16(torch, got, ref, args)
    record(GATE_FRONT_BF16, err, "tol see check_gate_front_bf16", lambda: gate_front(*args),
           lambda: gate_front_plain(*args), None,
           (2 * e * d + (u_src + u_dst) * d + d * d + d) * 2 + 2 * d * 4 + 2 * e * 4,
           2 * e * d * d, ops_per_s=BF16_TC_OPS_PER_S)
    # cuBLAS's bf16 e·W3 + b3 alone, which the port never calls for this row
    addmm_ms = time_ms(torch, lambda: torch.addmm(args[4], args[2], args[3]))
    rows_out[-1]["addmm_bf16_ms"] = addmm_ms
    log(f"  note: torch.addmm(b3, e, W3) in bf16 (cuBLAS, the product alone) {addmm_ms:.4f} ms")
    gate, e_in = got[0], args[2]
    del got, ref, args

    # 2: gate epilog + forward aggregation (f32 affine and sums)
    values = randn(n, d)
    affine = torch.stack([torch.rand(d, generator=gen, device=dev) + 0.5,
                          torch.randn(d, generator=gen, device=dev)])
    args = (gate, e_in, values, affine, graph.by_dst, graph.src)
    (sums, e_new), (ref_sums, ref_e_new) = gate_sigma_gather(*args), gate_sigma_gather_plain(*args)
    err = max(check_close("gate_sigma_gather_bf16.sums", torch, sums, ref_sums, KERNEL_TOL,
                          KERNEL_TOL),
              check_bf16("gate_sigma_gather_bf16.e_new", torch, e_new, ref_e_new))
    record(GATE_SIGMA_GATHER_BF16, err, f"{ulp_tol} on e_new, {f32_tol} on sums",
           lambda: gate_sigma_gather(*args), lambda: gate_sigma_gather_plain(*args), None,
           (3 * e * d + u_src * d) * 2 + (2 * d + 2 * n * d) * 4 + (n + 1 + e) * 4, 8 * e * d)
    del sums, ref_sums, ref_e_new, args, gate, e_in

    # 3: reverse aggregation
    args = (e_new, values, graph.by_src, graph.dst)
    err = check_close("sigma_reverse_sum_bf16", torch, sigma_reverse_sum(*args),
                      sigma_reverse_sum_plain(*args), KERNEL_TOL, KERNEL_TOL)
    record(SIGMA_REVERSE_SUM_BF16, err, f32_tol, lambda: sigma_reverse_sum(*args),
           lambda: sigma_reverse_sum_plain(*args), None,
           (er * d + u_dst * d) * 2 + 2 * n * d * 4 + (2 * er + n + 1) * 4, 5 * e * d)

    # 5, 6: segment sums of bf16 rows into f32 (library: index_add_ on bf16)
    data = randn(e, d)
    for kernel, csr in ((SEGMENT_SUM_BY_DST_BF16, graph.by_dst),
                        (SEGMENT_SUM_BY_SRC_BF16, graph.by_src)):
        key, real = csr.key[:er].long(), data[:er]  # padded edges are last
        err = check_close(kernel.name, torch, segment_sum(data, csr), segment_sum_plain(data, csr),
                          KERNEL_TOL, KERNEL_TOL)
        record(kernel, err, f32_tol, lambda: segment_sum(data, csr),
               lambda: segment_sum_plain(data, csr),
               lambda: torch.zeros((n, d), dtype=bf, device=dev).index_add_(0, key, real),
               er * d * 2 + n * d * 4 + (n + 1) * 4 + (0 if csr.identity else er * 4), e * d)
    del key, real

    # 7: gate front backward (d_total bf16; d_bias3 f32, compared as a mean)
    args = (data, randn(e, d), randn(2, d, scale=1.0 / er, dtype=torch.float32), er)
    got, ref = gate_front_bwd(*args), gate_front_bwd_plain(*args)
    err = max(check_bf16("gate_front_bwd_bf16.d_total", torch, got[0], ref[0]),
              check_close("gate_front_bwd_bf16.d_bias3/E", torch, got[1] / e, ref[1] / e,
                          KERNEL_TOL, KERNEL_TOL))
    record(GATE_FRONT_BWD_BF16, err, f"{ulp_tol} on d_total, {f32_tol} on d_bias3/E",
           lambda: gate_front_bwd(*args), lambda: gate_front_bwd_plain(*args), None,
           3 * e * d * 2 + 3 * d * 4, 5 * e * d)
    del got, ref, args

    # 8, 9: the edge walks, with their f32 g_sums (rounded to bf16 as they
    # are used) and f32 affine / d_affine; two calls alike bit for bit
    g_sums = randn(n, 2 * d, dtype=torch.float32)
    walks = (
        (EPILOG_BWD_BF16, epilog_bwd, epilog_bwd_plain,
         (randn(e, d), e_new, data, g_sums, values, affine, graph.by_dst, graph.src),
         (5 * e * d + er * d + u_src * d) * 2 + (u_dst * 2 * d + 4 * d) * 4 + (e + er) * 4,
         18 * e * d),
        (REV_BWD_BF16, rev_bwd, rev_bwd_plain, (e_new, g_sums, values, graph.by_src, graph.dst),
         (er * d + 2 * e * d + u_dst * d) * 2 + u_src * 2 * d * 4 + (2 * e + er) * 4,
         12 * e * d))
    for kernel, fn, plain, args, n_bytes, n_ops in walks:
        got, ref = fn(*args), plain(*args)
        err = max(check_bf16(f"{kernel.name}.{i}", torch, a, b)
                  for i, (a, b) in enumerate(zip(got[:3], ref[:3])))
        if len(got) == 4:
            err = max(err, check_close(f"{kernel.name}.d_affine/E", torch, got[3] / e,
                                       ref[3] / e, KERNEL_TOL, KERNEL_TOL))
        if not all(torch.equal(a, b) for a, b in zip(got, fn(*args))):
            raise AssertionError(f"{kernel.name}: a second call gave other values")
        tol = f"{ulp_tol} on [E, D]" + (f", {f32_tol} on d_affine/E" if len(got) == 4 else "")
        record(kernel, err, f"{tol}; two calls alike",
               lambda fn=fn, args=args: fn(*args), lambda plain=plain, args=args: plain(*args),
               None, n_bytes, n_ops)
        del got, ref
    del data, walks

    # 10: the σ-aggregate's three forms, f32 sums of bf16 summands: by_dst
    # over the node table at src (LayerNorm h_fwd), by_dst and by_src over
    # pregathered rows (the wide paths); then their backward walks
    vals = randn(e, d)
    forms = ((SIGMA_AGGREGATE_GATHER_BF16, SIGMA_AGGREGATE_BWD_GATHER_BF16, graph.by_dst,
              values, graph.src, u_src * d, u_dst, (n + 1 + er) * 4, e + er),
             (SIGMA_AGGREGATE_BF16, SIGMA_AGGREGATE_BWD_BF16, graph.by_dst, vals, None,
              er * d, u_dst, (n + 1) * 4, e),
             (SIGMA_AGGREGATE_BY_SRC_BF16, SIGMA_AGGREGATE_BWD_BY_SRC_BF16, graph.by_src, vals,
              None, er * d, u_src, (n + 1 + er) * 4, 2 * e))
    for fwd, _, csr, v, ids, table, _, id_bytes, _ in forms:
        args = (e_new, v, csr, ids)
        err = check_close(fwd.name, torch, sigma_aggregate(*args), sigma_aggregate_plain(*args),
                          KERNEL_TOL, KERNEL_TOL)
        record(fwd, err, f32_tol, lambda args=args: sigma_aggregate(*args),
               lambda args=args: sigma_aggregate_plain(*args), None,
               (er * d + table) * 2 + 2 * n * d * 4 + id_bytes, 5 * e * d)
    for _, bwd, csr, v, ids, table, g_rows, _, id_count in forms:
        args = (e_new, g_sums, v, csr, ids)
        got, ref = sigma_aggregate_bwd(*args), sigma_aggregate_bwd_plain(*args)
        err = max(check_bf16(f"{bwd.name}.{i}", torch, a, b) for i, (a, b) in
                  enumerate(zip(got, ref)))
        if not all(torch.equal(a, b) for a, b in zip(got, sigma_aggregate_bwd(*args))):
            raise AssertionError(f"{bwd.name}: a second call gave other values")
        record(bwd, err, f"{ulp_tol}; two calls alike",
               lambda args=args: sigma_aggregate_bwd(*args),
               lambda args=args: sigma_aggregate_bwd_plain(*args), None,
               (er * d + 2 * e * d + table) * 2 + g_rows * 2 * d * 4 + id_count * 4,
               12 * e * d)
        del got, ref

    # 11: the gate epilog over pregathered values (σ of the f32 e_new,
    # bf16 summands), and its VJP, which recomputes e_new from e_in
    gate, e_in = randn(e, d), randn(e, d)
    args = (gate, e_in, vals, affine, graph.by_dst)
    (sums, e_new2), (ref_sums, ref_e_new) = gate_sigma_gather(*args), \
        gate_sigma_gather_plain(*args)
    err = max(check_close("gate_sigma_aggregate_bf16.sums", torch, sums, ref_sums, KERNEL_TOL,
                          KERNEL_TOL),
              check_bf16("gate_sigma_aggregate_bf16.e_new", torch, e_new2, ref_e_new))
    record(GATE_SIGMA_AGGREGATE_BF16, err, f"{ulp_tol} on e_new, {f32_tol} on sums",
           lambda: gate_sigma_gather(*args), lambda: gate_sigma_gather_plain(*args), None,
           4 * e * d * 2 + (2 * n * d + 2 * d) * 4 + (n + 1) * 4, 8 * e * d)
    del sums, e_new2, ref_sums, ref_e_new
    args = (gate, e_in, randn(e, d), g_sums, vals, affine, graph.by_dst, None)
    got, ref = epilog_bwd(*args), epilog_bwd_plain(*args)
    err = max(max(check_bf16(f"epilog_bwd_pregathered_bf16.{i}", torch, a, b)
                  for i, (a, b) in enumerate(zip(got[:3], ref[:3]))),
              check_close("epilog_bwd_pregathered_bf16.d_affine/E", torch, got[3] / e,
                          ref[3] / e, KERNEL_TOL, KERNEL_TOL))
    if not all(torch.equal(a, b) for a, b in zip(got, epilog_bwd(*args))):
        raise AssertionError("epilog_bwd_pregathered_bf16: a second call gave other values")
    record(EPILOG_BWD_PREGATHERED_BF16, err,
           f"{ulp_tol} on [E, D], {f32_tol} on d_affine/E; two calls alike",
           lambda: epilog_bwd(*args), lambda: epilog_bwd_plain(*args), None,
           (5 * e * d + 2 * er * d) * 2 + (u_dst * 2 * d + 4 * d) * 4 + e * 4, 18 * e * d)
    # the BatchNorm model's node norm at [N, D]
    for case in batch_norm_cases(torch, graph, gen, bf):
        record(case[0], case[1], ulp_tol, *case[2:])
    return rows_out


def phase_parity(torch, graph, seed: int) -> list[dict]:
    """Each kernel entry against its plain version at the main paths' shapes."""
    from gnnome_tpu_torch.ops.gate_epilog import (
        GATE_SIGMA_AGGREGATE, GATE_SIGMA_GATHER, gate_sigma_gather, gate_sigma_gather_plain)
    from gnnome_tpu_torch.ops.gate_front import (
        GATE_FRONT, GATE_FRONT_BWD, gate_front, gate_front_bwd, gate_front_bwd_plain,
        gate_front_plain)
    from gnnome_tpu_torch.ops.norm import (
        LAYER_NORM, LAYER_NORM_BWD, layer_norm_relu_residual_bwd,
        layer_norm_relu_residual_bwd_plain, layer_norm_relu_residual_fwd,
        layer_norm_relu_residual_plain)
    from gnnome_tpu_torch.ops.reverse_sum import (
        SIGMA_OPPOSITE, SIGMA_REVERSE_SUM, sigma_opposite, sigma_opposite_plain,
        sigma_reverse_sum, sigma_reverse_sum_plain)
    from gnnome_tpu_torch.ops.segment_sum import (
        SEGMENT_SUM_BY_DST, SEGMENT_SUM_BY_SRC, segment_sum, segment_sum_plain)
    from gnnome_tpu_torch.ops.sigma_aggregate import (
        SIGMA_AGGREGATE, SIGMA_AGGREGATE_BY_SRC, SIGMA_AGGREGATE_GATHER, sigma_aggregate,
        sigma_aggregate_plain)
    from gnnome_tpu_torch.ops.take import TAKE_ROWS, take_rows, take_rows_plain

    dev = graph.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, e, d, d_score = graph.n_nodes_padded, graph.n_edges_padded, 256, 64
    er = graph.n_edges  # real edges: the sums read no padded row
    d_wide = 2 * d  # the paired rows of wide_gathers

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def rows(ids):  # distinct table rows the ids reference
        return int(torch.unique(ids).numel())

    u_src, u_dst = rows(graph.src), rows(graph.dst)
    rows_out = []

    def measure_f32(kernel, max_err, tol, *args, **kw):
        return measure(torch, kernel, max_err, f"tol rtol=atol={tol}", *args, **kw)

    def record(kernel, *args, **kw):
        rows_out.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                             replaces=kernel.replaces, launches=0,
                             **measure_f32(kernel, *args, **kw)))

    def close_all(name, got, ref):
        return max(check_close(f"{name}.{i}", torch, a, b, KERNEL_TOL, KERNEL_TOL)
                   for i, (a, b) in enumerate(zip(got, ref)))

    # 4: take (score head: [N, hidden_edge_scores] tables, canonical src ids)
    table = randn(n, d_score)
    got = take_rows(table, graph.src)
    err = check_close("take_rows", torch, got, take_rows_plain(table, graph.src), 0.0, 0.0)
    record(TAKE_ROWS, err, 0.0, lambda: take_rows(table, graph.src),
           lambda: take_rows_plain(table, graph.src),
           lambda: table.index_select(0, graph.src),
           u_src * d_score * 4 + e * 4 + e * d_score * 4, 0)
    # ... at the endpoint width D (the "src" wide path's b2h by dst), and at
    # the wide-gather width: [b1h ‖ a2h] by src
    for key, width in (("at_d", d), ("at_2d", d_wide)):
        table = randn(n, width)
        err = check_close(f"take_rows[{width}]", torch, take_rows(table, graph.src),
                          take_rows_plain(table, graph.src), 0.0, 0.0)
        rows_out[-1][key] = measure_f32(
            TAKE_ROWS, err, 0.0, lambda: take_rows(table, graph.src),
            lambda: take_rows_plain(table, graph.src), lambda: table.index_select(0, graph.src),
            u_src * width * 4 + e * 4 + e * width * 4, 0, what=f" [N, {width}]")
    del table, got

    # 1: gate front
    b1h, b2h, ein = randn(n, d), randn(n, d), randn(e, d)
    w3, b3 = randn(d, d, scale=d ** -0.5), randn(d)
    args = (b1h, b2h, ein, w3, b3, graph.src, graph.dst, graph.n_edges)
    gate, mom = gate_front(*args)
    ref_gate, ref_mom = gate_front_plain(*args)
    err = max(check_close("gate_front.gate", torch, gate, ref_gate, KERNEL_TOL, KERNEL_TOL),
              check_close("gate_front.mom/E", torch, mom / graph.n_edges,
                          ref_mom / graph.n_edges, KERNEL_TOL, KERNEL_TOL))
    # the product runs on the tensor cores as three TF32 products (split-TF32,
    # csrc/gate_front.cu): its bound is theirs; the f32 CUDA-core bound of the
    # same product and cuBLAS's f32 e·W3 + b3 alone (which the port never
    # calls for this row) are printed beside it
    front_bytes = (2 * e * d + (u_src + u_dst) * d + d * d + d + 2 * d) * 4 + 2 * e * 4
    record(GATE_FRONT, err, KERNEL_TOL, lambda: gate_front(*args),
           lambda: gate_front_plain(*args), None, front_bytes, 3 * 2 * e * d * d,
           ops_per_s=TF32_TC_OPS_PER_S)
    f32_ms, f32_by = bound(front_bytes, 2 * e * d * d + 3 * e * d + 3 * graph.n_edges * d)
    addmm_ms = time_ms(torch, lambda: torch.addmm(b3, ein, w3))
    rows_out[-1].update(bound_f32_cuda_cores_ms=f32_ms, addmm_f32_ms=addmm_ms)
    log(f"  gate_front bounds: 3-pass TF32 tensor cores {rows_out[-1]['bound_ms']:.4f} ms "
        f"({rows_out[-1]['bound_by']}), f32 CUDA cores {f32_ms:.4f} ms ({f32_by}); "
        f"note: torch.addmm(b3, e, W3) in f32 (cuBLAS, the product alone) {addmm_ms:.4f} ms")
    del ref_gate, ref_mom, b1h, b2h, w3, b3, args

    # 2: gate epilog + forward aggregation
    values = randn(n, d)
    affine = torch.stack([torch.rand(d, generator=gen, device=dev) + 0.5, randn(d)])
    args = (gate, ein, values, affine, graph.by_dst, graph.src)
    sums, e_new = gate_sigma_gather(*args)
    ref_sums, ref_e_new = gate_sigma_gather_plain(*args)
    err = max(check_close("gate_sigma_gather.sums", torch, sums, ref_sums, KERNEL_TOL, KERNEL_TOL),
              check_close("gate_sigma_gather.e_new", torch, e_new, ref_e_new,
                          KERNEL_TOL, KERNEL_TOL))
    record(GATE_SIGMA_GATHER, err, KERNEL_TOL, lambda: gate_sigma_gather(*args),
           lambda: gate_sigma_gather_plain(*args), None,
           (3 * e * d + u_src * d + 2 * d + 2 * n * d) * 4 + (n + 1 + e) * 4,
           8 * e * d)
    del ref_sums, ref_e_new, sums, args

    # 11: gate epilog over pregathered values (wide_gathers: a2h[src] per edge)
    vals = randn(e, d)
    args = (gate, ein, vals, affine, graph.by_dst)
    got, ref = gate_sigma_gather(*args), gate_sigma_gather_plain(*args)
    err = close_all("gate_sigma_aggregate", got, ref)
    del got, ref
    record(GATE_SIGMA_AGGREGATE, err, KERNEL_TOL, lambda: gate_sigma_gather(*args),
           lambda: gate_sigma_gather_plain(*args), None,
           (4 * e * d + 2 * n * d + 2 * d) * 4 + (n + 1) * 4, 8 * e * d)
    del gate, ein, args

    # 3: reverse aggregation
    args = (e_new, values, graph.by_src, graph.dst)
    got = sigma_reverse_sum(*args)
    err = check_close("sigma_reverse_sum", torch, got, sigma_reverse_sum_plain(*args),
                      KERNEL_TOL, KERNEL_TOL)
    record(SIGMA_REVERSE_SUM, err, KERNEL_TOL, lambda: sigma_reverse_sum(*args),
           lambda: sigma_reverse_sum_plain(*args), None,
           (er * d + u_dst * d + 2 * n * d) * 4 + (2 * er + n + 1) * 4,
           5 * e * d)
    del got, args

    # 12: reverse aggregation with the dst ids in src-sorted order
    args = (e_new, values, graph.by_src)
    got = sigma_opposite(*args)
    err = check_close("sigma_opposite", torch, got, sigma_opposite_plain(*args),
                      KERNEL_TOL, KERNEL_TOL)
    record(SIGMA_OPPOSITE, err, KERNEL_TOL, lambda: sigma_opposite(*args),
           lambda: sigma_opposite_plain(*args), None,
           (er * d + u_dst * d + 2 * n * d) * 4 + (2 * er + n + 1) * 4, 5 * e * d)
    del got, args

    # 10: σ-aggregate: by_dst over the node table at src (LayerNorm h_fwd),
    # by_dst over pregathered rows (LayerNorm + wide h_fwd), by_src over
    # pregathered rows (wide h_bwd from a3h[dst])
    forms = ((SIGMA_AGGREGATE_GATHER, graph.by_dst, values, graph.src,
              (er * d + u_src * d + 2 * n * d) * 4 + (n + 1 + er) * 4),
             (SIGMA_AGGREGATE, graph.by_dst, vals, None,
              (2 * er * d + 2 * n * d) * 4 + (n + 1) * 4),
             (SIGMA_AGGREGATE_BY_SRC, graph.by_src, vals, None,
              (2 * er * d + 2 * n * d) * 4 + (n + 1 + er) * 4))
    for kernel, csr, v, ids, n_bytes in forms:
        args = (e_new, v, csr, ids)
        err = check_close(kernel.name, torch, sigma_aggregate(*args),
                          sigma_aggregate_plain(*args), KERNEL_TOL, KERNEL_TOL)
        record(kernel, err, KERNEL_TOL, lambda: sigma_aggregate(*args),
               lambda: sigma_aggregate_plain(*args), None, n_bytes, 5 * e * d)
    del args

    # the backward path (E x D cotangents at the same shapes)
    # 5, 6: segment sums, the transpose reductions (library: index_add_,
    # float atomics, as a yardstick only), at D and at the wide width 2D
    for width in (d, d_wide):
        data = randn(e, width)
        for kernel, csr in ((SEGMENT_SUM_BY_DST, graph.by_dst),
                            (SEGMENT_SUM_BY_SRC, graph.by_src)):
            key, real = csr.key[:er].long(), data[:er]  # padded edges are last
            err = check_close(kernel.name, torch, segment_sum(data, csr),
                              segment_sum_plain(data, csr), KERNEL_TOL, KERNEL_TOL)
            m = (kernel, err, KERNEL_TOL, lambda: segment_sum(data, csr),
                 lambda: segment_sum_plain(data, csr),
                 lambda: torch.zeros((n, width), device=dev).index_add_(0, key, real),
                 (er * width + n * width) * 4 + (n + 1) * 4 + (0 if csr.identity else er * 4),
                 e * width)
            if width == d:
                record(*m)
            else:
                row = next(r for r in rows_out if r["name"] == kernel.name)
                row["at_2d"] = measure_f32(*m, what=f" [E, {width}]")
        del key, real
    data = randn(e, d)

    # 7: gate front backward (d_total and d_bias3; d_bias3 compared as a mean)
    args = (data, randn(e, d), randn(2, d, scale=1.0 / graph.n_edges), graph.n_edges)
    got, ref = gate_front_bwd(*args), gate_front_bwd_plain(*args)
    err = max(check_close("gate_front_bwd.d_total", torch, got[0], ref[0], KERNEL_TOL, KERNEL_TOL),
              check_close("gate_front_bwd.d_bias3/E", torch, got[1] / e, ref[1] / e,
                          KERNEL_TOL, KERNEL_TOL))
    record(GATE_FRONT_BWD, err, KERNEL_TOL, lambda: gate_front_bwd(*args),
           lambda: gate_front_bwd_plain(*args), None, (3 * e * d + 3 * d) * 4, 5 * e * d)
    del got, ref, args, data, e_new, values, vals, affine
    # the LayerNorm -> ReLU -> residual row kernel (no TPU kernel: XLA fuses
    # it), the LayerNorm model's edge norm at [E, D] and node norm at [N, D];
    # the library yardstick, which the port never calls, is
    # torch.nn.functional.layer_norm, then relu and the add. The backward is
    # held to the kernel's formula under the kernel's own ReLU mask (the
    # forward with a zero residual), so no row flips sides of the ReLU.
    parts = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    for rows_n in (e, n):
        x, res, g_ln = randn(rows_n, d, scale=2.0) + 0.5, randn(rows_n, d), randn(rows_n, d)
        ln_s, ln_b = randn(d, scale=0.5) + 1.0, randn(d, scale=0.5)
        args = (x, ln_s, ln_b, res)
        err = check_close("layer_norm_relu_residual", torch, layer_norm_relu_residual_fwd(*args),
                          layer_norm_relu_residual_plain(*args), KERNEL_TOL, KERNEL_TOL)
        fwd = (LAYER_NORM, err, KERNEL_TOL, lambda: layer_norm_relu_residual_fwd(*args),
               lambda: layer_norm_relu_residual_plain(*args),
               lambda: torch.relu(torch.nn.functional.layer_norm(x, (d,), ln_s, ln_b, 1e-5))
               + res, (3 * rows_n * d + 2 * d) * 4, 10 * rows_n * d)
        keep = layer_norm_relu_residual_fwd(x, ln_s, ln_b, torch.zeros_like(res)) > 0
        got = layer_norm_relu_residual_bwd(x, g_ln, ln_s, ln_b)
        ref = layer_norm_relu_residual_bwd_plain(x, g_ln, ln_s, ln_b, keep=keep)
        err = max(check_close("layer_norm_relu_residual_bwd.dx", torch, got[0], ref[0],
                              KERNEL_TOL, KERNEL_TOL),
                  check_close("layer_norm_relu_residual_bwd.d_affine/R", torch,
                              got[1] / rows_n, ref[1] / rows_n, KERNEL_TOL, KERNEL_TOL))
        bwd = (LAYER_NORM_BWD, err, KERNEL_TOL,
               lambda: layer_norm_relu_residual_bwd(x, g_ln, ln_s, ln_b),
               lambda: layer_norm_relu_residual_bwd_plain(x, g_ln, ln_s, ln_b), None,
               (3 * rows_n * d + 4 * d + 2 * parts * d) * 4, 20 * rows_n * d)
        if rows_n == e:
            record(*fwd)
            record(*bwd)
        else:
            for m in (fwd, bwd):
                row = next(r for r in rows_out if r["name"] == m[0].name)
                row["at_node"] = measure_f32(*m, what=f" [N, {d}]")
        del x, res, g_ln, args, keep, got, ref
    # 8, 9, 10's and 11's backwards and 13: the edge-balanced walks
    for case in walk_cases(torch, graph, gen):
        err = check_walk(torch, case)
        record(case[0], err, KERNEL_TOL, *case[1:3], None, *case[3:5])
    # the BatchNorm -> ReLU -> residual entries (no TPU kernel: XLA fuses
    # it), the BatchNorm model's node norm at [N, D]
    for case in batch_norm_cases(torch, graph, gen, torch.float32):
        record(*case[:2], KERNEL_TOL, *case[2:])
    return rows_out


def batch_norm_cases(torch, graph, gen, dtype) -> list:
    """``(kernel, max_err, fn, plain, library, n_bytes, n_ops)`` of each of
    the four BatchNorm -> ReLU -> residual entries of ``dtype``
    (``csrc/batch_norm.cu``) at the node norm's shape, [N, 256] with the
    graph's node mask, each checked against its plain version: the moments'
    sums as means over the real rows, the output (bf16: within an ulp of
    itself and of the BatchNorm's output, where the statistics' rounding may
    move it), the column sums as means over every row, and dx under the
    kernels' own ReLU mask. Plain versions: the moments as ``masked_moments``
    sums them; the whole plain forward for the apply pass and the whole
    backward formula for both backward passes. The library yardstick, which
    the port never calls: ``torch.nn.functional.batch_norm(training=True)``
    over every row (its affine in f32), then relu and the add, beside the
    apply pass. Bounds as
    ``benchmark/costs/batch_norm_*.py`` count them."""
    from gnnome_tpu_torch.ops import norm

    dev, bf16 = graph.device, dtype == torch.bfloat16
    n, nr, d = graph.n_nodes_padded, graph.n_nodes, 256
    size = 2 if bf16 else 4
    parts = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    mask = graph.node_mask

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def close(name, got, ref):
        if not bf16 or got.dtype == torch.float32:
            return check_close(name, torch, got, ref, KERNEL_TOL, KERNEL_TOL)
        return check_bf16(name, torch, got, ref)

    x, res, g = randn(n, d, scale=2.0, shift=0.5), randn(n, d), randn(n, d)
    s, b = randn(d, scale=0.5, shift=1.0), randn(d, scale=0.5)
    sums, ref = norm.batch_norm_moments(x, mask), norm.batch_norm_moments_plain(x, mask)
    if float(sums[0]) != float(ref[0]):
        raise AssertionError(f"batch_norm_moments: count {float(sums[0])}, want {float(ref[0])}")
    err = close("batch_norm_moments/N", sums[1:] / nr, ref[1:] / nr)
    cases = [(norm.BN_MOMENTS_BF16 if bf16 else norm.BN_MOMENTS, err,
              lambda: norm.batch_norm_moments(x, mask),
              lambda: norm.batch_norm_moments_plain(x, mask), None, nr * d * size + n + (parts + 1) * (1 + 2 * d) * 4, 3 * nr * d)]
    out = norm.batch_norm_apply(x, sums, s, b, res)
    ref = norm.batch_norm_relu_residual_plain(x, mask, s, b, res)
    if bf16:
        y = norm.masked_batch_norm(x, mask, s, b)
        err = (out.float() - ref.float()).abs()
        bound = bf16_ulp(torch, torch.maximum(out.abs(), ref.abs())) + bf16_ulp(torch, y) \
            + BF16_ATOL
        if bool((err > bound).any()):
            raise AssertionError(f"batch_norm_relu_residual_bf16: {int((err > bound).sum())} "
                                 f"elements beyond the bound (max {float(err.max()):.3e})")
        err = float(err.max())
        del y
    else:
        err = close("batch_norm_relu_residual", out, ref)
    cases.append((norm.BATCH_NORM_BF16 if bf16 else norm.BATCH_NORM, err,
                  lambda: norm.batch_norm_apply(x, sums, s, b, res),
                  lambda: norm.batch_norm_relu_residual_plain(x, mask, s, b, res),
                  lambda: torch.relu(torch.nn.functional.batch_norm(
                      x, None, None, s.float(), b.float(), True, 0.0, 1e-5)) + res,
                  (3 * n * d + 2 * d) * size + (1 + 2 * d) * 4, 6 * n * d))
    keep = norm.batch_norm_apply(x, sums, s, b, torch.zeros_like(res)) > 0
    d_aff = norm.batch_norm_bwd_sums(x, g, sums, s, b)
    ref_dx, ref_aff = norm.batch_norm_relu_residual_bwd_plain(x, g, mask, s, b, keep=keep)
    err = close("batch_norm_relu_residual_bwd_sums/N", d_aff / n, ref_aff / n)
    cases.append((norm.BATCH_NORM_BWD_SUMS_BF16 if bf16 else norm.BATCH_NORM_BWD_SUMS, err,
                  lambda: norm.batch_norm_bwd_sums(x, g, sums, s, b),
                  lambda: norm.batch_norm_relu_residual_bwd_plain(x, g, mask, s, b), None,
                  (2 * n * d + 2 * d) * size + (1 + 2 * d + (parts + 1) * 2 * d) * 4,
                  8 * n * d))
    dx = norm.batch_norm_bwd_dx(x, g, mask, sums, s, b, d_aff)
    err = close("batch_norm_relu_residual_bwd.dx", dx, ref_dx)
    if not torch.equal(dx, norm.batch_norm_bwd_dx(x, g, mask, sums, s, b, d_aff)):
        raise AssertionError("batch_norm_relu_residual_bwd: a second call gave other values")
    cases.append((norm.BATCH_NORM_BWD_BF16 if bf16 else norm.BATCH_NORM_BWD, err,
                  lambda: norm.batch_norm_bwd_dx(x, g, mask, sums, s, b, d_aff),
                  lambda: norm.batch_norm_relu_residual_bwd_plain(x, g, mask, s, b), None,
                  (3 * n * d + 2 * d) * size + (1 + 4 * d) * 4 + n, 12 * n * d))
    del out, ref, keep, ref_dx, ref_aff, dx
    pair = time_ms(torch, lambda: norm.batch_norm_relu_residual_fwd(x, mask, s, b, res))
    pair_bwd = time_ms(torch, lambda: norm.batch_norm_relu_residual_bwd(x, g, mask, sums, s, b))
    log(f"  batch_norm_relu_residual{'_bf16' if bf16 else ''}: the forward's two entries "
        f"{pair:.4f} ms, the backward's two {pair_bwd:.4f} ms (each with its sums' second "
        f"pass)")
    return cases


def walk_cases(torch, graph, gen) -> list:
    """``(kernel, fn, plain, n_bytes, n_ops)`` of each entry that walks
    fixed tiles of edge positions (csrc/epilog_bwd.cu, csrc/sigma_rows.cuh), on
    random inputs of ``graph``. The bytes count what these inputs need: every
    row's [E, D] inputs and outputs, but on a padded edge neither its value
    row nor its e_new row (its g_sums row is zero, so d_enew is g_enew and
    d_vals zero), nor its src id; the distinct table rows the real edges
    reference; each other id array once."""
    from gnnome_tpu_torch.ops.gate_epilog import (
        EPILOG_BWD, EPILOG_BWD_PREGATHERED, epilog_bwd, epilog_bwd_plain)
    from gnnome_tpu_torch.ops.reverse_sum import (
        OPP_BWD, REV_BWD, opp_bwd, opp_bwd_plain, rev_bwd, rev_bwd_plain)
    from gnnome_tpu_torch.ops.sigma_aggregate import (
        SIGMA_AGGREGATE_BWD, SIGMA_AGGREGATE_BWD_BY_SRC, SIGMA_AGGREGATE_BWD_GATHER,
        sigma_aggregate_bwd, sigma_aggregate_bwd_plain)

    dev = graph.device
    n, e, er, d = graph.n_nodes_padded, graph.n_edges_padded, graph.n_edges, 256
    u_src = int(torch.unique(graph.src[:er]).numel())
    u_dst = int(torch.unique(graph.dst[:er]).numel())

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    e_new, g_sums, values, vals = randn(e, d), randn(n, 2 * d), randn(n, d), randn(e, d)
    affine = torch.stack([torch.rand(d, generator=gen, device=dev) + 0.5, randn(d)])
    gate_raw, g_enew = randn(e, d), randn(e, d)
    cases = []
    for kernel, v, src, table_bytes, ids in (
            (EPILOG_BWD, values, graph.src, u_src * d, e + er),
            (EPILOG_BWD_PREGATHERED, vals, None, er * d, e)):
        args = (gate_raw, e_new, g_enew, g_sums, v, affine, graph.by_dst, src)
        # gate_raw and g_enew read and three outputs written on every row,
        # e_new read on the real rows
        cases.append((kernel, lambda args=args: epilog_bwd(*args),
                      lambda args=args: epilog_bwd_plain(*args),
                      (5 * e * d + er * d + u_dst * 2 * d + table_bytes + 4 * d + ids) * 4,
                      18 * e * d))
    # per edge: e_new's row on real edges, two [E, D] outputs, the walked
    # CSR's g_sums rows and segment_ids (and order), the value rows or table
    for kernel, fn, plain, args, g_rows, table_bytes, ids in (
            (REV_BWD, rev_bwd, rev_bwd_plain,
             (e_new, g_sums, values, graph.by_src, graph.dst), u_src, u_dst * d, 2 * e + er),
            (OPP_BWD, opp_bwd, opp_bwd_plain, (e_new, g_sums, values, graph.by_src),
             u_src, u_dst * d, 2 * e + er),
            (SIGMA_AGGREGATE_BWD_GATHER, sigma_aggregate_bwd, sigma_aggregate_bwd_plain,
             (e_new, g_sums, values, graph.by_dst, graph.src), u_dst, u_src * d, e + er),
            (SIGMA_AGGREGATE_BWD, sigma_aggregate_bwd, sigma_aggregate_bwd_plain,
             (e_new, g_sums, vals, graph.by_dst, None), u_dst, er * d, e),
            (SIGMA_AGGREGATE_BWD_BY_SRC, sigma_aggregate_bwd, sigma_aggregate_bwd_plain,
             (e_new, g_sums, vals, graph.by_src, None), u_src, er * d, 2 * e)):
        cases.append((kernel, lambda fn=fn, args=args: fn(*args),
                      lambda plain=plain, args=args: plain(*args),
                      (er * d + 2 * e * d + g_rows * 2 * d + table_bytes + ids) * 4,
                      12 * e * d))
    return cases


def check_walk(torch, case) -> float:
    """A walk entry against its plain version (d_affine, a sum over every
    row, as a mean), and a second call alike bit for bit; the max error."""
    kernel, fn, plain = case[:3]
    got, ref = fn(), plain()
    rows = got[0].shape[0]
    err = max(check_close(f"{kernel.name}.{i}", torch, a, b, KERNEL_TOL, KERNEL_TOL)
              for i, (a, b) in enumerate(zip(got[:3], ref[:3])))
    if len(got) == 4:
        err = max(err, check_close(f"{kernel.name}.d_affine/E", torch, got[3] / rows,
                                   ref[3] / rows, KERNEL_TOL, KERNEL_TOL))
    if not all(torch.equal(a, b) for a, b in zip(got, fn())):
        raise AssertionError(f"{kernel.name}: a second call gave other values")
    return err


def piece_graph(seed: int, device="cuda"):
    """The shape of the ClusterGCN piece with the most padding in phase 7
    (its second epoch at seed 0: 10,046 real nodes and 64,498 real edges in
    a bucket of 14,336 / 91,136, 26,638 padded edges): the local bench
    graph's first 64,498 edges among its first 10,046 nodes, padded to that
    bucket."""
    import numpy as np

    from gnnome_tpu_torch.core.graph import build_graph
    from gnnome_tpu_torch.data.synthetic import bench_edges

    n_real, e_real, n_pad, e_pad = 10_046, 64_498, 14_336, 91_136
    src, dst = bench_edges(N_NODES, N_EDGES, seed)
    inside = np.nonzero((src < n_real) & (dst < n_real))[0][:e_real]
    if len(inside) != e_real:
        raise AssertionError(f"only {len(inside)} edges among the first {n_real} nodes")
    return build_graph(src[inside], dst[inside], n_real, node_pad_multiple=n_pad,
                       edge_pad_multiple=e_pad, device=device)


HUB_EDGES = 10_000  # in-edges and out-edges of the hub graph's hub row


def hub_graph(seed: int, device="cuda"):
    """The local bench graph with a hub: HUB_EDGES of its skip edges
    re-pointed into node N/2 and HUB_EDGES others out of it."""
    from gnnome_tpu_torch.core.graph import build_graph
    from gnnome_tpu_torch.data.synthetic import bench_edges

    src, dst = bench_edges(N_NODES, N_EDGES, seed)
    hub, skip = N_NODES // 2, N_NODES  # the chain's ~N edges come first
    dst[skip: skip + HUB_EDGES] = hub
    src[skip + HUB_EDGES: skip + 2 * HUB_EDGES] = hub
    keep = src != dst
    return build_graph(src[keep], dst[keep], N_NODES, device=device)


def phase_walks(torch, graph, seed: int, label: str) -> dict:
    """The walk entries on one more graph shape: checked as in phase 2,
    then kernel, plain and bound times; ``{name: measurements}``."""
    gen = torch.Generator(device=graph.device).manual_seed(seed)
    out = {}
    for kernel, fn, plain, n_bytes, n_ops in walk_cases(torch, graph, gen):
        err = check_walk(torch, (kernel, fn, plain))
        ms, plain_ms = time_ms(torch, fn), time_ms(torch, plain)
        b_ms, b_by = bound(n_bytes, n_ops)
        log(f"  {kernel.name} [{label}]: max_abs_err={err:.3e} (tol rtol=atol={KERNEL_TOL}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}); "
            f"two calls equal bit for bit")
        out[kernel.name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None)
    return out


def reset_launches():
    from gnnome_tpu_torch.ops.cuda_lib import KERNELS

    for k in KERNELS.values():
        k.launches = 0


def read_launches() -> dict:
    from gnnome_tpu_torch.ops.cuda_lib import KERNELS

    return {name: k.launches for name, k in KERNELS.items()}


def phase_scoring(torch, graph, params, cfg, seed: int, variant: str,
                  compute_dtype: str = "float32") -> dict:
    """One forward's launches, three forwards' ms (each bit for bit the
    first's), peak memory and a profile; under bf16 the probabilities are
    also printed beside the f32 forward's."""
    from gnnome_tpu_torch.data.synthetic import bench_features
    from gnnome_tpu_torch.decode.inference import score_graph
    from gnnome_tpu_torch.models.model import model_forward

    batch_norm, wide = VARIANTS[variant]
    e_feat, pe = bench_features(graph, seed, cfg.model.nb_pos_enc)
    bf16 = compute_dtype != "float32"

    def forward(dtype=compute_dtype):
        if dtype == "float32":
            return score_graph(params, graph, e_feat, pe, batch_norm=batch_norm,
                               wide_gathers=wide)
        with torch.no_grad():  # score_graph's forward, in bf16
            return model_forward(params, graph, e_feat, pe, batch_norm=batch_norm,
                                 wide_gathers=wide, compute_dtype=dtype)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits = forward()
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in one forward: { {k: v for k, v in launches.items() if v} }")
    expect = expected_launches(f"{variant}_bf16" if bf16 else variant, remat=None)
    if launches != expect:
        raise AssertionError(f"launch counts {launches}, expected {expect}")
    if tuple(logits.shape) != (graph.n_edges_padded,) or not torch.isfinite(logits).all():
        raise AssertionError(f"logits: shape {tuple(logits.shape)}, finite="
                             f"{bool(torch.isfinite(logits).all())}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = forward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(again, logits):
            raise AssertionError("a second forward gave other logits: a sum on the "
                                 "path is not deterministic")
    del again
    times.sort()
    log(f"  forward ms (3 runs, host clock after synchronize): "
        f"{[round(t, 3) for t in times]}; median {times[1]:.3f}; logits of every "
        f"forward equal bit for bit")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB; logits finite, "
        f"mean {float(logits.mean()):.4f} std {float(logits.std()):.4f}")
    if bf16:
        ref = forward("float32")
        real = slice(0, graph.n_edges)
        log(f"  max |prob bf16 - prob f32| "
            f"{float((torch.sigmoid(logits[real]) - torch.sigmoid(ref[real])).abs().max()):.4e}"
            f", max |logit difference| {float((logits[real] - ref[real]).abs().max()):.4e}")
        del ref
    profile_run(torch, forward, f"{'bf16 ' if bf16 else ''}forward")
    return launches


# kernels a GatedGCN layer launches in its forward and in its backward, by
# model variant (models/gated_gcn.py); the gathers' backward is a segment
# sum over the gathered endpoint's CSR
BN_NODE_FWD = {"batch_norm_moments": 1, "batch_norm_relu_residual": 1}
BN_NODE_BWD = {"batch_norm_relu_residual_bwd_sums": 1, "batch_norm_relu_residual_bwd": 1}
FWD_PER_LAYER = {
    "batchnorm": {"gate_front": 1, "gate_sigma_gather": 1, "sigma_reverse_sum": 1,
                  **BN_NODE_FWD},
    "layernorm": {"gate_front": 1, "sigma_aggregate_gather": 1, "sigma_reverse_sum": 1,
                  "layer_norm_relu_residual": 2},
    "wide": {"take_rows": 2, "gate_sigma_aggregate": 1, "sigma_aggregate_by_src": 1,
             **BN_NODE_FWD},
    "wide_src": {"take_rows": 2, "gate_sigma_aggregate": 1, "sigma_reverse_sum": 1,
                 **BN_NODE_FWD},
    "layernorm_wide": {"take_rows": 2, "sigma_aggregate": 1, "sigma_aggregate_by_src": 1,
                       "layer_norm_relu_residual": 2},
}
BWD_PER_LAYER = {
    # gate front's d_b1h / d_b2h, the epilog's d_values by src, the reverse
    # aggregation's d_values by dst; the node norm
    "batchnorm": {"gate_front_bwd": 1, "epilog_bwd": 1, "rev_bwd": 1,
                  "segment_sum_by_dst": 2, "segment_sum_by_src": 2, **BN_NODE_BWD},
    # the gate front's d_b1h / d_b2h (its moments unread: no gate_front_bwd),
    # h_fwd's d_values by src, h_bwd's by dst; the edge and node norms
    "layernorm": {"sigma_aggregate_bwd_gather": 1, "rev_bwd": 1,
                  "segment_sum_by_dst": 2, "segment_sum_by_src": 2,
                  "layer_norm_relu_residual_bwd": 2},
    # the two paired gathers; the pregathered halves need no segment sum
    "wide": {"epilog_bwd_pregathered": 1, "sigma_aggregate_bwd_by_src": 1,
             "segment_sum_by_dst": 1, "segment_sum_by_src": 1, **BN_NODE_BWD},
    "wide_src": {"epilog_bwd_pregathered": 1, "rev_bwd": 1,
                 "segment_sum_by_dst": 2, "segment_sum_by_src": 1, **BN_NODE_BWD},
    "layernorm_wide": {"sigma_aggregate_bwd": 1, "sigma_aggregate_bwd_by_src": 1,
                       "segment_sum_by_dst": 1, "segment_sum_by_src": 1,
                       "layer_norm_relu_residual_bwd": 2},
}
# compute_dtype="bfloat16": the same kernels' bf16 entries, and no f32 entry
for _table in (FWD_PER_LAYER, BWD_PER_LAYER):
    _table.update({f"{v}_bf16": {f"{k}_bf16": c for k, c in counts.items()}
                   for v, counts in list(_table.items())})


def expected_launches(variant: str, remat, layers: int = LAYERS) -> dict:
    """Launches of every kernel entry in one forward (``remat=None``) or
    one training step of the ``layers``-deep model: the layers' kernels,
    the score head's two row gathers and, in a step, the segment sum of
    each. ``remat="layer"`` runs each layer's forward again inside the
    backward; the score head is outside the checkpoints. A ``_bf16``
    variant runs the bf16 entries throughout, the score head's too."""
    from gnnome_tpu_torch.ops.cuda_lib import KERNELS

    counts = dict.fromkeys(KERNELS, 0)
    fwd = layers * (2 if remat == "layer" else 1)
    tail = "_bf16" if variant.endswith("_bf16") else ""
    for name, c in FWD_PER_LAYER[variant].items():
        counts[name] += fwd * c
    counts["take_rows" + tail] += SCORE_HEAD_GATHERS
    if remat is not None:
        for name, c in BWD_PER_LAYER[variant].items():
            counts[name] += layers * c
        counts["segment_sum_by_dst" + tail] += 1
        counts["segment_sum_by_src" + tail] += 1
    return counts


def phase_training(torch, graph, seed: int, runs=TRAIN_RUNS,
                   compute_dtype: str = "float32") -> tuple[dict, dict]:
    """The full-scale training step of each of ``runs`` under
    ``compute_dtype``; returns the launch counts of one step per run and
    the losses of its four steps."""
    from gnnome_tpu_torch.config import ModelConfig
    from gnnome_tpu_torch.data.synthetic import bench_features, bench_labels
    from gnnome_tpu_torch.models.model import init_model_params
    from gnnome_tpu_torch.train.loop import make_optimizer, train_step

    cfg = ModelConfig()  # the shipped models' shapes: D=256, 16 layers, PE 16
    e_feat, pe = bench_features(graph, seed, cfg.nb_pos_enc)
    y = bench_labels(graph, seed)
    pos_weight = torch.tensor(POS_WEIGHT, device=graph.device)
    log(f"  {graph.n_nodes} nodes, {graph.n_edges} edges, labels positive "
        f"{float(y[: graph.n_edges].mean()):.4f}, pos_weight {POS_WEIGHT}, Adam lr {LR}")
    out, all_losses = {}, {}
    bf16 = compute_dtype != "float32"
    for variant, remat in runs:
        batch_norm, wide = VARIANTS[variant]
        launch_key = f"{variant}_bf16" if bf16 else variant
        label = f"{launch_key}, remat={remat!r}"
        params = init_model_params(torch.Generator().manual_seed(seed), cfg, graph.device)
        opt = make_optimizer(params, LR)

        def step():
            loss, _ = train_step(params, opt, graph, e_feat, pe, y, pos_weight,
                                 batch_norm=batch_norm, remat=remat, wide_gathers=wide,
                                 compute_dtype=compute_dtype)
            torch.cuda.synchronize()
            if not torch.isfinite(loss):
                raise AssertionError(f"{label}: loss {float(loss)} is not finite")
            return float(loss)

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses = [step()]
        launches = read_launches()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            losses.append(step())
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        log(f"  {label}: launches in one step: { {k: v for k, v in launches.items() if v} }")
        if launches != expected_launches(launch_key, remat):
            raise AssertionError(f"launch counts {launches}, expected "
                                 f"{expected_launches(launch_key, remat)}")
        times.sort()
        log(f"  {label}: step ms (3 after a warm-up, host clock after synchronize): "
            f"{[round(t, 3) for t in times]}; median {times[1]:.3f}; "
            f"{graph.n_edges / (times[1] / 1e3):.0f} edges/s; peak device memory "
            f"{peak / 2**30:.3f} GiB; losses {[round(x, 5) for x in losses]}")
        profile_run(torch, step, f"step ({label})", iters=2)
        out[(variant, remat)], all_losses[(variant, remat)] = launches, losses
        del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out, all_losses


PORT_KERNELS = {  # device kernel name -> the wrapper(s) that launch it
    "gate_front_kernel": "gate_front", "moments_reduce_kernel": "gate_front",
    "gate_front_bf16_kernel": "gate_front", "gate_front_bf16_tma_kernel": "gate_front",
    "w3_split_kernel": "gate_front",
    "gate_sigma_gather_kernel": "gate_sigma_gather",
    "gate_sigma_aggregate_kernel": "gate_sigma_aggregate",
    "gate_epilog_tail_kernel": "gate_sigma_gather / gate_sigma_aggregate",
    "sigma_reverse_sum_kernel": "sigma_reverse_sum",
    "sigma_opposite_kernel": "sigma_opposite",
    "sigma_aggregate_gather_kernel": "sigma_aggregate_gather",
    "sigma_aggregate_kernel": "sigma_aggregate",
    "sigma_aggregate_by_src_kernel": "sigma_aggregate_by_src",
    "take_rows_kernel": "take_rows",
    "gate_front_bwd_kernel": "gate_front_bwd", "bias3_reduce_kernel": "gate_front_bwd",
    "epilog_bwd_kernel": "epilog_bwd",
    "epilog_bwd_pregathered_kernel": "epilog_bwd_pregathered",
    "affine_reduce_kernel": "epilog_bwd / epilog_bwd_pregathered",
    "rev_bwd_kernel": "rev_bwd", "opp_bwd_kernel": "opp_bwd",
    "sigma_aggregate_bwd_gather_kernel": "sigma_aggregate_bwd_gather",
    "sigma_aggregate_bwd_kernel": "sigma_aggregate_bwd",
    "sigma_aggregate_bwd_by_src_kernel": "sigma_aggregate_bwd_by_src",
    "layer_norm_relu_residual_kernel": "layer_norm_relu_residual",
    "layer_norm_relu_residual_looped_kernel": "layer_norm_relu_residual",
    "layer_norm_relu_residual_bwd_kernel": "layer_norm_relu_residual_bwd",
    "layer_norm_relu_residual_bwd_looped_kernel": "layer_norm_relu_residual_bwd",
    "ln_affine_reduce_kernel": "layer_norm_relu_residual_bwd",
    "batch_norm_moments_kernel": "batch_norm_moments",
    "batch_norm_relu_residual_kernel": "batch_norm_relu_residual",
    "batch_norm_relu_residual_bwd_sums_kernel": "batch_norm_relu_residual_bwd_sums",
    "batch_norm_relu_residual_bwd_kernel": "batch_norm_relu_residual_bwd",
    "bn_partials_reduce_kernel": "batch_norm_moments / batch_norm_relu_residual_bwd_sums",
}


def kernel_group(name: str) -> str:
    base = re.search(r"\b(\w+_kernel)\b", name)
    base = base.group(1) if base else ""
    if base == "segment_sum_kernel":  # template <T, VEC, ORDERED>: by_src is ordered
        tail = " (bf16)" if "bfloat16" in name else ""
        return f"port: segment_sum_by_{'src' if 'true>' in name else 'dst'}{tail}"
    if base in PORT_KERNELS:  # a bf16 instance names __nv_bfloat16 (or is a gate_front_bf16)
        bf16 = "bfloat16" in name or base.startswith("gate_front_bf16_")
        return f"port: {PORT_KERNELS[base]}{' (bf16)' if bf16 else ''}"
    if "gemm" in name.lower() or "cutlass" in name.lower() or name.startswith("nvjet"):
        return "cuBLAS products"  # nvjet_*: cuBLASLt's kernels for Hopper
    if "multi_tensor_apply" in name:
        return "Adam (torch.optim, foreach)"
    return "other PyTorch kernels"


def profile_run(torch, run, what: str, iters: int = 3) -> dict:
    """Device time of ``run`` by kernel group under torch.profiler, and
    the device's idle share (1 - busy / host time, unclamped: a negative
    share means kernels overlapped); returns the ms per run by group."""
    from collections import defaultdict

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
    per_kernel = defaultdict(float)
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0 and getattr(evt, "device_type", None) != torch.autograd.DeviceType.CPU:
            per_kernel[evt.key] += us / 1e3 / iters
    busy = sum(per_kernel.values())
    if busy == 0:
        raise AssertionError("profile: torch.profiler recorded no device time")
    groups = defaultdict(float)
    for name, ms in per_kernel.items():
        groups[kernel_group(name)] += ms
    log(f"  profile ({iters} x {what}): host {host_ms:.3f} ms, device busy "
        f"{busy:.3f} ms, idle share {1 - busy / host_ms:.4f} per {what}")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {name:30s} {ms:9.3f} ms  {ms / busy:6.1%}")
    log(f"  top kernels (ms per {what}):")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {ms:9.3f}  {name[:100]}")
    return dict(groups)


def phase_end_to_end(torch, cfg, model_path: Path, seed: int, device="cuda") -> Path:
    """Reads to contigs; returns the genome's data directory."""
    import numpy as np

    from gnnome_tpu_torch.data import native_bridge
    from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset
    from gnnome_tpu_torch.data.simulate import simulate_reads, write_fasta
    from gnnome_tpu_torch.decode.inference import inference, load_model, score_graph
    from gnnome_tpu_torch.evaluation.assembly import calculate_n50
    from gnnome_tpu_torch.evaluation.metrics import classification_metrics, confusion_counts

    data = WORK / "e2e"
    shutil.rmtree(data, ignore_errors=True)
    (data / "raw").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    genome = rng.choice(list("ACGT"), size=60_000)
    genome[30_000:34_000] = genome[5_000:9_000]  # planted repeat
    records = simulate_reads("".join(genome), coverage=14.0,
                             lengths=np.full(200, 2200, dtype=np.int64), seed=seed + 1)
    write_fasta(str(data / "raw" / "0.fasta"), records)
    log(f"  simulated {len(records)} reads of a 60 kb genome; overlap graph builder: "
        f"{'native' if native_bridge.available() else 'Python'}")

    t0 = time.perf_counter()
    walks, contigs = inference(str(data), str(model_path), cfg,
                               log_fn=lambda m: log(f"  {m}"),
                               ref_lengths={0: len(genome)}, device=device)
    log(f"  inference() from reads to contigs: {time.perf_counter() - t0:.2f} s")
    (_, sample), = AssemblyGraphDataset(str(data), cfg.model.nb_pos_enc, device=device)
    g = sample.graph
    logits = score_graph(load_model(str(model_path), cfg, device), g, sample.e_feat, sample.pe)
    m = classification_metrics(confusion_counts(logits[: g.n_edges], sample.y[: g.n_edges]))
    lengths = [len(seq) for _, seq in contigs[0]]
    log(f"  graph: {g.n_nodes} nodes, {g.n_edges} edges; edge f1={m['f1']:.4f} "
        f"accuracy={m['accuracy']:.4f}; contigs={len(lengths)} "
        f"N50={calculate_n50(lengths) if lengths else 0} total={sum(lengths)} bp")
    if not lengths or not all(len(w) > 1 for w in walks[0]):
        raise AssertionError("no contigs decoded")

    (_, cpu_sample), = AssemblyGraphDataset(str(data), cfg.model.nb_pos_enc, device="cpu")
    ref = score_graph(load_model(str(model_path), cfg, "cpu"), cpu_sample.graph,
                      cpu_sample.e_feat, cpu_sample.pe)
    err = check_close("e2e edge probabilities (cuda vs cpu plain path)", torch,
                      torch.sigmoid(logits.cpu()), torch.sigmoid(ref), 0.0, PROB_TOL)
    log(f"  edge probabilities, CUDA kernels vs CPU plain path: max abs err "
        f"{err:.3e} (tol atol={PROB_TOL}); max logit difference "
        f"{float((logits.cpu() - ref).abs().max()):.3e}")
    return data


def grad_errors(got: dict, ref: dict) -> tuple[dict, dict]:
    """Per leaf ``||g - g_ref|| / ||g_ref||``, and, for the leaves whose
    reference is rounding noise (below NOISE of the whole gradient's norm),
    ``||g||`` over the whole norm."""
    total = math.sqrt(sum(float((r.double() ** 2).sum()) for r in ref.values()))
    errs, noise = {}, {}
    for k, r in ref.items():
        if float(r.norm()) <= NOISE * total:
            noise[k] = float(got[k].norm()) / total
        else:
            errs[k] = float((got[k].double() - r.double()).norm() / r.double().norm())
    return errs, noise


def grads_against_cpu(torch, samples: dict, seed: int, variant: str, label: str,
                      device="cuda") -> dict:
    """The 16-layer, D=256 model's parameter gradients on ``samples[device]``
    against ``samples["cpu"]`` (the same graph), per leaf, with the launch
    counts of the card's step checked; returns those counts."""
    from gnnome_tpu_torch.config import ModelConfig
    from gnnome_tpu_torch.evaluation.metrics import bce_with_logits
    from gnnome_tpu_torch.models.model import init_model_params, model_forward
    from gnnome_tpu_torch.train.checkpoint import iter_leaves

    batch_norm, wide = VARIANTS[variant]
    grads, launches = [], None
    for dev, s in samples.items():
        y = s.y[: s.graph.n_edges]
        pos_weight = (1 - y).sum() / y.sum()
        params = init_model_params(torch.Generator().manual_seed(seed), ModelConfig(), dev)
        leaves = dict(iter_leaves(params))
        for leaf in leaves.values():
            leaf.requires_grad_(True)
        reset_launches()
        logits = model_forward(params, s.graph, s.e_feat, s.pe, batch_norm=batch_norm,
                               wide_gathers=wide, remat="layer")
        bce_with_logits(logits, s.y, s.graph.edge_mask, pos_weight).backward()
        if dev == device:
            torch.cuda.synchronize()
            launches = read_launches()
            if launches != expected_launches(variant, "layer"):
                raise AssertionError(f"{label}: launch counts {launches}, "
                                     f"expected {expected_launches(variant, 'layer')}")
        grads.append({k: leaf.grad.cpu() for k, leaf in leaves.items()})
    errs, noise = grad_errors(*grads)
    worst = max(errs, key=errs.get)
    log(f"  {label}: {s.graph.n_nodes} nodes, {s.graph.n_edges} edges; parameter "
        f"gradients, card vs CPU: worst leaf {worst} {errs[worst]:.3e} (tol {GRAD_TOL}); "
        f"median leaf {sorted(errs.values())[len(errs) // 2]:.3e}; {len(noise)} leaves "
        f"at rounding noise on the CPU, on the card at most "
        f"{max(noise.values(), default=0.0):.2e} of the gradient norm "
        f"(tol {10 * NOISE:.0e}); launches checked")
    if errs[worst] > GRAD_TOL or max(noise.values(), default=0.0) > 10 * NOISE:
        raise AssertionError(f"{label}: parameter gradients: card and CPU disagree")
    return launches


def train_with_resume(cfg, data: Path, work: Path, label: str, device="cuda",
                      learns: bool = True) -> list:
    """``train()`` for 2 epochs, then again for 4: the second call must
    resume at epoch 2 and keep the first two losses. Returns the 4 losses."""
    from gnnome_tpu_torch.train.loop import train

    shutil.rmtree(work, ignore_errors=True)
    cfg.train.checkpoint_dir = str(work / "checkpoints")
    cfg.train.pretrained_dir = str(work / "pretrained")
    logs = []

    def log_fn(msg):
        logs.append(msg)
        log(f"  {label}: {msg}")

    cfg.train.num_epochs = 2
    first = train(str(data), None, out="smoke", overfit=True, cfg=cfg, log_fn=log_fn,
                  device=device)
    cfg.train.num_epochs = 4
    second = train(str(data), None, out="smoke", overfit=True, cfg=cfg, log_fn=log_fn,
                   device=device)
    losses = second["loss_train"]
    if not any(m.startswith("Resumed") and m.endswith("at epoch 2") for m in logs):
        raise AssertionError(f"{label}: train() did not resume at epoch 2")
    if losses[:2] != first["loss_train"] or len(losses) != 4 \
            or (learns and not losses[-1] < losses[0]) \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: train losses {first['loss_train']} then {losses}")
    log(f"  {label}: train losses over 4 epochs: {[round(x, 5) for x in losses]}")
    return losses


def phase_gradients_and_loop(torch, data: Path, seed: int, device="cuda") -> dict:
    """The 16-layer, D=256 model's gradients on ``device`` against the CPU
    path on the genome graph, for each model variant, then ``train()`` with
    a resume for the BatchNorm and the LayerNorm model. Returns the launch
    counts of each variant's step on the card."""
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset

    cfg = Config()
    samples = {dev: AssemblyGraphDataset(str(data), cfg.model.nb_pos_enc, device=dev)[0][1]
               for dev in (device, "cpu")}
    launches = {variant: grads_against_cpu(torch, samples, seed, variant, variant, device)
                for variant in VARIANTS}
    for variant in ("batchnorm", "layernorm"):
        cfg = Config()
        cfg.model.batch_norm = VARIANTS[variant][0]
        cfg.train.num_parts_train = 1  # full-graph (phase 8 trains on ClusterGCN pieces)
        # the BatchNorm model learns this graph within 4 epochs at lr 1e-3;
        # the LayerNorm one from the same seed still swings over them, so it
        # is held to the resume and to finite losses
        train_with_resume(cfg, data, WORK / "train" / variant, variant, device,
                          learns=variant == "batchnorm")
    return launches


def bench_sample(torch, seed: int, device="cuda"):
    """A GraphSample of the local bench graph on the card: bench features
    and labels, zero host metadata (the sampler only slices it)."""
    import numpy as np

    from gnnome_tpu_torch.core.graph import build_graph
    from gnnome_tpu_torch.data.dataset import GraphSample
    from gnnome_tpu_torch.data.synthetic import bench_edges, bench_features, bench_labels

    src, dst = bench_edges(N_NODES, N_EDGES, seed)
    graph = build_graph(src, dst, N_NODES, device=device)
    e_feat, pe = bench_features(graph, seed, 16)
    e, n = len(src), N_NODES
    return GraphSample(idx=0, graph=graph, e_feat=e_feat, pe=pe, y=bench_labels(graph, seed),
                       prefix_length=np.zeros(e, np.int64), read_length=np.zeros(n, np.int64),
                       overlap_length=np.zeros(e, np.int64),
                       overlap_similarity=np.zeros(e, np.float32), src=src, dst=dst)


class SamplerProbe:
    """Wraps a ClusterGCN sampler: the host seconds of each call, its
    pieces, and the part counts and partitions it drew (read by recording
    the partitioner ``train/cluster.py`` calls)."""

    def __init__(self, sampler):
        from gnnome_tpu_torch.train import cluster

        self.sampler, self.seconds, self.pieces, self.drawn = sampler, [], [], []
        self._cluster, self._partition = cluster, cluster.partition_nodes

    def _record(self, src, dst, n, k, *args, **kw):
        t0 = time.perf_counter()
        parts = self._partition(src, dst, n, k, *args, **kw)
        self.drawn.append((k, parts, time.perf_counter() - t0))
        return parts

    def __call__(self, sample):
        self._cluster.partition_nodes = self._record
        try:
            t0 = time.perf_counter()
            pieces = self.sampler(sample)
            self.seconds.append(time.perf_counter() - t0)
        finally:
            self._cluster.partition_nodes = self._partition
        self.pieces.append(pieces)
        return pieces


class StepProbe:
    """Wraps ``train/loop.py``'s step function (``train_step`` or
    ``eval_step``): CUDA events around each call, and the launch counts of
    the first call (the difference of the counters around it, so the
    path's own totals run on)."""

    def __init__(self, torch, loop, name: str):
        self.torch, self.loop, self.name = torch, loop, name
        self.step, self.events, self.first = getattr(loop, name), [], None

    def __call__(self, *args, **kw):
        before = read_launches() if self.first is None else None
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.step(*args, **kw)
        end.record()
        self.events.append((start, end))
        if before is not None:
            self.torch.cuda.synchronize()
            after = read_launches()
            self.first = {k: after[k] - before[k] for k in after}
        return out

    def __enter__(self):
        setattr(self.loop, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.loop, self.name, self.step)

    def ms(self) -> list:
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def phase_cluster(torch, seed: int, device="cuda") -> dict:
    """ClusterGCN training at full width under the default Config: two
    training epochs and one cluster-validation pass of ``_epoch_pass`` over
    the local bench graph. Returns the launch counts of one piece step and
    of the whole phase."""
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.data import native_bridge
    from gnnome_tpu_torch.models.model import init_model_params
    from gnnome_tpu_torch.parallel.partition import edge_cut_fraction
    from gnnome_tpu_torch.train import loop

    cfg = Config()
    m, tc = cfg.model, cfg.train
    regime = (m.num_gnn_layers, m.hidden_features, m.nb_pos_enc, m.batch_norm, tc.remat,
              tc.num_parts_train, tc.batch_size_train, tc.cluster_jitter, tc.compute_dtype)
    if regime != (16, 256, 16, True, "layer", 500, 50, 100, "float32"):
        raise AssertionError(f"the default Config changed: {regime}")
    tc.cluster_validation = True  # num_parts_eval=500, batch_size_eval=50, cached
    if not native_bridge.available():
        raise AssertionError("the native partitioner is not available (phase 1 built it)")
    train_fn, valid_fn = loop.make_cluster_fns(cfg)
    t0 = time.perf_counter()
    sample = bench_sample(torch, seed, device)
    log(f"  local bench graph: {sample.graph.n_nodes} nodes, {sample.graph.n_edges} edges, "
        f"labels positive {float(sample.y[: sample.graph.n_edges].mean()):.4f}, built in "
        f"{time.perf_counter() - t0:.2f} s; pos_weight {POS_WEIGHT}, Adam lr {LR}; "
        f"partitioner: native ({native_bridge.lib_path()})")
    params = init_model_params(torch.Generator().manual_seed(seed), m, device)
    opt = loop.make_optimizer(params, LR)
    pos_weight = torch.tensor(POS_WEIGHT, device=device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_probe, valid_probe = SamplerProbe(train_fn), SamplerProbe(valid_fn)
    losses, step_ms = [], []

    def epoch(train_mode: bool):
        name = "train_step" if train_mode else "eval_step"
        with StepProbe(torch, loop, name) as steps:
            t0 = time.perf_counter()
            metrics = loop._epoch_pass([(0, sample)], params, opt, pos_weight, cfg, train_mode,
                                       train_probe if train_mode else valid_probe)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        probe = train_probe if train_mode else valid_probe
        k, parts, part_s = probe.drawn[-1] if probe.drawn else (tc.num_parts_eval, None, 0.0)
        pieces, ms = probe.pieces[-1], steps.ms()
        if not math.isfinite(metrics["loss"]):
            raise AssertionError(f"loss {metrics['loss']} is not finite")
        losses.append(metrics["loss"])
        if train_mode:
            step_ms.append(ms)
        what = "training epoch" if train_mode else "validation pass"
        drawn = (f"drawn from [{tc.num_parts_train - tc.cluster_jitter}, "
                 f"{tc.num_parts_train + tc.cluster_jitter})" if train_mode
                 else "fixed, cached for later passes")
        cut = "" if parts is None else (
            f"k={k} ({drawn}), partition {part_s:.4f} s, edge cut "
            f"{edge_cut_fraction(parts, sample.src, sample.dst):.4%}; ")
        g = [p.graph for p in pieces]
        log(f"  {what}: {cut}{len(pieces)} pieces; real nodes {min(x.n_nodes for x in g)}-"
            f"{max(x.n_nodes for x in g)}, edges {min(x.n_edges for x in g)}-"
            f"{max(x.n_edges for x in g)}, padded to {g[0].n_nodes_padded} / "
            f"{g[0].n_edges_padded}; sampler host {probe.seconds[-1]:.4f} s; "
            f"{'step' if train_mode else 'forward'} ms (CUDA events) median "
            f"{sorted(ms)[len(ms) // 2]:.3f}, min {min(ms):.3f}, max {max(ms):.3f}, sum "
            f"{sum(ms):.3f}; wall {wall:.4f} s; loss {metrics['loss']:.5f} "
            f"acc {metrics['accuracy']:.4f}")
        return steps.first

    reset_launches()
    piece_step = epoch(True)
    before = read_launches()
    groups = profile_run(torch, lambda: epoch(True), "training epoch", iters=1)
    in_epoch = {k: v - before[k] for k, v in read_launches().items()}
    epoch(False)
    torch.cuda.synchronize()
    total = read_launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in one piece step: { {k: v for k, v in piece_step.items() if v} }")
    if piece_step != expected_launches("batchnorm", "layer"):
        raise AssertionError(f"piece step launch counts {piece_step}, expected "
                             f"{expected_launches('batchnorm', 'layer')}")
    def spread(ms):  # median, and slowest over median
        med = sorted(ms)[len(ms) // 2]
        return med, max(ms) / med

    both = step_ms[0] + step_ms[1]
    log(f"  profiled epoch: device ms epilog_bwd {groups.get('port: epilog_bwd', 0.0):.3f}, "
        f"rev_bwd {groups.get('port: rev_bwd', 0.0):.3f}; slowest piece step / median "
        f"{spread(step_ms[1])[1]:.3f} in it, {spread(both)[1]:.3f} over both epochs")
    log("  profiled epoch, by kernel entry: device ms, launches, ms per launch")
    for name, count in in_epoch.items():
        if count:
            ms = groups.get(f"port: {name}", 0.0)
            log(f"    {name:30s} {ms:9.3f} {count:5d} {ms / count:8.4f}")
    log(f"  piece step ms over both epochs (CUDA events): median "
        f"{spread(both)[0]:.3f} of {len(both)}; sampler host s per "
        f"training epoch {[round(x, 4) for x in train_probe.seconds]}; peak device memory "
        f"{peak / 2**30:.3f} GiB; losses {[round(x, 5) for x in losses]}")
    del params, opt, sample
    gc.collect()
    torch.cuda.empty_cache()
    return {"cluster_piece_step_batchnorm_remat_layer": piece_step,
            "cluster_epochs_batchnorm": total}


def phase_cluster_genome(torch, data: Path, seed: int, device="cuda") -> dict:
    """ClusterGCN on the genome graph: the same pieces on the card and the
    CPU, one piece's gradients card vs CPU, then ``train()`` under a
    ClusterGCN config with a resume. Returns the piece step's launches."""
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset
    from gnnome_tpu_torch.train.cluster import make_cluster_sampler

    kw = dict(num_parts=16, batch_size=4, nb_pos_enc=16, seed=seed, jitter=4)
    pieces = {}
    for dev in (device, "cpu"):
        (_, s), = AssemblyGraphDataset(str(data), 16, device=dev)
        pieces[dev] = make_cluster_sampler(**kw)(s)
    got, ref = pieces[device], pieces["cpu"]
    if len(got) != len(ref) or len(got) < 2:
        raise AssertionError(f"{len(got)} pieces on the card, {len(ref)} on the CPU")
    for p, q in zip(got, ref):
        pairs = [(p.graph.src, q.graph.src), (p.graph.dst, q.graph.dst), (p.e_feat, q.e_feat),
                 (p.pe, q.pe), (p.y, q.y)]
        if p.graph.n_nodes_padded != q.graph.n_nodes_padded or not all(
                torch.equal(a.cpu(), b) for a, b in pairs) or not all(
                (getattr(p, k) == getattr(q, k)).all() for k in ("src", "dst", "read_length")):
            raise AssertionError("a ClusterGCN piece differs between the card and the CPU")
    log(f"  {len(got)} pieces (sampler {kw}), equal on the card and the CPU: nodes "
        f"{[x.graph.n_nodes for x in got]}, edges {[x.graph.n_edges for x in got]}, padded "
        f"to {got[0].graph.n_nodes_padded} / {got[0].graph.n_edges_padded}")
    # the piece with the most negative edges (a piece of only positive
    # edges would have pos_weight 0 and no gradient)
    neg = [float((1 - q.y[: q.graph.n_edges]).sum()) for q in ref]
    i = max(range(len(ref)), key=neg.__getitem__)
    launches = grads_against_cpu(torch, {device: got[i], "cpu": ref[i]}, seed,
                                 "batchnorm", f"piece {i} ({neg[i]:.0f} negative edges)",
                                 device)
    cfg = Config()
    cfg.train.num_parts_train, cfg.train.batch_size_train = 16, 4
    cfg.train.cluster_jitter = 4
    train_with_resume(cfg, data, WORK / "train" / "cluster", "ClusterGCN train()", device)
    return launches


def phase_pipeline(torch, device="cuda") -> dict:
    """The offline example through the pipeline's stages on the card;
    returns the launch counts of the whole run."""
    from gnnome_tpu_torch import example
    from gnnome_tpu_torch.data import native_bridge
    from gnnome_tpu_torch.data.builder import parse_fasta
    from gnnome_tpu_torch.evaluation.assembly import calculate_n50

    root = WORK / "example"
    shutil.rmtree(root, ignore_errors=True)
    cfg = example.synthetic_config(str(root))
    log(f"  synthetic_example: {cfg.model.num_gnn_layers} layers, D="
        f"{cfg.model.hidden_features}, {cfg.train.num_epochs} epochs, splits "
        f"{cfg.split.train} / {cfg.split.valid} / {cfg.split.test}; simulator and builder: "
        f"{'native' if native_bridge.available() else 'Python'}")
    reset_launches()
    t0 = time.perf_counter()
    results = example.synthetic_example(str(root), cfg=cfg, device=device)
    torch.cuda.synchronize()
    launches = read_launches()
    fasta = root / "data" / "experiments" / "test_example" / "assembly" / "0_assembly.fasta"
    contigs = parse_fasta(str(fasta)) if fasta.exists() else []
    lengths = [len(seq) for _, seq in contigs]
    log(f"  synthetic_example: {time.perf_counter() - t0:.2f} s; {fasta.relative_to(WORK)}: "
        f"{len(lengths)} contigs, N50 {calculate_n50(lengths) if lengths else 0}, total "
        f"{sum(lengths)} bp; quick evaluation {results}")
    if not lengths or not launches["gate_front"]:
        raise AssertionError("synthetic_example wrote no contigs or ran no kernel")
    return launches


def phase_bf16(torch, seed: int, f32_losses: dict, device="cuda") -> tuple[list, dict]:
    """compute_dtype="bfloat16": the bf16 entries against their plain
    versions at the main paths' shapes and on the most padded ClusterGCN
    piece; scoring with the shipped BatchNorm weights through ``eval_step``
    and of the seeded LayerNorm model (launches, ms, peak, probabilities
    against the f32 forward, two forwards alike bit for bit); the
    full-scale training steps of phase 4's paths beside its f32 losses; the
    D = 640 gate front and step; one ClusterGCN epoch under the default
    Config. Returns the kernel rows and the launch counts by path."""
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.data.synthetic import bench_features, bench_labels, build_bench_graph
    from gnnome_tpu_torch.decode.inference import load_model, score_graph
    from gnnome_tpu_torch.models.model import init_model_params
    from gnnome_tpu_torch.train import loop

    graph, _ = build_bench_graph(N_NODES, N_EDGES, seed=seed, device=device)
    log(f"  local bench graph: {graph.n_nodes} nodes, {graph.n_edges} edges")
    with torch.inference_mode():
        rows = phase_parity_bf16(torch, graph, seed)
        piece = piece_graph(seed, device)
        log(f"  piece graph: {piece.n_nodes} / {piece.n_edges} real nodes / edges in "
            f"{piece.n_nodes_padded} / {piece.n_edges_padded} rows")
        for row, got in zip(rows, phase_parity_bf16(torch, piece, seed)):
            row["piece"] = {k: got[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}
        del piece
    torch.cuda.empty_cache()
    paths = {}

    cfg = Config()
    params = load_model(str(WEIGHTS), cfg, device)
    e_feat, pe = bench_features(graph, seed, cfg.model.nb_pos_enc)
    y = bench_labels(graph, seed)
    pos_weight = torch.tensor(POS_WEIGHT, device=device)

    def forward():
        return loop.eval_step(params, graph, e_feat, pe, y, pos_weight,
                              compute_dtype="bfloat16")[2]

    log(f"  scoring, BatchNorm model, weights {WEIGHTS.relative_to(ROOT)} cast to bf16 "
        "in the forward (eval_step, compute_dtype='bfloat16')")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits = forward()
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in one bf16 forward: { {k: v for k, v in launches.items() if v} }")
    if launches != expected_launches("batchnorm_bf16", None):
        raise AssertionError(f"launch counts {launches}, expected "
                             f"{expected_launches('batchnorm_bf16', None)}")
    paths["scoring_bf16"] = launches
    if logits.dtype != torch.float32 or tuple(logits.shape) != (graph.n_edges_padded,) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"bf16 logits: {logits.dtype} {tuple(logits.shape)}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = forward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(again, logits):
            raise AssertionError("a second bf16 forward gave other logits")
    times.sort()
    with torch.no_grad():
        ref = score_graph(params, graph, e_feat, pe)
    real = slice(0, graph.n_edges)
    dprob = float((torch.sigmoid(logits[real]) - torch.sigmoid(ref[real])).abs().max())
    log(f"  bf16 forward ms (3 runs, host clock after synchronize): "
        f"{[round(t, 3) for t in times]}; median {times[1]:.3f}; logits of every forward "
        f"equal bit for bit; peak device memory {peak / 2**30:.3f} GiB; max |prob bf16 - "
        f"prob f32| {dprob:.4e}, max |logit difference| "
        f"{float((logits[real] - ref[real]).abs().max()):.4e}")
    profile_run(torch, forward, "bf16 forward")
    del params, logits, again, ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  scoring, LayerNorm model (batch_norm=False), seeded random weights (seed {seed}) "
        "cast to bf16 in the forward")
    params = init_model_params(torch.Generator().manual_seed(seed), cfg.model, device)
    paths["scoring_layernorm_bf16"] = phase_scoring(torch, graph, params, cfg, seed,
                                                    "layernorm", "bfloat16")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    training, losses = phase_training(torch, graph, seed, compute_dtype="bfloat16")
    for run in TRAIN_RUNS:
        log(f"  {run[0]}, remat={run[1]!r}: losses of the same 4 steps, bf16 "
            f"{[round(x, 5) for x in losses[run]]}, f32 (phase 4) "
            f"{[round(x, 5) for x in f32_losses[run]]}")
        paths[f"train_step_{run[0]}_bf16_remat_{run[1]}"] = training[run]
    paths[f"train_step_batchnorm_bf16_d{WIDE_D}"] = phase_wide_bf16(torch, graph, seed)
    del graph
    gc.collect()
    torch.cuda.empty_cache()
    paths["cluster_piece_step_batchnorm_bf16_remat_layer"] = phase_cluster_bf16(torch, seed,
                                                                              device)
    return rows, paths


WIDE_D, WIDE_LAYERS = 640, 4  # the bf16 step above D = 512, at a cut depth


def phase_wide_bf16(torch, graph, seed: int) -> dict:
    """The bf16 gate front at D = WIDE_D (five column blocks of 128, each
    with its W3 slice resident) against its plain version, timed beside its
    bound, then one bf16 BatchNorm ``"layer"`` step of a
    WIDE_LAYERS-deep, WIDE_D-wide model (every bf16 entry of the narrow
    path at that width, ``epilog_bwd_bf16``'s instance for rows of 80
    chunks among them): launch counts, a finite loss, ms; returns the
    step's launch counts."""
    from gnnome_tpu_torch.config import ModelConfig
    from gnnome_tpu_torch.data.synthetic import bench_features, bench_labels
    from gnnome_tpu_torch.models.model import init_model_params
    from gnnome_tpu_torch.ops.gate_front import gate_front, gate_front_plain
    from gnnome_tpu_torch.train.loop import make_optimizer, train_step

    dev, bf, d = graph.device, torch.bfloat16, WIDE_D
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    n, e, er = graph.n_nodes_padded, graph.n_edges_padded, graph.n_edges
    with torch.inference_mode():
        args = (randn(n, d), randn(n, d), randn(e, d), randn(d, d, scale=d ** -0.5),
                randn(d), graph.src, graph.dst, er)
        err = check_gate_front_bf16(torch, gate_front(*args), gate_front_plain(*args), args)
        ms = time_ms(torch, lambda: gate_front(*args))
        u_src = int(torch.unique(graph.src[:er]).numel())
        u_dst = int(torch.unique(graph.dst[:er]).numel())
        b_ms, b_by = bound((2 * e * d + (u_src + u_dst) * d + d * d + d) * 2 + 2 * d * 4
                           + 2 * e * 4, 2 * e * d * d, BF16_TC_OPS_PER_S)
        log(f"  gate_front_bf16 at D = {d}: max_abs_err={err:.3e} (tol see "
            f"check_gate_front_bf16) ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        del args
    cfg = ModelConfig(hidden_features=d, num_gnn_layers=WIDE_LAYERS)
    e_feat, pe = bench_features(graph, seed, cfg.nb_pos_enc)
    y = bench_labels(graph, seed)
    params = init_model_params(torch.Generator().manual_seed(seed), cfg, dev)
    opt = make_optimizer(params, LR)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        loss, _ = train_step(params, opt, graph, e_feat, pe, y,
                             torch.tensor(POS_WEIGHT, device=dev), remat="layer",
                             compute_dtype="bfloat16")
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"bf16 D = {d} step: loss {losses[-1]} is not finite")
        if len(times) == 1:
            launches = read_launches()
    want = expected_launches("batchnorm_bf16", "layer", layers=WIDE_LAYERS)
    if launches != want:
        raise AssertionError(f"bf16 D = {d} step launch counts {launches}, expected {want}")
    log(f"  bf16 BatchNorm step, D = {d}, {WIDE_LAYERS} layers, remat='layer': ms "
        f"{[round(t, 3) for t in times]}; "
        f"losses {[round(x, 5) for x in losses]}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches as stated, "
        f"no f32 entry")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_cluster_bf16(torch, seed: int, device="cuda") -> dict:
    """One ClusterGCN training epoch of ``_epoch_pass`` under the default
    Config with compute_dtype="bfloat16" on the local bench graph; returns
    the launch counts of one piece step."""
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.models.model import init_model_params
    from gnnome_tpu_torch.train import loop

    cfg = Config()
    cfg.train.compute_dtype = "bfloat16"
    train_fn, _ = loop.make_cluster_fns(cfg)
    sample = bench_sample(torch, seed, device)
    params = init_model_params(torch.Generator().manual_seed(seed), cfg.model, device)
    opt = loop.make_optimizer(params, LR)
    pos_weight = torch.tensor(POS_WEIGHT, device=device)
    probe = SamplerProbe(train_fn)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with StepProbe(torch, loop, "train_step") as steps:
        t0 = time.perf_counter()
        metrics = loop._epoch_pass([(0, sample)], params, opt, pos_weight, cfg, True, probe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ms = steps.ms()
    if not math.isfinite(metrics["loss"]):
        raise AssertionError(f"bf16 ClusterGCN epoch: loss {metrics['loss']} is not finite")
    if steps.first != expected_launches("batchnorm_bf16", "layer"):
        raise AssertionError(f"bf16 piece step launch counts {steps.first}, expected "
                             f"{expected_launches('batchnorm_bf16', 'layer')}")
    g = [p.graph for p in probe.pieces[-1]]
    log(f"  bf16 ClusterGCN training epoch (default Config, compute_dtype='bfloat16'): "
        f"{len(g)} pieces, real edges {min(x.n_edges for x in g)}-{max(x.n_edges for x in g)} "
        f"padded to {g[0].n_edges_padded}; sampler host {probe.seconds[-1]:.4f} s; piece step "
        f"ms (CUDA events) median {sorted(ms)[len(ms) // 2]:.3f}, min {min(ms):.3f}, max "
        f"{max(ms):.3f}; wall {wall:.4f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; loss {metrics['loss']:.5f}; "
        f"launches of a piece step as stated")
    del params, opt, sample
    gc.collect()
    torch.cuda.empty_cache()
    return steps.first


# ---------------------------------------------------------------------------
# phase 11: decode at chromosome scale, host engine against the walk kernel
# ---------------------------------------------------------------------------
CHASE_L2_INTS = 1 << 20  # 4 MB: past the L1, inside the 50 MB L2
CHASE_HBM_INTS = 1 << 26  # 256 MB: past the L2
CHASE_HOPS = 200_000
DECODE_HUB = 40  # successors of one node, predecessors of another: K = 40 > 32


def decode_problem(seed: int, frac_long: float, n_nodes: int, n_edges: int) -> dict:
    """The decode arguments of a bench graph: the distinct (src, dst) pairs
    of ``bench_edges`` in first-occurrence order, their successor and
    predecessor lists and edge ids, read lengths of 10-30 kb and per edge a
    prefix length below its source read's length, from ``seed``."""
    import numpy as np

    from gnnome_tpu_torch.data.synthetic import bench_edges

    src, dst = bench_edges(n_nodes, n_edges, seed, frac_long)
    _, first = np.unique(src.astype(np.int64) * n_nodes + dst, return_index=True)
    first.sort()
    src, dst = src[first].astype(np.int64), dst[first].astype(np.int64)
    return dict(src=src, dst=dst, **adjacency_lists(src, dst, n_nodes),
                **read_lengths(np.random.default_rng(seed), src, n_nodes))


def adjacency_lists(src, dst, n_nodes: int) -> dict:
    su, du = src.tolist(), dst.tolist()
    succs = {i: [] for i in range(n_nodes)}
    preds = {i: [] for i in range(n_nodes)}
    for u, v in zip(su, du):
        succs[u].append(v)
        preds[v].append(u)
    return dict(succs=succs, preds=preds, edges=dict(zip(zip(su, du), range(len(su)))))


def read_lengths(rng, src, n_nodes: int) -> dict:
    read_length = rng.integers(10_000, 30_000, n_nodes)
    return dict(read_length=read_length, prefix_length=rng.integers(1_000, read_length[src]))


def decode_args(p: dict, scores) -> tuple:
    return (p["src"], p["dst"], scores, p["succs"], p["preds"], p["edges"],
            p["prefix_length"], p["read_length"])


def read_latency_ns(torch, n_ints: int, seed: int) -> float:
    """ns of one dependent global read: ``csrc/walk.cu``'s one-thread
    pointer chase over a random cycle of ``n_ints`` int32 (CUDA events)."""
    from gnnome_tpu_torch.ops.cuda_lib import I32, I64, P, Kernel

    chase = Kernel("pointer_chase", "gnnome_pointer_chase", [P, I64, I32, P],
                   source="gnnome_tpu_torch/csrc/walk.cu", replaces="")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    perm = torch.randperm(n_ints, generator=gen, device="cuda", dtype=torch.int64)
    nxt = torch.empty(n_ints, dtype=torch.int32, device="cuda")
    nxt[perm] = perm.roll(-1).to(torch.int32)  # one cycle through every slot
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    ms = time_ms(torch, lambda: chase(nxt.device, nxt.data_ptr(), CHASE_HOPS,
                                      int(perm[0]), out.data_ptr()), iters=3, warmup=1)
    return ms * 1e6 / CHASE_HOPS


class WalkProbe:
    """Wraps the decode's walk while it runs: CUDA events around each launch
    of the walk kernel (the wrapper's checks outside them), each leg's
    longest walk (kept on the card until the end) and the first leg's
    inputs."""

    def __init__(self, torch):
        from gnnome_tpu_torch.decode import device_walker

        self.torch, self.module = torch, device_walker
        self.walk_batch, self.kernel = device_walker.walk_batch, device_walker.WALK
        self.events, self.longest, self.first = [], [], None
        device_walker.walk_batch, device_walker.WALK = self.walk, self

    def __call__(self, device, *args):  # the kernel's launch
        start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        self.kernel(device, *args)
        end.record()
        self.events.append((start, end))

    def walk(self, tables, starts, vg, frozen, min_score, max_steps, out=None):
        if self.first is None:
            self.first = (tables, starts.clone(), vg.clone(),
                          None if frozen is None else frozen.clone(), min_score, max_steps)
        res = self.walk_batch(tables, starts, vg, frozen, min_score, max_steps, out=out)
        self.longest.append(res.lengths.max())
        return res

    def close(self) -> tuple[float, int]:
        """(kernel ms, Σ of each leg's longest walk); unwraps."""
        self.module.walk_batch, self.module.WALK = self.walk_batch, self.kernel
        self.torch.cuda.synchronize()
        return (sum(s.elapsed_time(e) for s, e in self.events),
                int(sum(int(x) for x in self.longest)))


def seed_draw_ms(p: dict, scores, nb_paths: int, seed: int, reps: int = 5) -> float:
    """ms of the O(E) host work that opens every iteration of the decode's
    outer loop (both engines): the alive edges of the remaining graph, their
    probabilities and the draw of ``nb_paths`` seed edges; median of
    ``reps`` on an empty visited set."""
    import numpy as np

    from gnnome_tpu_torch.decode.greedy import sample_edges

    src, dst = p["src"], p["dst"]
    rng = np.random.default_rng(seed)
    probs = 1.0 / (1.0 + np.exp(-np.asarray(scores, dtype=np.float64)))
    not_self, vg = src != dst, np.zeros(len(p["read_length"]) + 1, np.uint8)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        keep = vg == 0
        alive_ids = np.nonzero(not_self & keep[src] & keep[dst])[0]
        alive_ids[sample_edges(probs[alive_ids], nb_paths, rng)]
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def check_walk_kernel(torch, p, scores, label: str, seed: int, device="cuda") -> int:
    """The walk kernel against ``walk_batch_plain`` on the card: a forward
    leg from every node against a random global visited set, then a
    backward leg frozen on its marks, without a floor and with one; walks,
    lengths, base counts and visited rows equal. Returns the table width K."""
    import numpy as np

    from gnnome_tpu_torch.decode.device_walker import (
        NO_FLOOR, PaddedAdjacency, walk_batch, walk_batch_plain)

    n = len(p["read_length"])
    n_pad, max_steps = n + (n & 1), n + 2
    rng = np.random.default_rng(seed)
    vg = torch.from_numpy((rng.random(n_pad) < 0.1).astype(np.uint8)).to(device)
    starts = torch.arange(n, dtype=torch.int32, device=device)
    k = 0
    for floor in (NO_FLOOR, 0.0):
        frozen = None
        for reverse in (False, True):
            tables = PaddedAdjacency(p["preds"] if reverse else p["succs"], p["edges"],
                                     scores, p["prefix_length"], n_pad,
                                     reverse=reverse).tensors(device)
            got = walk_batch(tables, starts, vg, frozen, floor, max_steps)
            ref = walk_batch_plain(tables, starts, vg, frozen, floor, max_steps)
            for name, a, b in zip(got._fields, got, ref):
                if not torch.equal(a, b):
                    raise AssertionError(f"walk kernel [{label}, floor {floor}, "
                                         f"{'backward' if reverse else 'forward'}]: {name} "
                                         "differs from walk_batch_plain")
            frozen, k = got.visited, max(k, tables.nbr.shape[1])
            log(f"  walk kernel = walk_batch_plain [{label}, {n} walks, K = "
                f"{tables.nbr.shape[1]}, {'backward' if reverse else 'forward'}, floor "
                f"{floor}]: longest walk {int(got.lengths.max())}, walks, lengths, bp and "
                "visited rows equal")
    return k


def hub_decode_problem(seed: int) -> dict:
    """A bench graph of 2,000 nodes with one node of ``DECODE_HUB``
    successors and one of as many predecessors (K > 32)."""
    import numpy as np

    p = decode_problem(seed, 0.0, 2_000, 12_000)
    src, dst = p["src"].tolist(), p["dst"].tolist()
    have = set(zip(src, dst))
    extra = [(0, v) for v in range(100, 100 + 2 * DECODE_HUB, 2)] + \
        [(u, 2) for u in range(300, 300 + 2 * DECODE_HUB, 2)]
    extra = [e for e in extra if e not in have]
    src = np.array(src + [u for u, _ in extra])
    dst = np.array(dst + [v for _, v in extra])
    return dict(src=src, dst=dst, **adjacency_lists(src, dst, 2_000),
                **read_lengths(np.random.default_rng(seed), src, 2_000))


def phase_decode(torch, data: Path, params, cfg, seed: int, device="cuda") -> dict:
    """Decode at chromosome scale (see the module docstring); the walk
    kernel's row of the kernel table."""
    import numpy as np

    from gnnome_tpu_torch.core.graph import build_graph, extract_edge_values
    from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset, get_info
    from gnnome_tpu_torch.data.pe import pagerank_pe_np, pagerank_pe_torch
    from gnnome_tpu_torch.data.synthetic import bench_features
    from gnnome_tpu_torch.decode import greedy
    from gnnome_tpu_torch.decode.device_walker import WALK, walk_batch, walk_batch_plain
    from gnnome_tpu_torch.decode.inference import score_graph

    latency = {name: read_latency_ns(torch, n_ints, seed)
               for name, n_ints in (("l2", CHASE_L2_INTS), ("hbm", CHASE_HBM_INTS))}
    log(f"  one dependent global read (pointer chase, {CHASE_HOPS} hops): "
        f"{latency['l2']:.1f} ns over {CHASE_L2_INTS * 4 >> 20} MB (L2), "
        f"{latency['hbm']:.1f} ns over {CHASE_HBM_INTS * 4 >> 20} MB (HBM)")

    # the kernel against its plain version on small graphs
    (_, sample), = AssemblyGraphDataset(str(data), cfg.model.nb_pos_enc, device="cpu")
    genome = dict(src=np.asarray(sample.src), dst=np.asarray(sample.dst),
                  succs=get_info(0, str(data), "succ"), preds=get_info(0, str(data), "pred"),
                  edges=get_info(0, str(data), "edges"),
                  prefix_length=np.asarray(sample.prefix_length),
                  read_length=np.asarray(sample.read_length))
    rng = np.random.default_rng(seed)
    check_walk_kernel(torch, genome, rng.standard_normal(len(genome["src"])).astype(np.float32),
                      "phase 5's genome graph", seed, device)
    hub = hub_decode_problem(seed)
    k = check_walk_kernel(torch, hub, rng.standard_normal(len(hub["src"])).astype(np.float32),
                          f"bench graph with {DECODE_HUB}-neighbour hubs", seed, device)
    if k <= 32:
        raise AssertionError(f"the hub graph's tables are {k} wide; more than 32 expected")

    nb_paths, len_threshold = cfg.decode.num_decoding_paths, cfg.decode.len_threshold
    runs, launches, first = {}, 0, None
    for label, frac_long in (("local", 0.0), ("cross-locus", FRAC_LONG)):
        t0 = time.perf_counter()
        p = decode_problem(seed, frac_long, N_NODES, N_EDGES)
        graph = build_graph(p["src"], p["dst"], N_NODES, device=device)
        e_feat, pe = bench_features(graph, seed, cfg.model.nb_pos_enc)
        logits = score_graph(params, graph, e_feat, pe)
        scores = extract_edge_values(graph, logits).astype(np.float32)
        log(f"  {label}: {N_NODES} nodes, {len(p['src'])} distinct edges, scored with "
            f"{WEIGHTS.name} in f32; set-up {time.perf_counter() - t0:.2f} s")
        if label == "local":
            args = (graph.src, graph.dst, graph.edge_mask, graph.n_nodes_padded,
                    cfg.model.nb_pos_enc, graph.n_nodes)
            got = pagerank_pe_torch(*args)
            if not torch.equal(got, pagerank_pe_torch(*args)):
                raise AssertionError("pagerank_pe_torch: two calls gave other bits")
            src_np, dst_np = graph.src[: graph.n_edges].cpu().numpy(), \
                graph.dst[: graph.n_edges].cpu().numpy()
            err = check_close("pagerank_pe_torch", torch, got[: graph.n_nodes].cpu(),
                              torch.from_numpy(pagerank_pe_np(src_np, dst_np, graph.n_nodes,
                                                              cfg.model.nb_pos_enc)), 1e-4, 0.0)
            log(f"  pagerank_pe_torch: two calls alike bit for bit; against pagerank_pe_np "
                f"(f64) max abs err {err:.3e} (tol rtol=1e-4)")
        del graph, e_feat, pe, logits
        torch.cuda.empty_cache()
        kw = dict(nb_paths=nb_paths, len_threshold=len_threshold, seed=seed, device=device)
        t0 = time.perf_counter()
        host = greedy.get_contigs(*decode_args(p, scores), engine="batched", **kw)
        host_s = time.perf_counter() - t0
        reset_launches()
        probe = WalkProbe(torch)
        t0 = time.perf_counter()
        try:
            dev = greedy.get_contigs(*decode_args(p, scores), engine="device", **kw)
            torch.cuda.synchronize()
        finally:
            dev_s = time.perf_counter() - t0
            kernel_ms, steps = probe.close()
        n_launch = read_launches()["walk"]
        if n_launch != len(probe.longest) or n_launch == 0:
            raise AssertionError(f"walk: {n_launch} launches counted, "
                                 f"{len(probe.longest)} legs walked")
        launches += n_launch
        if dev != host:
            at = next((i for i, (a, b) in enumerate(zip(dev, host)) if a != b),
                      min(len(dev), len(host)))
            raise AssertionError(f"{label}: the device engine's contigs differ from the host "
                                 f"engine's from contig {at} ({len(dev)} against {len(host)})")
        longest = max(map(len, host), default=0)
        draw_ms = seed_draw_ms(p, scores, nb_paths, seed)
        rate = steps / (kernel_ms * 1e3) if kernel_ms else float("nan")
        bound_rate = 1e3 / latency["l2"]
        log(f"  {label}: host engine ('batched') {host_s:.3f} s; device engine {dev_s:.3f} s "
            f"(walk kernel {kernel_ms:.3f} ms in {n_launch} launches, host outer loop and "
            f"copies {dev_s - kernel_ms / 1e3:.3f} s); {len(host)} contigs, longest walk "
            f"{longest} nodes; walks equal; kernel {rate:.4f} steps/us along each launch's "
            f"longest leg (Σ {steps}) against {bound_rate:.4f} at one L2 read a step; an "
            f"iteration's O(E) seed draw on the host {draw_ms:.3f} ms")
        runs[label] = dict(host_s=host_s, device_s=dev_s, kernel_ms=kernel_ms,
                           host_loop_s=dev_s - kernel_ms / 1e3, launches=n_launch,
                           contigs=len(host), longest_walk=longest, steps=steps,
                           steps_per_us=rate, bound_steps_per_us=bound_rate,
                           seed_draw_ms=draw_ms)
        if first is None:
            first = probe.first
        del p, scores, host, dev

    # the kernel row: the local graph's first leg (its longest walks)
    tables, starts, vg, frozen, floor, max_steps = first
    got = walk_batch(tables, starts, vg, frozen, floor, max_steps)
    plain_start, plain_end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    plain_start.record()
    ref = walk_batch_plain(tables, starts, vg, frozen, floor, max_steps)
    plain_end.record()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError("walk kernel: the first leg differs from walk_batch_plain")
    ms = time_ms(torch, lambda: walk_batch(tables, starts, vg, frozen, floor, max_steps),
                 iters=5, warmup=1)
    leg = int(got.lengths.max())
    bound_ms = leg * latency["l2"] * 1e-6
    log(f"  walk [local, first leg, {starts.shape[0]} walks, longest {leg} steps]: "
        f"max_abs_err=0 (exact) ms={ms:.4f} plain_ms={plain_start.elapsed_time(plain_end):.4f} "
        f"library_ms=null bound_ms={bound_ms:.4f} ({leg} dependent reads of "
        f"{latency['l2']:.1f} ns)")
    return dict(name=WALK.name, route="cuda", source=WALK.source, replaces=WALK.replaces,
                launches=launches, max_abs_err=0.0, ms=ms,
                plain_ms=plain_start.elapsed_time(plain_end), bound_ms=bound_ms,
                bound_by="bytes", library_ms=None,
                note=("not a TPU kernel: the device walk of decode (engine='device'); "
                      "launches: both graphs' decodes; times: the local graph's first leg; "
                      "bound: its longest walk's steps, each one dependent global read "
                      "(one-thread pointer chase, L2-resident), not bytes over the memory "
                      "rate"),
                read_latency_ns=latency, decode=runs)


# ---------------------------------------------------------------------------
# phase 12: the sharded step (gnnome_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

# (graph, model, depth) of each P = 2 run; the LayerNorm model at 4 layers
# to hold the phase's time (two ranks share one card over gloo)
SHARDED_JOBS = (("cross-locus", "batchnorm", 16), ("cross-locus", "layernorm", 4),
                ("local", "batchnorm", 16), ("local", "layernorm", 4))
SHARDED_FRAC_LONG = {"cross-locus": FRAC_LONG, "local": 0.0}
SHARDED_TIMEOUT_S = 600  # the P = 2 ranks' join
# P = 2 against the single card: the shards sum their edges, and the
# all-reduces the shards, in another order. The loss is held to
# tests/test_sharded.py's 2e-5. Rank 0's parameter gradients, per leaf as in
# grad_errors, are held per graph to (worst leaf, median leaf), set from
# this phase's sound readings on an NVIDIA H100 80GB HBM3 at 700 W: local
# worst 2.3e-3 (layer 0's A2 bias, near cancellation), median 5.5e-5;
# cross-locus, where the halo carries 24.7k rows a rank, worst 1.6e-4, median
# 4.8e-5; the 4-layer LayerNorm model at most 2.1e-6. The cross-locus
# limits sit about 10x above those readings and far below what a planted
# backward fault reads (PERF.md, phase 12).
SHARDED_GRAD_TOL = {"local": (1e-2, 5e-4), "cross-locus": (2e-3, 5e-4)}
SHARDED_LOSS_TOL = 2e-5


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_sample(torch, seed: int, label: str):
    """The ``label`` bench graph on the card, padded as the sharded batch
    pads it (nodes to 512, edges to 1024: at P = 1 the two layouts are then
    one), with bench features and labels."""
    from gnnome_tpu_torch.core.graph import build_graph
    from gnnome_tpu_torch.data.dataset import GraphSample
    from gnnome_tpu_torch.data.synthetic import bench_edges, bench_features, bench_labels

    src, dst = bench_edges(N_NODES, N_EDGES, seed, SHARDED_FRAC_LONG[label])
    graph = build_graph(src, dst, N_NODES, node_pad_multiple=512, edge_pad_multiple=1024,
                        device="cuda")
    e_feat, pe = bench_features(graph, seed, 16)
    return GraphSample(idx=0, graph=graph, e_feat=e_feat, pe=pe, y=bench_labels(graph, seed),
                       prefix_length=None, read_length=None, overlap_length=None,
                       overlap_similarity=None, src=src, dst=dst)


def expected_sharded_launches(variant: str, layers: int, halo: bool) -> dict:
    """One sharded step under ``remat="layer"``: the single card's kernels
    (:func:`expected_launches`), and with a halo, per layer forward (twice:
    the checkpoint runs it again) the send gathers of ``b1h`` and ``a2h``
    and the halo reduce's segment sum over the send CSR (a by_src layout),
    per layer backward their transposes (two segment sums, one gather);
    the score head's exchange adds a gather and its segment sum."""
    counts = expected_launches(variant, "layer", layers)
    if halo:
        tail = "_bf16" if variant.endswith("_bf16") else ""
        counts["take_rows" + tail] += 2 * 2 * layers + 1
        counts["segment_sum_by_src" + tail] += 2 * layers + 1
        counts["segment_sum_by_src"] += 2 * layers  # the reduce's sums are f32
        counts["take_rows"] += layers
    return counts


def timed_steps(torch, step, n: int = 3, barrier=None) -> list:
    """Host ms of ``n`` calls of ``step``, each after a synchronize (and
    the ranks' ``barrier``) and ending in one; sorted."""
    times = []
    for _ in range(n):
        if barrier is not None:
            barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def phase_sharded_p1(torch, sample, seed: int) -> dict:
    """P = 1 over NCCL: the sharded step of the 16-layer, D=256 BatchNorm
    model in f32 and bf16 against ``train_step`` on the same graph and
    weights, bit for bit (the same kernels on the same layouts); returns
    the launch counts of each."""
    import torch.distributed as dist

    from gnnome_tpu_torch.config import ModelConfig
    from gnnome_tpu_torch.models.model import init_model_params
    from gnnome_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from gnnome_tpu_torch.parallel.sharded import (
        make_sharded_train_step, prepare_batch, shard_batch)
    from gnnome_tpu_torch.train.checkpoint import iter_leaves
    from gnnome_tpu_torch.train.loop import make_optimizer, train_step

    dev = initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0)
    try:
        probe = torch.arange(4.0, device=dev)
        got = torch.empty_like(probe)
        dist.all_to_all_single(got, probe)
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        if not torch.equal(got, probe):
            raise AssertionError("an all-to-all over one rank moved the data")
        log(f"  process group: backend {dist.get_backend()}, world size "
            f"{dist.get_world_size()}, {dev}; an all-reduce and an all-to-all on it ran")
        mesh = make_mesh()
        if mesh.device != dev:
            raise AssertionError(f"the mesh is on {mesh.device}, the rank on {dev}")
        g = sample.graph
        shard = shard_batch(prepare_batch([sample], mesh), mesh)
        if shard.n_halo or shard.by_key.key.shape != g.by_dst.key.shape:
            raise AssertionError("P = 1: the shard is not the padded graph")
        pos_weight = torch.tensor(POS_WEIGHT, device=dev)
        out = {}
        for cdt in ("float32", "bfloat16"):
            label = f"batchnorm{'_bf16' if cdt != 'float32' else ''}"
            sets = {}
            for who in ("train_step", "sharded"):
                params = init_model_params(torch.Generator().manual_seed(seed), ModelConfig(),
                                           dev)
                opt = make_optimizer(params, LR)
                if who == "train_step":
                    def run(params=params, opt=opt):
                        return train_step(params, opt, g, sample.e_feat, sample.pe, sample.y,
                                          pos_weight, remat="layer", compute_dtype=cdt)[0]
                else:
                    step = make_sharded_train_step(mesh, remat="layer", compute_dtype=cdt)

                    def run(params=params, opt=opt, step=step):
                        return step(params, opt, shard, POS_WEIGHT)
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                loss = run()
                torch.cuda.synchronize()
                launches = read_launches()
                grads = {k: leaf.grad.clone() for k, leaf in iter_leaves(params)}
                times = timed_steps(torch, run)
                sets[who] = dict(loss=loss, grads=grads, launches=launches, ms=times,
                                 peak=torch.cuda.max_memory_allocated())
                del params, opt
            a, b = sets["train_step"], sets["sharded"]
            if b["launches"] != expected_launches(label, "layer"):
                raise AssertionError(f"P = 1 {label}: launch counts {b['launches']}, expected "
                                     f"{expected_launches(label, 'layer')}")
            differ = [k for k in a["grads"] if not torch.equal(a["grads"][k], b["grads"][k])]
            bitwise = torch.equal(a["loss"], b["loss"]) and not differ
            log(f"  P = 1 ({dist.get_backend()}), {label}, remat 'layer': loss "
                f"{float(b['loss']):.7f} (train_step {float(a['loss']):.7f}); loss and "
                f"gradients bit for bit: "
                f"{bitwise}; launches checked")
            if not bitwise:
                errs, _ = grad_errors(b["grads"], a["grads"])
                raise AssertionError(f"P = 1 {label}: the sharded step and train_step differ "
                                     f"(leaves {differ[:4]}, worst {max(errs.values()):.3e})")
            log(f"  P = 1 {label}: step ms (3, host clock after synchronize) sharded "
                f"{[round(t, 3) for t in b['ms']]} median {b['ms'][1]:.3f}, train_step "
                f"{[round(t, 3) for t in a['ms']]} median {a['ms'][1]:.3f}; peak device "
                f"memory sharded {b['peak'] / 2**30:.3f} GiB, train_step "
                f"{a['peak'] / 2**30:.3f} GiB")
            out[f"sharded_p1_nccl_{label}_remat_layer"] = b["launches"]
            del sets
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_sharded_p2(torch, samples: dict, seed: int) -> dict:
    """P = 2 ranks on the one card over gloo (NCCL refuses two ranks on one
    device), each a process of this script (``--sharded-worker``) that
    builds its graphs from the seed, for each of SHARDED_JOBS against the
    single card's step; returns rank 0's launch counts of each step."""
    from gnnome_tpu_torch.config import ModelConfig
    from gnnome_tpu_torch.models.model import init_model_params
    from gnnome_tpu_torch.train.checkpoint import iter_leaves
    from gnnome_tpu_torch.train.loop import make_optimizer, train_step

    refs = {}
    pos_weight = torch.tensor(POS_WEIGHT, device="cuda")
    for label, variant, layers in SHARDED_JOBS:
        s = samples[label]
        params = init_model_params(torch.Generator().manual_seed(seed),
                                   ModelConfig(num_gnn_layers=layers), "cuda")
        opt = make_optimizer(params, LR)
        loss, _ = train_step(params, opt, s.graph, s.e_feat, s.pe, s.y, pos_weight,
                             batch_norm=VARIANTS[variant][0], remat="layer")
        refs[(label, variant)] = (float(loss), {k: leaf.grad.cpu()
                                                for k, leaf in iter_leaves(params)})
        del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    job = WORK / "sharded_job.json"
    job.write_text(json.dumps(dict(port=free_port(), seed=seed, jobs=SHARDED_JOBS,
                                   work=str(WORK))))
    for r in range(2):
        (WORK / f"sharded_rank{r}.json").unlink(missing_ok=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--sharded-worker", str(job), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SHARDED_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        (WORK / f"sharded_rank{r}.log").write_text(o)
        if p.returncode != 0:
            raise RuntimeError(f"P = 2 rank {r} failed (rc {p.returncode}):\n{o[-4000:]}")
    log(f"  two ranks ran in {time.perf_counter() - t0:.1f} s (logs: sharded_rank*.log in "
        f"the phases' work directory)")
    ranks = [json.loads((WORK / f"sharded_rank{r}.json").read_text()) for r in range(2)]
    for label, h in ranks[0]["halo"].items():
        log(f"  {label} graph, P = 2: N_pad {h['n_pad']}, edge bucket {h['bucket']}, real "
            f"edges per shard {h['real_edges']}; P·H {h['send_slots']} send slots per rank, "
            f"halo rows {h['halo_rows']} (rows a rank sends its peer); halo_comm_bytes per "
            f"layer (f32, D = 256) {h['halo_bytes_per_layer']} against an all-gather's "
            f"{h['all_gather_bytes_per_layer']}; graph and host batch built in each rank "
            f"{[r['halo'][label]['host_s'] for r in ranks]} s")
    out, failed = {}, []
    for label, variant, layers in SHARDED_JOBS:
        key = f"{label}_{variant}"
        r0, r1 = ranks[0][key], ranks[1][key]
        ref_loss, ref_grads = refs[(label, variant)]
        grads = torch.load(WORK / f"sharded_grads_{key}.pt")
        errs, noise = grad_errors(grads, ref_grads)
        worst = max(errs, key=errs.get)
        median = sorted(errs.values())[len(errs) // 2]
        worst_tol, median_tol = SHARDED_GRAD_TOL[label]
        expect = expected_sharded_launches(variant, layers, halo=True)
        what = f"P = 2 {label} {variant} ({layers} layers)"
        log(f"  {what}: backend {r0['backend']} on {r0['device']}; loss {r0['loss']:.7f} "
            f"(ranks alike: {r0['loss'] == r1['loss']}; single card {ref_loss:.7f}, rel "
            f"{abs(r0['loss'] - ref_loss) / abs(ref_loss):.2e}, tol {SHARDED_LOSS_TOL}); "
            f"rank 0 gradients against the single card: worst leaf {worst} "
            f"{errs[worst]:.3e} (tol {worst_tol}), median {median:.3e} (tol {median_tol}), "
            f"noise leaves at most {max(noise.values(), default=0.0):.2e}; parameters after "
            f"the step alike bit for bit: {r0['params_sha'] == r1['params_sha']}; two "
            f"forwards alike bit for bit: {r0['forward_equal'] and r1['forward_equal']}")
        log(f"  {what}: step ms (3, host clock after synchronize, rank 0) "
            f"{[round(t, 1) for t in r0['ms']]} median {r0['ms'][1]:.1f} (two ranks share "
            f"one card; gloo stages the halo through the host; not a scaling number); peak "
            f"device memory per rank {[round(r['peak'] / 2**30, 3) for r in (r0, r1)]} GiB")
        problems = []
        if r0["loss"] != r1["loss"] or abs(r0["loss"] - ref_loss) > SHARDED_LOSS_TOL * (
                1 + abs(ref_loss)):
            problems.append("loss")
        if errs[worst] > worst_tol or median > median_tol \
                or max(noise.values(), default=0.0) > 10 * NOISE:
            problems.append("gradients")
        if r0["params_sha"] != r1["params_sha"]:
            problems.append("the ranks' parameters differ after the step")
        if not (r0["forward_equal"] and r1["forward_equal"]):
            problems.append("a second forward gave other logits")
        # a rank registers only the kernels of the modules it imports
        launches = dict.fromkeys(expect, 0)
        launches.update((k, int(v)) for k, v in r0["launches"].items())
        if launches != expect:
            problems.append(f"launch counts {launches}, expected {expect}")
        if problems:
            failed.append(f"{what}: {problems}")
        out[f"sharded_p2_gloo_{label}_{variant}_remat_layer"] = launches
    if failed:  # every job read and logged first
        raise AssertionError("; ".join(failed))
    return out


def sharded_worker(job_path: str, rank: int) -> int:
    """One rank of phase 12's P = 2 runs: gloo on this card, every job of
    the phase's job file, each graph built here from the seed; writes its
    results beside the job file."""
    import hashlib

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from gnnome_tpu_torch.config import ModelConfig
    from gnnome_tpu_torch.models.model import init_model_params
    from gnnome_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from gnnome_tpu_torch.parallel.sharded import (
        halo_comm_bytes, make_sharded_train_step, prepare_batch, replicate_to_mesh,
        shard_batch, sharded_forward)
    from gnnome_tpu_torch.train.checkpoint import iter_leaves
    from gnnome_tpu_torch.train.loop import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    job = json.loads(Path(job_path).read_text())
    dev = initialize_distributed(f"tcp://localhost:{job['port']}", 2, rank, backend="gloo",
                                 timeout_s=300)
    mesh = make_mesh(1, 2, timeout_s=300)
    if mesh.device != dev:
        raise AssertionError(f"the mesh is on {mesh.device}, the rank on {dev}")
    work = Path(job["work"])
    out, halo, shards = {}, {}, {}
    for label, variant, layers in job["jobs"]:
        if label not in shards:
            shards.clear()
            t0 = time.perf_counter()
            batch = prepare_batch([sharded_sample(torch, job["seed"], label)], mesh)
            shards[label] = shard_batch(batch, mesh)
            comm = halo_comm_bytes(batch, hidden=256, dtype_bytes=4)
            halo[label] = dict(
                n_pad=comm["n_pad"], bucket=int(batch.fwd.mask.shape[-1]),
                real_edges=[int(m.sum()) for m in batch.fwd.mask[0]],
                send_slots=int(batch.fwd.send_idx.shape[-1]),
                halo_rows=[int(batch.fwd.send_offsets[0, p, -1]) for p in range(2)],
                halo_bytes_per_layer=comm["halo_bytes_per_layer"],
                all_gather_bytes_per_layer=comm["all_gather_bytes_per_layer"],
                host_s=round(time.perf_counter() - t0, 2))
            del batch
            gc.collect()
            torch.cuda.empty_cache()
        shard = shards[label]
        key = f"{label}_{variant}"
        batch_norm = VARIANTS[variant][0]
        params = replicate_to_mesh(init_model_params(
            torch.Generator().manual_seed(job["seed"]), ModelConfig(num_gnn_layers=layers),
            dev), mesh)
        with torch.no_grad():
            first = sharded_forward(params, shard, mesh, batch_norm=batch_norm)
            forward_equal = torch.equal(first, sharded_forward(params, shard, mesh,
                                                               batch_norm=batch_norm))
        del first
        opt = make_optimizer(params, LR)
        step = make_sharded_train_step(mesh, batch_norm=batch_norm, remat="layer")
        dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        loss = step(params, opt, shard, POS_WEIGHT)
        torch.cuda.synchronize()
        launches = read_launches()
        if rank == 0:
            torch.save({k: leaf.grad.cpu() for k, leaf in iter_leaves(params)},
                       work / f"sharded_grads_{key}.pt")
        sha = hashlib.sha256()
        for _, leaf in iter_leaves(params):
            sha.update(leaf.detach().cpu().numpy().tobytes())
        times = timed_steps(torch, lambda: step(params, opt, shard, POS_WEIGHT),
                            barrier=dist.barrier)
        out[key] = dict(loss=float(loss), forward_equal=forward_equal, launches=launches,
                        params_sha=sha.hexdigest(), ms=times,
                        peak=torch.cuda.max_memory_allocated(), backend=dist.get_backend(),
                        device=str(dev))
        print(f"rank {rank} {key}: loss {float(loss):.7f}, ms {times}", flush=True)
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
    out["halo"] = halo
    (work / f"sharded_rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def phase_sharded(torch, seed: int) -> dict:
    """Phase 12: (a) P = 1 over NCCL, (b) P = 2 on one card over gloo;
    returns the launch counts of each sharded step."""
    log("  (a) P = 1 over NCCL, local graph, 16 layers, D = 256, BatchNorm")
    samples = {"local": sharded_sample(torch, seed, "local")}
    out = phase_sharded_p1(torch, samples["local"], seed)
    log("  (b) P = 2 ranks on one card over gloo (cross-locus and local graphs)")
    samples["cross-locus"] = sharded_sample(torch, seed, "cross-locus")
    out.update(phase_sharded_p2(torch, samples, seed))
    del samples
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sharded-worker", nargs=2, metavar=("JOB", "RANK"),
                    help="run one rank of phase 12's P = 2 runs (the phase starts them)")
    args = ap.parse_args()

    import torch

    if args.sharded_worker:
        return sharded_worker(args.sharded_worker[0], int(args.sharded_worker[1]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "gnnome_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: gnnome_tpu_torch/ not found beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    WORK.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.data.synthetic import build_bench_graph
    from gnnome_tpu_torch.decode.inference import load_model
    from gnnome_tpu_torch.models.model import init_model_params
    from gnnome_tpu_torch.ops import cuda_lib

    log("phase 1: build")
    cached = cuda_lib.library_path().exists()
    t0 = time.perf_counter()
    # the native host library (partitioner, builder, simulator) builds with
    # the Makefile's g++ beside nvcc's builds; CXX=g++ on the command line,
    # since a CXX in the environment overrides the Makefile's (one without
    # OpenMP's libgomp fails to link it)
    make = subprocess.Popen(["make", "-s", "-j3", "-C", str(ROOT / "native"), "CXX=g++"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        cuda_lib.library()
        log(f"  {cuda_lib.library_path().relative_to(ROOT)}: "
            f"{time.perf_counter() - t0:.2f} s ({'cached' if cached else 'built now'})")
        make_out, _ = make.communicate(timeout=600)
    finally:
        if make.poll() is None:
            make.kill()
            make.wait()
    from gnnome_tpu_torch.data import native_bridge

    native_bridge._load.cache_clear()
    if make.returncode != 0 or not native_bridge.available():
        raise RuntimeError(f"make -C native failed (rc {make.returncode}) or the library "
                           f"is not usable (GNNOME_FORCE_PYTHON set?):\n{make_out}")
    log(f"  {Path(native_bridge.lib_path()).relative_to(ROOT)}: ready "
        f"{time.perf_counter() - t0:.2f} s after the start (g++, beside nvcc)")

    log(f"phase 2: kernel parity at the main path's shapes (seed {args.seed})")
    graphs = {}
    for label, frac_long in (("local", 0.0), ("cross-locus", FRAC_LONG)):
        t0 = time.perf_counter()
        graph, n_edges = build_bench_graph(N_NODES, N_EDGES, seed=args.seed,
                                           frac_long=frac_long, device="cuda")
        reach = (graph.dst[:n_edges].long() - graph.src[:n_edges].long()).abs()
        far = float((reach > LOCAL_REACH).float().mean())
        log(f"  {label} bench graph: {graph.n_nodes} nodes, {n_edges} edges, "
            f"{far:.2%} reaching over {LOCAL_REACH} node ids, built in "
            f"{time.perf_counter() - t0:.2f} s")
        graphs[label] = graph
    with torch.inference_mode():
        kernels = phase_parity(torch, graphs["local"], args.seed)
        log("  cross-locus graph:")
        for row, cross in zip(kernels, phase_parity(torch, graphs["cross-locus"], args.seed)):
            row["cross_locus"] = {k: cross[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        # every entry on the padded ClusterGCN piece; the edge walks on a
        # hub row
        for label, make in (("piece", piece_graph), ("hub", hub_graph)):
            g = make(args.seed)
            deg = [int(c.offsets[1:].sub(c.offsets[:-1]).max()) for c in (g.by_dst, g.by_src)]
            log(f"  {label} graph: {g.n_nodes} nodes padded to {g.n_nodes_padded}, "
                f"{g.n_edges} edges padded to {g.n_edges_padded} ({g.n_edges_padded - g.n_edges} "
                f"padded edges, {1 - g.n_edges / g.n_edges_padded:.2%} of the rows); largest "
                f"in-degree {deg[0]}, out-degree {deg[1]}")
            if label == "piece":
                got = {r["name"]: r for r in phase_parity(torch, g, args.seed)}
            else:
                got = phase_walks(torch, g, args.seed, label)
            for row in kernels:
                if row["name"] in got:
                    row[label] = {k: got[row["name"]][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            del g
    torch.cuda.empty_cache()

    log("phase 3: full-scale scoring (16 layers, D=256)")
    log(f"  card: {card_name_and_power()}")
    cfg = Config()  # the shipped models' shapes: D=256, 16 layers, PE 16
    scoring = {}
    log(f"  BatchNorm model, weights: {WEIGHTS.relative_to(ROOT)}")
    params = load_model(str(WEIGHTS), cfg, "cuda")
    log("  cross-locus graph:")
    phase_scoring(torch, graphs["cross-locus"], params, cfg, args.seed, "batchnorm")
    log("  local graph:")
    scoring["scoring"] = phase_scoring(torch, graphs["local"], params, cfg, args.seed,
                                       "batchnorm")
    log(f"  LayerNorm model (batch_norm=False), seeded random weights (seed {args.seed})")
    params = init_model_params(torch.Generator().manual_seed(args.seed), cfg.model, "cuda")
    log("  cross-locus graph:")
    phase_scoring(torch, graphs.pop("cross-locus"), params, cfg, args.seed, "layernorm")
    log("  local graph:")
    scoring["scoring_layernorm"] = phase_scoring(torch, graphs["local"], params, cfg,
                                                 args.seed, "layernorm")
    del params
    torch.cuda.empty_cache()

    log("phase 4: full-scale training steps (16 layers, D=256)")
    training, f32_losses = phase_training(torch, graphs.pop("local"), args.seed)

    log("phase 5: end to end, reads to contigs")
    data = phase_end_to_end(torch, cfg, WEIGHTS, args.seed)

    log("phase 6: gradients on the card against the CPU, and train() with a resume")
    genome = phase_gradients_and_loop(torch, data, args.seed)

    log("phase 7: ClusterGCN training at full width under the default Config")
    cluster = phase_cluster(torch, args.seed)

    log("phase 8: ClusterGCN pieces and gradients, card against CPU; train() under it")
    genome["cluster_piece_batchnorm"] = phase_cluster_genome(torch, data, args.seed)

    log("phase 9: the pipeline: example.synthetic_example on the card")
    pipeline_launches = phase_pipeline(torch)

    log("phase 10: bf16 compute (compute_dtype='bfloat16'), every model")
    bf16_rows, bf16_paths = phase_bf16(torch, args.seed, f32_losses)
    kernels += bf16_rows

    log("phase 11: decode at chromosome scale, the host engine against the walk kernel")
    with torch.inference_mode():
        walk_row = phase_decode(torch, data, load_model(str(WEIGHTS), cfg, "cuda"), cfg,
                                args.seed)
    torch.cuda.empty_cache()

    log("phase 12: the sharded step (parallel/sharded.py): P = 1 over NCCL, P = 2 on one "
        "card over gloo")
    t0 = time.perf_counter()
    sharded_paths = phase_sharded(torch, args.seed)
    log(f"  phase 12: {time.perf_counter() - t0:.1f} s")

    # the kernel table's launch counts: one full-scale step of the first
    # training path that runs the kernel; every path's count beside it
    paths = {**scoring, **{f"train_step_{v}_remat_{r}": c for (v, r), c in training.items()},
             **{f"genome_step_{v}_remat_layer": c for v, c in genome.items()},
             **cluster, "synthetic_example": pipeline_launches, **bf16_paths,
             **sharded_paths}
    steps = [training[run] for run in TRAIN_RUNS] + \
        [bf16_paths[f"train_step_{v}_bf16_remat_{r}"] for v, r in TRAIN_RUNS]
    for row in kernels:
        name = row["name"]
        row["launches"] = next((c[name] for c in steps if c[name]), 0)
        row["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        row["on_path"] = any(c[name] for c in paths.values())
        if not row["on_path"]:
            row["note"] = ("the JAX package's route only where TPU band plans exist; "
                           "the model takes sigma_reverse_sum on every graph")

    kernels.append(walk_row)

    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card_name_and_power())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
