#!/usr/bin/env python3
"""Digests of kernel entries' outputs, for comparing two checkouts.

    python3 scripts/torch_kernel_digest.py [--root DIR] [--seed N]

Runs each float32 entry of the kernel library of the ``gnnome_tpu_torch``
package under ``--root`` (default: this checkout) once on seeded inputs at
the main path's shapes (``chip_smoke.py``'s local 150k / 1M bench graph,
D = 256; the row gather also at 64 and 512, the segment sums also at 512),
then each bf16 entry of the BatchNorm narrow path (rows 1-9; the gate
front also at D = 512) on bf16 inputs, and prints one JSON line: the
sha256 of each output's bytes. Every entry sums in a fixed order, so the
same code gives the same bits in every process; two checkouts' lines are
equal exactly where their entries compute the same bits. Needs an NVIDIA
card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(REPO)]
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_digest: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gnnome_tpu_torch.data.synthetic import build_bench_graph
    from gnnome_tpu_torch.ops import cuda_lib
    from gnnome_tpu_torch.ops.gate_epilog import epilog_bwd, gate_sigma_gather
    from gnnome_tpu_torch.ops.gate_front import gate_front, gate_front_bwd
    from gnnome_tpu_torch.ops.reverse_sum import (
        opp_bwd, rev_bwd, sigma_opposite, sigma_reverse_sum)
    from gnnome_tpu_torch.ops.segment_sum import segment_sum
    from gnnome_tpu_torch.ops.sigma_aggregate import sigma_aggregate, sigma_aggregate_bwd
    from gnnome_tpu_torch.ops.take import take_rows

    if not cuda_lib.PACKAGE_DIR.resolve().is_relative_to(root):
        raise RuntimeError(f"gnnome_tpu_torch came from {cuda_lib.PACKAGE_DIR}, not {root}")
    g = build_bench_graph(cs.N_NODES, cs.N_EDGES, seed=args.seed, device="cuda")[0]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    n, e, d = g.n_nodes_padded, g.n_edges_padded, 256

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def digest(*outs):
        h = hashlib.sha256()
        for t in outs:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    node, node2, edge, edge2 = randn(n, d), randn(n, 2 * d), randn(e, d), randn(e, d)
    affine = torch.stack([torch.rand(d, generator=gen, device="cuda") + 0.5, randn(d)])
    out = {}
    with torch.inference_mode():
        for width in (64, d, 2 * d):
            out[f"take_rows[{width}]"] = digest(take_rows(randn(n, width), g.src))
        out["gate_front"] = digest(*gate_front(node, randn(n, d), edge, randn(d, d, scale=d ** -0.5),
                                               randn(d), g.src, g.dst, g.n_edges))
        out["gate_sigma_gather"] = digest(*gate_sigma_gather(edge, edge2, node, affine, g.by_dst,
                                                             g.src))
        out["gate_sigma_aggregate"] = digest(*gate_sigma_gather(edge, edge2, edge2, affine,
                                                                g.by_dst))
        out["sigma_reverse_sum"] = digest(sigma_reverse_sum(edge, node, g.by_src, g.dst))
        out["sigma_opposite"] = digest(sigma_opposite(edge, node, g.by_src))
        for name, csr, v, ids in (("gather", g.by_dst, node, g.src), ("", g.by_dst, edge2, None),
                                  ("by_src", g.by_src, edge2, None)):
            out[f"sigma_aggregate[{name}]"] = digest(sigma_aggregate(edge, v, csr, ids))
            out[f"sigma_aggregate_bwd[{name}]"] = digest(*sigma_aggregate_bwd(edge, node2, v, csr,
                                                                              ids))
        for width in (d, 2 * d):
            data = randn(e, width)
            out[f"segment_sum[{width}]"] = digest(segment_sum(data, g.by_dst),
                                                  segment_sum(data, g.by_src))
        out["gate_front_bwd"] = digest(*gate_front_bwd(edge, edge2, randn(2, d, scale=1e-6),
                                                       g.n_edges))
        out["epilog_bwd"] = digest(*epilog_bwd(edge, edge2, randn(e, d), node2, node, affine,
                                               g.by_dst, g.src))
        out["epilog_bwd_pregathered"] = digest(*epilog_bwd(edge, edge2, randn(e, d), node2, edge2,
                                                           affine, g.by_dst))
        out["rev_bwd"] = digest(*rev_bwd(edge, node2, node, g.by_src, g.dst))
        out["opp_bwd"] = digest(*opp_bwd(edge, node2, node, g.by_src))

        # the bf16 entries of rows 1-9 (f32 sums, moments, affine, g_sums)
        def bf(*shape, scale=1.0):
            return randn(*shape, scale=scale).to(torch.bfloat16)

        for width in (64, d):
            out[f"take_rows_bf16[{width}]"] = digest(take_rows(bf(n, width), g.src))
        for width in (d, 2 * d):
            out[f"gate_front_bf16[{width}]"] = digest(*gate_front(
                bf(n, width), bf(n, width), bf(e, width), bf(width, width, scale=width ** -0.5),
                bf(width), g.src, g.dst, g.n_edges))
        b_node, b_edge, b_edge2 = bf(n, d), bf(e, d), bf(e, d)
        out["gate_sigma_gather_bf16"] = digest(*gate_sigma_gather(b_edge, b_edge2, b_node,
                                                                  affine, g.by_dst, g.src))
        out["sigma_reverse_sum_bf16"] = digest(sigma_reverse_sum(b_edge, b_node, g.by_src, g.dst))
        out["segment_sum_bf16"] = digest(segment_sum(b_edge, g.by_dst),
                                         segment_sum(b_edge, g.by_src))
        out["gate_front_bwd_bf16"] = digest(*gate_front_bwd(b_edge, b_edge2,
                                                            randn(2, d, scale=1e-6), g.n_edges))
        out["epilog_bwd_bf16"] = digest(*epilog_bwd(b_edge, b_edge2, bf(e, d), node2, b_node,
                                                    affine, g.by_dst, g.src))
        out["rev_bwd_bf16"] = digest(*rev_bwd(b_edge, node2, b_node, g.by_src, g.dst))
        torch.cuda.synchronize()
    launched = sorted(k.name for k in cuda_lib.KERNELS.values() if k.launches)
    print(json.dumps({"card": cs.card_name_and_power(), "root": str(root),
                      "entries": launched, "digests": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
