#!/usr/bin/env python3
"""Time the port's edge-walk and gate-front kernel entries of one checkout
on the card.

    python3 scripts/torch_bench_walks.py [--root DIR] [--seed N] [--shapes ...]
                                         [--parts walks fronts] [--widths ...]
                                         [--dtypes ...] [--steps] [--cluster]

``walks``: ``chip_smoke.py``'s phase-2 walk measurements (``phase_walks``:
the seven entries that walk edges, ``epilog_bwd`` and
``epilog_bwd_pregathered``, ``rev_bwd``, ``opp_bwd`` and the three
σ-aggregate backwards, each checked against its plain version and timed
with CUDA events beside its byte bound). ``fronts``: ``gate_front`` (f32)
and ``gate_front_bf16`` at each of ``--widths`` (default 256, 512, 640;
``--dtypes`` picks the entries),
each checked as ``chip_smoke.py`` checks it and timed beside its bound, its
plain version and ``torch.addmm(b3, e, W3)`` in the same dtype (the product
alone, a yardstick the port never calls); with bf16, also
``sigma_reverse_sum_bf16`` and ``gate_sigma_gather_bf16`` at D = 256 as
``chip_smoke.py`` phase 10 times them. Both run on
the local 150k / 1M bench graph, the padded ClusterGCN piece shape and the
hub graph (the walks only), with the ``gnnome_tpu_torch`` package found
under ``--root`` (default: this checkout). Pointing ``--root`` at an unpacked copy of another
commit (``git archive``) times that commit's kernels with this checkout's
shapes and byte counts, so two versions are compared in one call, in turns.
``--steps`` then times ``chip_smoke.py``'s phase-4 step of the BatchNorm
model under ``remat="layer"`` on the local graph in each of ``--dtypes``.
``--cluster`` then runs ``chip_smoke.py``'s phase 7 (two ClusterGCN epochs
and a validation pass under the default ``Config``) and its bf16 ClusterGCN
epoch with that package, after building its ``native/`` library. The last line is one JSON object:
the card, the root and the kernel times.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def time_reverse_sum_bf16(torch, cs, graph, seed: int, label: str) -> dict:
    """``sigma_reverse_sum_bf16`` at D = 256 on ``graph``, on seeded
    inputs: checked against its plain version (1e-5), then timed beside its
    byte bound, as ``chip_smoke.py`` phase 10 does."""
    from gnnome_tpu_torch.ops.reverse_sum import sigma_reverse_sum, sigma_reverse_sum_plain

    dev, d = graph.device, 256
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, e, er = graph.n_nodes_padded, graph.n_edges_padded, graph.n_edges
    u_dst = int(torch.unique(graph.dst[:er]).numel())
    args = tuple((torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
                 for shape in ((e, d), (n, d))) + (graph.by_src, graph.dst)
    err = cs.check_close("sigma_reverse_sum_bf16", torch, sigma_reverse_sum(*args),
                         sigma_reverse_sum_plain(*args), cs.KERNEL_TOL, cs.KERNEL_TOL)
    b_ms, b_by = cs.bound((er * d + u_dst * d) * 2 + 2 * n * d * 4 + (2 * er + n + 1) * 4,
                          5 * e * d)
    m = dict(max_abs_err=err, ms=cs.time_ms(torch, lambda: sigma_reverse_sum(*args)),
             plain_ms=cs.time_ms(torch, lambda: sigma_reverse_sum_plain(*args)),
             bound_ms=b_ms, bound_by=b_by)
    cs.log(f"  {label} sigma_reverse_sum_bf16 D={d}: max_abs_err={err:.3e} ms={m['ms']:.4f} "
           f"plain_ms={m['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}, "
           f"{b_ms / m['ms']:.0%} of it)")
    return {"sigma_reverse_sum_bf16[256]": m}


def time_gate_sigma_gather_bf16(torch, cs, graph, seed: int, label: str) -> dict:
    """``gate_sigma_gather_bf16`` (row 2's bf16 entry) at D = 256 on
    ``graph``, on seeded inputs: checked against its plain version as
    ``chip_smoke.py`` phase 10 checks it, then timed beside its byte bound."""
    from gnnome_tpu_torch.ops.gate_epilog import gate_sigma_gather, gate_sigma_gather_plain

    dev, d = graph.device, 256
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, e = graph.n_nodes_padded, graph.n_edges_padded
    u_src = int(torch.unique(graph.src).numel())
    gate, e_in, values = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                          for shape in ((e, d), (e, d), (n, d)))
    affine = torch.stack([torch.rand(d, generator=gen, device=dev) + 0.5,
                          torch.randn(d, generator=gen, device=dev)])
    args = (gate, e_in, values, affine, graph.by_dst, graph.src)
    (sums, e_new), (ref_sums, ref_e_new) = gate_sigma_gather(*args), \
        gate_sigma_gather_plain(*args)
    err = max(cs.check_close("gate_sigma_gather_bf16.sums", torch, sums, ref_sums,
                             cs.KERNEL_TOL, cs.KERNEL_TOL),
              cs.check_bf16("gate_sigma_gather_bf16.e_new", torch, e_new, ref_e_new))
    b_ms, b_by = cs.bound((3 * e * d + u_src * d) * 2 + (2 * d + 2 * n * d) * 4
                          + (n + 1 + e) * 4, 8 * e * d)
    m = dict(max_abs_err=err, ms=cs.time_ms(torch, lambda: gate_sigma_gather(*args)),
             plain_ms=cs.time_ms(torch, lambda: gate_sigma_gather_plain(*args)),
             bound_ms=b_ms, bound_by=b_by)
    cs.log(f"  {label} gate_sigma_gather_bf16 D={d}: max_abs_err={err:.3e} ms={m['ms']:.4f} "
           f"plain_ms={m['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by})")
    return {"gate_sigma_gather_bf16": m}


def time_gate_fronts(torch, cs, graph, seed: int, label: str, widths,
                     dtypes=("float32", "bfloat16")) -> dict:
    """``gate_front`` and ``gate_front_bf16`` at each width on ``graph``,
    on seeded inputs: checked against the plain version, then timed. The
    bound counts each input once and each output once (4 or 2 bytes an
    element, 4 an id or an f32 moment) over the HBM rate, or the product
    (f32: three TF32 passes) over the tensor cores' rate."""
    from gnnome_tpu_torch.ops import gate_front as gf

    dev = graph.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, e, er = graph.n_nodes_padded, graph.n_edges_padded, graph.n_edges
    u_src = int(torch.unique(graph.src[:er]).numel())
    u_dst = int(torch.unique(graph.dst[:er]).numel())
    out = {}
    entries = [(dt, name) for dt, name in ((torch.float32, "gate_front"),
                                           (torch.bfloat16, "gate_front_bf16"))
               if str(dt).split(".")[-1] in dtypes]
    for d in widths:
        for dtype, name in entries:
            def randn(*shape, scale=1.0):
                return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

            args = (randn(n, d), randn(n, d), randn(e, d), randn(d, d, scale=d ** -0.5),
                    randn(d), graph.src, graph.dst, er)
            got, ref = gf.gate_front(*args), gf.gate_front_plain(*args)
            beyond = None
            if dtype == torch.float32:
                # chip_smoke.py holds the f32 entry to KERNEL_TOL at D = 256; at
                # other widths the elements beyond it are counted and printed
                diff = (got[0] - ref[0]).abs()
                beyond = int((diff > cs.KERNEL_TOL * (1 + ref[0].abs())).sum())
                if d == 256 and beyond:
                    raise AssertionError(f"{name}[{d}]: {beyond} elements beyond {cs.KERNEL_TOL}")
                err = max(float(diff.max()),
                          cs.check_close(f"{name}.mom/E", torch, got[1] / er, ref[1] / er,
                                         cs.KERNEL_TOL, cs.KERNEL_TOL))
                size, ops, rate = 4, 3 * 2 * e * d * d, cs.TF32_TC_OPS_PER_S
            else:
                err = cs.check_gate_front_bf16(torch, got, ref, args)
                size, ops, rate = 2, 2 * e * d * d, cs.BF16_TC_OPS_PER_S
            del got, ref
            n_bytes = (2 * e * d + (u_src + u_dst) * d + d * d + d) * size + 2 * d * 4 + 2 * e * 4
            b_ms, b_by = cs.bound(n_bytes, ops, rate)
            m = dict(max_abs_err=err, beyond_tol=beyond,
                     ms=cs.time_ms(torch, lambda: gf.gate_front(*args)),
                     plain_ms=cs.time_ms(torch, lambda: gf.gate_front_plain(*args)),
                     bound_ms=b_ms, bound_by=b_by,
                     addmm_ms=cs.time_ms(torch, lambda: torch.addmm(args[4], args[2], args[3])))
            plan = getattr(gf, "gate_front_bf16_plan", None)
            if dtype == torch.bfloat16 and plan is not None and dev.type == "cuda":
                sms = torch.cuda.get_device_properties(dev).multi_processor_count
                m["plan"] = plan(d, e, sms, True)._asdict()
            out[f"{name}[{d}]"] = m
            cs.log(f"  {label} {name} D={d}: max_abs_err={err:.3e}"
                   + ("" if beyond is None else f" ({beyond} beyond {cs.KERNEL_TOL})")
                   + f" ms={m['ms']:.4f} "
                   f"plain_ms={m['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}, "
                   f"{b_ms / m['ms']:.0%} of it) addmm_ms={m['addmm_ms']:.4f}"
                   + (f" plan={m['plan']}" if "plan" in m else ""))
            del args
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", nargs="*", default=["local", "piece", "hub"],
                    choices=["local", "piece", "hub"])
    ap.add_argument("--parts", nargs="*", default=["walks", "fronts"],
                    choices=["walks", "fronts"])
    ap.add_argument("--widths", nargs="*", type=int, default=[256, 512, 640])
    ap.add_argument("--dtypes", nargs="*", default=["float32", "bfloat16"],
                    choices=["float32", "bfloat16"])
    ap.add_argument("--cluster", action="store_true")
    ap.add_argument("--steps", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    # the package from --root first; chip_smoke (shapes, timing) from here
    sys.path[:0] = [str(root), str(REPO)]
    import torch

    if not torch.cuda.is_available():
        print("torch_bench_walks: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gnnome_tpu_torch.data.synthetic import build_bench_graph
    from gnnome_tpu_torch.ops import cuda_lib

    if not cuda_lib.PACKAGE_DIR.resolve().is_relative_to(root):
        raise RuntimeError(f"gnnome_tpu_torch came from {cuda_lib.PACKAGE_DIR}, not {root}")
    cuda_lib.library()
    makers = {"local": lambda: build_bench_graph(cs.N_NODES, cs.N_EDGES, seed=args.seed,
                                                 device="cuda")[0],
              "piece": lambda: cs.piece_graph(args.seed),
              "hub": lambda: cs.hub_graph(args.seed)}
    times = {}
    with torch.inference_mode():
        for label in args.shapes:
            graph = makers[label]()
            times[label] = {}
            if "walks" in args.parts:
                walks = cs.phase_walks(torch, graph, args.seed, label)
                times[label].update({name: {k: m[k] for k in ("ms", "plain_ms", "bound_ms")}
                                     for name, m in walks.items()})
            if "fronts" in args.parts and label != "hub":
                times[label].update(time_gate_fronts(torch, cs, graph, args.seed, label,
                                                     args.widths, args.dtypes))
                if "bfloat16" in args.dtypes:
                    times[label].update(time_reverse_sum_bf16(torch, cs, graph, args.seed,
                                                              label))
                    times[label].update(time_gate_sigma_gather_bf16(torch, cs, graph,
                                                                    args.seed, label))
            del graph
            torch.cuda.empty_cache()
    if args.steps:
        graph = makers["local"]()
        for dtype in args.dtypes:
            cs.phase_training(torch, graph, args.seed,
                              runs=(("batchnorm", "layer"),),
                              compute_dtype=dtype)
        del graph
        torch.cuda.empty_cache()
    if args.cluster:
        import subprocess

        from gnnome_tpu_torch.data import native_bridge

        subprocess.run(["make", "-s", "-j3", "-C", str(root / "native"), "CXX=g++"],
                       check=True)
        native_bridge._load.cache_clear()
        cs.phase_cluster(torch, args.seed)
        cs.phase_cluster_bf16(torch, args.seed)
    print(json.dumps({"card": cs.card_name_and_power(), "root": str(root),
                      "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
