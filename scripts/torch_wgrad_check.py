#!/usr/bin/env python3
"""How the bf16 weight-gradient products of one training step round.

    python3 scripts/torch_wgrad_check.py [--seed N] [--layers L] [--variants V ...]
                                         [--chunks C ...]

Runs one full-scale bf16 training step (``compute_dtype="bfloat16"``,
``remat="layer"``, the default ``ModelConfig`` widths, ``--layers`` deep)
of each model variant on ``chip_smoke.py``'s local bench graph (150k nodes,
999,995 edges) and holds every weight-gradient product of the step (each
call of ``ops/dense.py``'s ``weight_grad``: the gate front's
``d_W3 = eᵀ·d_total`` and each dense product's ``d_w = xᵀ·g``, with
reduction lengths E or N) against the same product taken in f64 and
rounded once to bf16. Printed per product shape, for the port's product
(an f32 result rounded once), for a bf16-output cuBLAS product of the same
operands (``xᵀ.mm(g)``, what autograd would take) and for the f32 product
(unrounded: f32 accumulation's own error): the largest error in bf16 ulps
of the reference, how many elements lie more than one ulp off, and the
largest error before the rounding (against the f64 product itself)
relative to ``|x|ᵀ·|g|``, the scale of the terms summed.
With ``--chunks``, also for a product split into C chunks of the
reduction (one batched f32-result product, the chunks summed in f32 and
rounded once), with the ms of it and of the port's product on the same
operands (CUDA events, 5 calls). Also prints PyTorch's
``allow_bf16_reduced_precision_reduction`` (read, never set). Needs an
NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def bf16_ulp(torch, x):
    """The spacing of bf16 at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().double().clamp_min(2.0 ** -126))) - 7)


class ProductLog:
    """Per product shape, the errors of each form of the product against
    the f64 product rounded once to bf16."""

    def __init__(self, torch, chunks=()):
        self.torch = torch
        self.chunks = tuple(chunks)
        self.stats = defaultdict(lambda: defaultdict(float))

    def _ms(self, fn) -> float:
        torch = self.torch
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 5

    def _chunked(self, a, b, c: int):
        """``a.t() @ b`` as c chunks of the reduction in one f32-result
        batched product, summed in f32 and rounded once to bf16."""
        torch = self.torch
        kc = -(-a.shape[0] // c)
        pad = (0, 0, 0, kc * c - a.shape[0])
        ac = torch.nn.functional.pad(a, pad).view(c, kc, a.shape[1])
        bc = torch.nn.functional.pad(b, pad).view(c, kc, b.shape[1])
        return torch.bmm(ac.transpose(1, 2), bc, out_dtype=torch.float32).sum(0).to(a.dtype)

    def add(self, a, b, port) -> None:
        """The port's product ``port`` of ``a.t() @ b`` (bf16 ``a`` [K, M],
        ``b`` [K, N])."""
        torch = self.torch
        ref64 = a.double().t() @ b.double()
        scale = a.double().abs().t() @ b.double().abs()
        ref = ref64.to(torch.bfloat16).double()
        ulp = bf16_ulp(torch, ref)
        forms = {"port": port.double(), "bf16_out": a.t().mm(b).double(),
                 "f32": (a.float().t() @ b.float()).double()}
        s = self.stats[f"K={a.shape[0]} [{a.shape[1]}, {b.shape[1]}]"]
        if self.chunks:
            s["port_ms"] += self._ms(lambda: torch.mm(a.t(), b, out_dtype=torch.float32).to(
                a.dtype))
        for c in self.chunks:
            forms[f"chunks{c}"] = self._chunked(a, b, c).double()
            s[f"chunks{c}_ms"] += self._ms(lambda c=c: self._chunked(a, b, c))
        s["products"] += 1
        s["elements"] += ref.numel()
        for name, x in forms.items():
            err = (x - ref).abs()
            s[f"{name}_max_ulps"] = max(s[f"{name}_max_ulps"], float((err / ulp).max()))
            s[f"{name}_over_1_ulp"] += int((err > ulp).sum())
            s[f"{name}_max_rel_scale"] = max(
                s[f"{name}_max_rel_scale"],
                float(((x - ref64).abs() / scale.clamp_min(1e-300)).max()))
        del ref64, scale, ref, ulp, forms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--variants", nargs="+",
                    default=["batchnorm", "layernorm", "wide", "layernorm_wide"])
    ap.add_argument("--chunks", nargs="*", type=int, default=[])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_wgrad_check: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from gnnome_tpu_torch.config import ModelConfig
    from gnnome_tpu_torch.data.synthetic import bench_features, bench_labels, build_bench_graph
    from gnnome_tpu_torch.models.model import init_model_params
    from gnnome_tpu_torch.ops import dense, gate_front
    from gnnome_tpu_torch.train.loop import make_optimizer, train_step

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{cs.card_name_and_power()}", flush=True)
    print("torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}", flush=True)
    graph, _ = build_bench_graph(cs.N_NODES, cs.N_EDGES, seed=args.seed, device="cuda")
    cfg = ModelConfig(num_gnn_layers=args.layers)
    e_feat, pe = bench_features(graph, args.seed, cfg.nb_pos_enc)
    y = bench_labels(graph, args.seed)
    log = ProductLog(torch, args.chunks)

    # every weight-gradient product goes through ops/dense.py's weight_grad
    # (the gate front's d_W3 imports it by name)
    orig = dense.weight_grad

    def weight_grad(x, g):
        out = orig(x, g)
        if x.dtype == torch.bfloat16:
            log.add(x.detach(), g.detach(), out)
        return out

    dense.weight_grad = gate_front.weight_grad = weight_grad
    results = {}
    for variant in args.variants:
        batch_norm, wide = cs.VARIANTS[variant]
        params = init_model_params(torch.Generator().manual_seed(args.seed), cfg, "cuda")
        opt = make_optimizer(params, cs.LR)
        log.stats.clear()
        loss, _ = train_step(params, opt, graph, e_feat, pe, y,
                             torch.tensor(cs.POS_WEIGHT, device="cuda"),
                             batch_norm=batch_norm, remat="layer", wide_gathers=wide,
                             compute_dtype="bfloat16")
        torch.cuda.synchronize()
        results[variant] = {k: dict(v) for k, v in log.stats.items()}
        print(f"{variant} ({args.layers} layers, D = {cfg.hidden_features}), loss "
              f"{float(loss):.5f}:", flush=True)
        for kind, st in results[variant].items():
            print(f"  {kind}: {int(st['products'])} products, {int(st['elements'])} elements"
                  + "".join(f"; {f}: max {st[f + '_max_ulps']:.3f} ulps, "
                            f"{int(st[f + '_over_1_ulp'])} over one ulp, max err / (|x|ᵀ|g|) "
                            f"{st[f + '_max_rel_scale']:.3e}"
                            for f in ("port", "bf16_out", "f32",
                                      *(f"chunks{c}" for c in args.chunks))), flush=True)
            if args.chunks:
                print("    ms (sum over the products): port " + f"{st['port_ms']:.4f}" + "".join(
                    f", chunks{c} {st[f'chunks{c}_ms']:.4f}" for c in args.chunks), flush=True)
        del params, opt
        torch.cuda.empty_cache()
    print(json.dumps({"wgrad": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
