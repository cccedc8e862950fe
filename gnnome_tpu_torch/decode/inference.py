"""Inference: score assembly graphs with a trained model, decode contigs.

Counterpart of ``gnnome_tpu/decode/inference.py``; reference
``inference.inference`` (``inference.py:404-508``). Scoring is one
full-graph forward on the device; decoding runs on the host
(:mod:`gnnome_tpu_torch.decode.greedy`). Artifacts are the JAX package's:
``<data>/inference/<idx>_walks.pkl``, ``<data>/assembly/<idx>_assembly.fasta``
and, on simulated data, ``<data>/inference/<idx>_coord.json``.
"""
from __future__ import annotations

import json
import os
import pickle
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from gnnome_tpu_torch.config import Config
from gnnome_tpu_torch.core.graph import extract_edge_values
from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset, get_info
from gnnome_tpu_torch.decode import greedy
from gnnome_tpu_torch.evaluation import assembly as asm
from gnnome_tpu_torch.evaluation.metrics import classification_metrics, confusion_counts
from gnnome_tpu_torch.models.model import init_model_params, model_forward
from gnnome_tpu_torch.train.checkpoint import load_params
from gnnome_tpu_torch.train.loop import resolve_perf


@torch.inference_mode()
def score_graph(params, graph, e_feat, pe, batch_norm: bool = True,
                wide_gathers=False) -> torch.Tensor:
    """Per-edge logits in canonical order (f32[E_pad])."""
    return model_forward(params, graph, e_feat, pe, batch_norm=batch_norm,
                         wide_gathers=wide_gathers)


def load_model(model_path: str, cfg: Config, device="cuda"):
    """Parameters of a JAX-format ``.npz`` for ``cfg.model``, on ``device``."""
    template = init_model_params(torch.Generator().manual_seed(0), cfg.model, device)
    return load_params(model_path, template)


def inference(
    data_path: str,
    model_path: str,
    cfg: Optional[Config] = None,
    baselines: bool = False,
    log_fn=print,
    ref_lengths: Optional[dict] = None,
    device="cuda",
) -> Tuple[List[List[List[int]]], List[List[Tuple[str, str]]]]:
    """Returns ``(walks_per_graph, contigs_per_graph)`` like ``inference.py:404``.

    ``baselines=True`` also decodes by raw overlap_length and
    overlap_similarity (``inference.py:280-401``) and saves ``*_ol_len`` /
    ``*_ol_sim`` assemblies and walks. On simulated graphs each decoder's
    walks also get the coordinate evaluation (misassemblies, NGA50, genome
    fraction; ``ref_lengths`` maps graph idx → reference length).
    """
    cfg = cfg or Config()
    params = load_model(model_path, cfg, device)
    ds = AssemblyGraphDataset(data_path, nb_pos_enc=cfg.model.nb_pos_enc,
                              device=device)

    inference_dir = os.path.join(data_path, "inference")
    os.makedirs(inference_dir, exist_ok=True)

    walks_per_graph: List[List[List[int]]] = []
    contigs_per_graph: List[List[Tuple[str, str]]] = []

    for idx, sample in ds:
        g = sample.graph
        t0 = time.time()
        logits = score_graph(params, g, sample.e_feat, sample.pe,
                             batch_norm=cfg.model.batch_norm,
                             wide_gathers=resolve_perf(cfg.train, g)[0])
        # device scores are canonical-order; decode indexes parser order
        scores = extract_edge_values(g, logits).astype(np.float64)
        log_fn(f"graph {idx}: scored {g.n_edges} edges in {time.time()-t0:.2f}s")

        counts = confusion_counts(logits[: g.n_edges], sample.y[: g.n_edges])
        m = classification_metrics(counts)
        log_fn(
            f"graph {idx}: acc={m['accuracy']:.4f} precision={m['precision']:.4f} "
            f"recall={m['recall']:.4f} f1={m['f1']:.4f} "
            f"fp_rate={m['fp_rate']:.4f} fn_rate={m['fn_rate']:.4f}"
        )

        succs = get_info(idx, data_path, "succ")
        preds = get_info(idx, data_path, "pred")
        edges = get_info(idx, data_path, "edges")
        reads = get_info(idx, data_path, "reads")

        t0 = time.time()
        walks = greedy.get_contigs(
            sample.src, sample.dst, scores, succs, preds, edges,
            sample.prefix_length, sample.read_length,
            nb_paths=cfg.decode.num_decoding_paths,
            len_threshold=cfg.decode.len_threshold,
            seed=cfg.train.seed,
            min_prob=cfg.decode.min_prob,
        )
        log_fn(f"graph {idx}: decoded {len(walks)} walks in {time.time()-t0:.2f}s")
        with open(os.path.join(inference_dir, f"{idx}_walks.pkl"), "wb") as f:
            pickle.dump(walks, f)

        ref_len = int((ref_lengths or {}).get(idx, 0))

        def coord_report(walks_x, suffix):
            cm = asm.coordinate_evaluation(
                walks_x, np.asarray(sample.read_strand),
                np.asarray(sample.read_start), np.asarray(sample.read_end),
                ref_length=ref_len,
            )
            log_fn(
                f"graph {idx}{suffix}: misassemblies={cm['n_misassemblies']} "
                f"genome_fraction={cm['genome_fraction']:.4f} "
                f"NGA50={cm['nga50']:,} longest_correct={cm['longest_correct']:,}"
            )
            with open(os.path.join(inference_dir, f"{idx}_coord{suffix}.json"),
                      "w") as f:
                json.dump(cm, f)

        has_coords = np.asarray(sample.read_end)[: g.n_nodes].max(initial=0) > 0
        if has_coords:
            coord_report(walks, "")

        contigs = asm.walk_to_sequence(walks, reads, sample.prefix_length, edges)
        asm.save_assembly(contigs, data_path, idx)
        walks_per_graph.append(walks)
        contigs_per_graph.append(contigs)

        if baselines:
            for metric, suffix in (
                (sample.overlap_length.astype(np.float64), "_ol_len"),
                (sample.overlap_similarity.astype(np.float64), "_ol_sim"),
            ):
                # the same confidence-floor lever as min_prob, as a feature
                # quantile over real edges (DecodeConfig docstring)
                q = cfg.decode.baseline_min_quantile
                min_score_b = (
                    float(np.quantile(metric[sample.src != sample.dst], q))
                    if q > 0.0 else None
                )
                walks_b = greedy.get_contigs(
                    sample.src, sample.dst, metric, succs, preds, edges,
                    sample.prefix_length, sample.read_length,
                    nb_paths=cfg.decode.num_decoding_paths,
                    len_threshold=cfg.decode.len_threshold,
                    seed=cfg.train.seed,
                    min_score=min_score_b,
                )
                with open(os.path.join(inference_dir,
                                       f"{idx}_walks{suffix}.pkl"), "wb") as f:
                    pickle.dump(walks_b, f)
                if has_coords:
                    coord_report(walks_b, suffix)
                contigs_b = asm.walk_to_sequence(
                    walks_b, reads, sample.prefix_length, edges)
                asm.save_assembly(contigs_b, data_path, idx, suffix=suffix)

    return walks_per_graph, contigs_per_graph
