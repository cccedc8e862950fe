"""Training loop: the step, plateau LR, checkpoints, metrics.

Counterpart of ``gnnome_tpu/train/loop.py`` (reference ``train.train``,
``train.py:115-533``):

  * one step is forward, BCE-with-logits with ``pos_weight``, backward
    (every sparse op's gradient on the backward kernels) and Adam
    (``train.py:209``; ``torch.optim.Adam`` with optax's defaults:
    betas (0.9, 0.999), eps 1e-8, no eps_root);
  * both regimes of the JAX package: full-graph steps, and the reference's
    METIS/ClusterGCN minibatches (``train.py:282-343``; ``train/cluster.py``)
    whenever ``num_parts_train > 1`` and ``batch_size_train > 1``, as in the
    default :class:`Config`; ``cluster_validation`` validates on pieces too;
  * ``ReduceLROnPlateau`` with the JAX package's (torch-compatible) rule;
  * pos_weight = 1 / the dataset's mean pos:neg ratio (``train.py:181``);
  * a checkpoint every epoch and best-on-valid-loss weights
    (``train.py:525-528``), in the JAX package's format, with resume.

``cfg.train.compute_dtype = "bfloat16"`` trains and scores every model
(BatchNorm or LayerNorm, narrow or wide gathers) in bf16 with f32 master
weights and Adam, as the JAX package does; :func:`train` refuses an
unknown dtype name before it reads any data.
"""
from __future__ import annotations

import os
import random
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from gnnome_tpu_torch.config import Config
from gnnome_tpu_torch.core.graph import AssemblyGraph
from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset, GraphSample
from gnnome_tpu_torch.evaluation.metrics import (
    bce_with_logits,
    classification_metrics,
    confusion_counts,
)
from gnnome_tpu_torch.models.model import (
    compute_dtype_of, count_params, init_model_params, model_forward)
from gnnome_tpu_torch.train import checkpoint as ckpt
from gnnome_tpu_torch.train.checkpoint import iter_leaves
from gnnome_tpu_torch.utils.logging import MetricsLogger
from gnnome_tpu_torch.utils.profiling import span

_COUNT_KEYS = ("tp", "tn", "fp", "fn")


class ReduceLROnPlateau:
    """torch-compatible plateau scheduler (mode='min'), the JAX package's
    own rule: the lr is scaled by ``factor`` once the metric has failed to
    improve more than ``patience`` times in a row."""

    def __init__(self, factor: float = 0.95, patience: int = 2, min_lr: float = 0.0):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return max(lr * self.factor, self.min_lr)
        return lr

    def state_dict(self) -> Dict[str, float]:
        return {"best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: Dict[str, float]) -> None:
        self.best = float(d.get("best", float("inf")))
        self.num_bad = int(d.get("num_bad", 0))


def make_optimizer(params, lr: float = 1e-3) -> torch.optim.Adam:
    """Adam over the leaves of ``params`` (which then require grad); the lr
    is changed in place by :func:`set_lr`."""
    leaves = [leaf.requires_grad_(True) for _, leaf in iter_leaves(params)]
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def set_lr(opt: torch.optim.Adam, lr: float) -> torch.optim.Adam:
    for group in opt.param_groups:
        group["lr"] = float(lr)
    return opt


def resolve_perf(cfg_train, graph: AssemblyGraph):
    """``(wide_gathers, remat, remat_group)`` for one graph, as the JAX
    package resolves them (``gnnome_tpu/train/loop.py:85-105``): ``'auto'``
    is the narrow path; wide rows past 600k edges narrow a group remat to
    groups of at most 2 (memory only, the values are the same)."""
    wide = cfg_train.wide_gathers
    group = cfg_train.remat_group
    if wide == "auto":
        wide = False
    if wide and graph.n_edges_padded > 600_000 and cfg_train.remat in ("group",
                                                                        "unroll_group"):
        group = min(group, 2)
    return wide, cfg_train.remat, group


def train_step(params, opt: torch.optim.Adam, graph: AssemblyGraph, e_feat, pe, y,
               pos_weight, batch_norm: bool = True, remat: str = "layer",
               remat_group: int = 4, wide_gathers=False,
               compute_dtype: str = "float32") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One full-graph optimization step; ``params`` are updated in place
    (f32 master weights and Adam under any ``compute_dtype``). Returns
    ``(loss, counts)`` as device tensors (nothing is fetched)."""
    with span("train.step"):
        with span("train.optimizer"):
            opt.zero_grad(set_to_none=True)
        with span("train.forward"):
            logits = model_forward(params, graph, e_feat, pe, batch_norm=batch_norm,
                                   remat=remat, remat_group=remat_group,
                                   wide_gathers=wide_gathers, compute_dtype=compute_dtype)
            loss = bce_with_logits(logits, y, graph.edge_mask, pos_weight)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            opt.step()
        with torch.no_grad():
            counts = confusion_counts(logits, y, graph.edge_mask)
    return loss.detach(), counts


@torch.no_grad()
def eval_step(params, graph: AssemblyGraph, e_feat, pe, y, pos_weight,
              batch_norm: bool = True, wide_gathers=False, compute_dtype: str = "float32"):
    """``(loss, counts, logits)`` of one forward, without gradients."""
    logits = model_forward(params, graph, e_feat, pe, batch_norm=batch_norm,
                           wide_gathers=wide_gathers, compute_dtype=compute_dtype)
    loss = bce_with_logits(logits, y, graph.edge_mask, pos_weight)
    return loss, confusion_counts(logits, y, graph.edge_mask), logits


def pos_to_neg_ratio(samples: List[Tuple[int, GraphSample]]) -> float:
    """Dataset-wide mean pos:neg label ratio (``train.py:181``)."""
    ratios = []
    for _, s in samples:
        y = s.y[: s.graph.n_edges].cpu().numpy()
        pos = float((y == 1).sum())
        neg = float((y == 0).sum())
        ratios.append(pos / max(neg, 1.0))
    return float(np.mean(ratios)) if ratios else 1.0


def _epoch_pass(samples, params, opt, pos_weight, cfg: Config, train_mode: bool,
                cluster_fn=None) -> Dict[str, float]:
    """One pass over the graphs; returns the mean metrics. ``cluster_fn``
    (``train/cluster.py``) cuts each graph into pieces, one step each: the
    loss and the metrics are averaged over a graph's pieces, then over the
    graphs, as in the JAX package."""
    losses, per_graph = [], []
    for _, sample in samples:
        pieces = cluster_fn(sample) if cluster_fn is not None else [sample]
        g_losses, g_metrics = [], []
        for piece in pieces:
            wide, remat, group = resolve_perf(cfg.train, piece.graph)
            if train_mode:
                loss, counts = train_step(
                    params, opt, piece.graph, piece.e_feat, piece.pe, piece.y,
                    pos_weight, batch_norm=cfg.model.batch_norm, remat=remat,
                    remat_group=group, wide_gathers=wide,
                    compute_dtype=cfg.train.compute_dtype)
            else:
                loss, counts, _ = eval_step(params, piece.graph, piece.e_feat,
                                            piece.pe, piece.y, pos_weight,
                                            batch_norm=cfg.model.batch_norm,
                                            wide_gathers=wide,
                                            compute_dtype=cfg.train.compute_dtype)
            # one device fetch per step: loss and the four counts packed
            with span("train.fetch"):
                packed = torch.stack([loss, *(counts[k] for k in _COUNT_KEYS)]).cpu().numpy()
            g_losses.append(float(packed[0]))
            g_metrics.append(classification_metrics(dict(zip(_COUNT_KEYS, packed[1:]))))
        losses.append(float(np.mean(g_losses)))
        per_graph.append({k: float(np.mean([m[k] for m in g_metrics]))
                          for k in g_metrics[0]})
    mean = {k: float(np.mean([m[k] for m in per_graph])) for k in per_graph[0]} \
        if per_graph else {}
    mean["loss"] = float(np.mean(losses)) if losses else 0.0
    return mean


def make_cluster_fns(cfg: Config):
    """``(train_fn, valid_fn)``: the ClusterGCN samplers :func:`train` uses,
    each ``None`` where its regime is full-graph (JAX
    ``gnnome_tpu/train/loop.py:294-318``)."""
    tc = cfg.train
    if not (tc.batch_size_train > 1 and tc.num_parts_train > 1):
        return None, None
    from gnnome_tpu_torch.train.cluster import make_cluster_sampler

    train_fn = make_cluster_sampler(num_parts=tc.num_parts_train,
                                    batch_size=tc.batch_size_train,
                                    nb_pos_enc=cfg.model.nb_pos_enc, seed=tc.seed,
                                    jitter=tc.cluster_jitter)
    valid_fn = None
    if tc.cluster_validation and tc.batch_size_eval > 1 and tc.num_parts_eval > 1:
        # the reference's eval regime: a fixed part count, re-shuffled per
        # epoch (train.py:436-439)
        valid_fn = make_cluster_sampler(num_parts=tc.num_parts_eval,
                                        batch_size=tc.batch_size_eval,
                                        nb_pos_enc=cfg.model.nb_pos_enc,
                                        seed=tc.seed + 1, jitter=0, recluster=False)
    return train_fn, valid_fn


def _check_supported(cfg: Config) -> None:
    """Refuse a configuration the port cannot train before any data is
    read: an unknown ``compute_dtype`` name (``compute_dtype_of``)."""
    compute_dtype_of(cfg.train.compute_dtype)


def train(train_path: str, valid_path: Optional[str] = None, out: str = "model",
          overfit: bool = False, cfg: Optional[Config] = None, log_fn=print,
          device="cuda") -> Dict[str, Any]:
    """Full training run, full-graph or ClusterGCN as ``cfg.train`` says.
    Returns a summary with the paths and the loss histories."""
    cfg = cfg or Config()
    _check_supported(cfg)
    tc = cfg.train
    random.seed(tc.seed)
    np.random.seed(tc.seed)

    ds_train = AssemblyGraphDataset(train_path, nb_pos_enc=cfg.model.nb_pos_enc,
                                    device=device)
    if overfit or valid_path is None:
        ds_valid = ds_train  # overfit mode (train.py:176-179)
    else:
        ds_valid = AssemblyGraphDataset(valid_path, nb_pos_enc=cfg.model.nb_pos_enc,
                                        device=device)

    ratio = pos_to_neg_ratio(list(ds_train))
    pos_weight = torch.tensor(1.0 / max(ratio, 1e-9), dtype=torch.float32,
                              device=device)

    params = init_model_params(torch.Generator().manual_seed(tc.seed), cfg.model,
                               device)
    opt = make_optimizer(params, tc.lr)
    log_fn(f"Number of network parameters: {count_params(params)}")

    scheduler = ReduceLROnPlateau(factor=tc.decay, patience=tc.patience)
    lr = tc.lr
    run_name = os.path.basename(os.path.normpath(str(out))) or "run"
    ckpt_path = os.path.join(tc.checkpoint_dir, f"{run_name}.npz")
    best_path = os.path.join(tc.pretrained_dir, f"model_{run_name}.npz")
    start_epoch = 0
    loss_train_hist: List[float] = []
    loss_valid_hist: List[float] = []
    if tc.resume and os.path.exists(ckpt_path):
        last_epoch, meta = ckpt.load_checkpoint(ckpt_path, params, opt)
        start_epoch = last_epoch + 1
        lr = float(meta.get("lr", lr))
        scheduler.load_state_dict(meta.get("scheduler", {}))
        loss_valid_hist = list(meta.get("loss_valid_hist", []))
        loss_train_hist = list(meta.get("loss_train_hist", []))
        log_fn(f"Resumed from {ckpt_path} at epoch {start_epoch}")

    metrics_logger = MetricsLogger(out_dir=os.path.join(tc.checkpoint_dir, "runs"),
                                   run_name=run_name)
    cluster_fn, valid_cluster_fn = make_cluster_fns(cfg)
    t0 = time.time()
    try:
        _run_epochs(list(ds_train), ds_valid, params, opt, pos_weight, cfg, lr,
                    scheduler, metrics_logger, ckpt_path, best_path, start_epoch,
                    loss_train_hist, loss_valid_hist, log_fn, t0, cluster_fn,
                    valid_cluster_fn)
    except KeyboardInterrupt:
        # clean exit, state already checkpointed each epoch (train.py:531-533)
        log_fn("KeyboardInterrupt — exiting (checkpoint is current)")
    finally:
        metrics_logger.close()
    return {
        "best_model": best_path,
        "checkpoint": ckpt_path,
        "loss_train": loss_train_hist,
        "loss_valid": loss_valid_hist,
        "pos_to_neg_ratio": ratio,
    }


def _run_epochs(graphs, ds_valid, params, opt, pos_weight, cfg: Config, lr: float,
                scheduler, metrics_logger, ckpt_path, best_path, start_epoch,
                loss_train_hist, loss_valid_hist, log_fn, t0, cluster_fn,
                valid_cluster_fn):
    tc = cfg.train
    for epoch in range(start_epoch, tc.num_epochs):
        random.shuffle(graphs)
        set_lr(opt, lr)
        train_m = _epoch_pass(graphs, params, opt, pos_weight, cfg, True, cluster_fn)
        loss_train_hist.append(train_m["loss"])
        log_fn(
            f"[epoch {epoch}] train loss {train_m['loss']:.4f} "
            f"acc {train_m['accuracy']:.4f} f1 {train_m['f1']:.4f} "
            f"fp_rate {train_m['fp_rate']:.4f} fn_rate {train_m['fn_rate']:.4f} "
            f"lr {lr:.6f} ({time.time() - t0:.1f}s)")

        valid_m = _epoch_pass(list(ds_valid), params, opt, pos_weight, cfg, False,
                              valid_cluster_fn)
        loss_valid_hist.append(valid_m["loss"])
        log_fn(f"[epoch {epoch}] valid loss {valid_m['loss']:.4f} "
               f"acc {valid_m['accuracy']:.4f} f1 {valid_m['f1']:.4f}")

        # per-epoch metric record (the reference's 14-metric log, train.py:513-521)
        metrics_logger.log({**{f"train_{k}": v for k, v in train_m.items()},
                            **{f"val_{k}": v for k, v in valid_m.items()},
                            "lr_value": lr}, step=epoch)

        # best-model selection on valid loss (train.py:525-527)
        if valid_m["loss"] <= min(loss_valid_hist):
            ckpt.save_params(best_path, params)
        ckpt.save_checkpoint(ckpt_path, params, opt, epoch, scalars={
            "lr": lr,
            "loss_train_hist": loss_train_hist,
            "loss_valid_hist": loss_valid_hist,
            "scheduler": scheduler.state_dict(),
        })
        lr = scheduler.step(valid_m["loss"], lr)
