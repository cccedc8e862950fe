"""Edge-classification metrics (counterpart of
``gnnome_tpu/evaluation/metrics.py``).

Reference: ``utils.py:217-240``. The reference swaps the precision and
recall formulas (``utils.py:228,232``); the standard definitions are
computed here, and ``reference_compat=True`` reproduces the swap.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def confusion_counts(logits: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """TP/TN/FP/FN from logits (σ + round, as ``utils.py:217-223``)."""
    preds = torch.round(torch.sigmoid(logits))
    m = (torch.ones_like(labels, dtype=torch.bool) if mask is None else mask
         ).to(torch.float32)
    pos_p, pos_l = preds == 1, labels == 1
    neg_p, neg_l = preds == 0, labels == 0
    return {
        "tp": torch.sum(m * (pos_p & pos_l)),
        "tn": torch.sum(m * (neg_p & neg_l)),
        "fp": torch.sum(m * (pos_p & neg_l)),
        "fn": torch.sum(m * (neg_p & pos_l)),
    }


def classification_metrics(counts: Dict[str, torch.Tensor],
                           reference_compat: bool = False) -> Dict[str, float]:
    """Derived metrics from TP/TN/FP/FN, as host floats."""
    tp, tn, fp, fn = (float(counts[k]) for k in ("tp", "tn", "fp", "fn"))

    def safe_div(a, b):
        return a / b if b > 0 else 0.0

    precision = safe_div(tp, tp + fp)
    recall = safe_div(tp, tp + fn)
    if reference_compat:  # reproduce the swapped formulas (utils.py:226-234)
        precision, recall = recall, precision
    return {
        "accuracy": safe_div(tp + tn, tp + tn + fp + fn),
        "precision": precision,
        "recall": recall,
        "f1": safe_div(tp, tp + 0.5 * (fp + fn)),
        "fp_rate": safe_div(fp, fp + tn),  # train.py:262-269
        "fn_rate": safe_div(fn, fn + tp),
    }


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor, pos_weight=1.0) -> torch.Tensor:
    """Masked mean BCE-with-logits with positive-class weighting
    (``torch.nn.BCEWithLogitsLoss(pos_weight=...)``, train.py:210-211):
    the weight scales positive terms only, and the mean is over the mask."""
    log_p = torch.nn.functional.logsigmoid(logits)
    log_not_p = torch.nn.functional.logsigmoid(-logits)
    per_edge = -(pos_weight * labels * log_p + (1.0 - labels) * log_not_p)
    m = mask.to(logits.dtype)
    return torch.sum(per_edge * m) / torch.clamp(torch.sum(m), min=1.0)
