"""model.aggregate_ms.train.bf16: ``model.aggregate_ms.train`` read on a bf16
cell, which moves that cell's own rate, ``train_edges_per_s.bf16``
(``PERF.md`` §2)."""
from benchmark import metrics

read = metrics.load("model.aggregate_ms.train")
