"""train.optimizer_ms.bf16: ``train.optimizer_ms`` read on the bf16 cell, which
moves that cell's own rate, ``train_edges_per_s.bf16`` (``PERF.md`` §2)."""
from benchmark import metrics

read = metrics.load("train.optimizer_ms")
