"""train.recompute_ms.bf16: ``train.recompute_ms`` read on the bf16 cell, which
moves that cell's own rate, ``train_edges_per_s.bf16`` (``PERF.md`` §2)."""
from benchmark import metrics

read = metrics.load("train.recompute_ms")
