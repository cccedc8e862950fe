"""Structured per-epoch metrics (counterpart of ``gnnome_tpu/utils/logging.py``).

Reference behaviour: a 14-metric per-epoch log (``train.py:229-230,513-523``).
The sink is a local JSONL file, one record per :meth:`MetricsLogger.log`.
The JAX package can also attach wandb; the port has no such dependency.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, out_dir: str = "runs", run_name: str = "run"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{run_name}.metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {"time": time.time(), **({"step": step} if step is not None else {}),
               **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
