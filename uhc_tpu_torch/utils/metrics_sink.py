"""Scalar metric sink — the wandb-logging twin (PyTorch-port copy of
uhc_tpu.utils.metrics_sink).

The reference streams per-epoch scalars to wandb (train_uhc.py:58-68,
agent_copycat.py:312-324: reward vector, eps_len, avg reward, rfc_rate,
eval coverage). The sink writes the same scalars as newline-delimited JSON
under the experiment results dir (metrics.jsonl), importable into
wandb/pandas, and keeps an in-memory history for quick summaries.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class MetricsSink:
    def __init__(self, results_dir: str, filename: str = "metrics.jsonl",
                 resume: bool = False):
        os.makedirs(results_dir, exist_ok=True)
        self.path = os.path.join(results_dir, filename)
        self.history: List[Dict[str, Any]] = []
        self._fh = open(self.path, "a" if resume else "w")
        self._t0 = time.time()

    @staticmethod
    def _scalarize(v):
        try:
            import numpy as np
            if isinstance(v, np.ndarray):
                return v.tolist() if v.ndim else float(v)
        except ImportError:
            pass
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            return float(v.item())
        return v

    def log(self, step: int, scalars: Dict[str, Any],
            prefix: Optional[str] = None):
        row = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            key = f"{prefix}/{k}" if prefix else k
            row[key] = self._scalarize(v)
        self.history.append(row)
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def last(self, key: str):
        for row in reversed(self.history):
            if key in row:
                return row[key]
        return None

    def close(self):
        self._fh.close()
