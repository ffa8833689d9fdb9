"""Machine-readable training metrics (counterpart of
``frameino_tpu/core/metrics_logger.py``): one JSON object per logging step
appended to ``<output_dir>/metrics.jsonl``. The JAX package's optional
tensorboard mirror and profiler hook are not ported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, output_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any]):
        row = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self._f.write(json.dumps(row) + "\n")

    def close(self):
        self._f.close()
