"""Machine-readable training metrics (counterpart of
``frameino_tpu/core/metrics_logger.py``): one JSON object per logging step
appended to ``<output_dir>/metrics.jsonl``, and ``maybe_profile``, the
train entries' ``--profile_dir`` trace. The JAX package's optional
tensorboard mirror is not ported.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch

TRACE_FILE = "trace.json"


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


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block when ``trace_dir`` is set
    (host activity, and the card's when CUDA is available), written there
    as a Chrome trace, ``trace.json``; yields the profiler (or None)."""
    if not trace_dir:
        yield None
        return
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
