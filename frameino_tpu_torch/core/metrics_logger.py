"""Machine-readable training metrics (counterpart of
``frameino_tpu/core/metrics_logger.py``): one JSON object per logging step
appended to ``<output_dir>/metrics.jsonl``, each float metric mirrored to
tensorboard (``torch.utils.tensorboard.SummaryWriter`` at
``<output_dir>/tb``) where tensorboard is installed, and
``maybe_profile``, the train entries' ``--profile_dir`` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
import types
from typing import Any, Dict, Optional

import torch

TRACE_FILE = "trace.json"


class MetricsLogger:
    def __init__(self, output_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()
        self._tb = _tensorboard_writer(os.path.join(output_dir, "tb"))

    def log(self, step: int, metrics: Dict[str, Any]):
        row = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self._f.write(json.dumps(row) + "\n")
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.add_scalar(k, v, int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def _tensorboard_writer(log_dir: str):
    """torch's ``SummaryWriter`` at ``log_dir``, or None without the
    ``tensorboard`` package. Its event files need no TensorFlow, so
    tensorboard's own switch to its stub API (a ``tensorboard.compat.notf``
    module) is set first: where TensorFlow is installed, tensorboard
    would import it, which takes seconds and imports jax."""
    try:
        import tensorboard.compat  # noqa: F401
    except ImportError:
        return None
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    from torch.utils.tensorboard import SummaryWriter
    return SummaryWriter(log_dir)


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
