"""Training checkpoints: save, find the latest, resume (counterpart of
``frameino_tpu/core/checkpoint.py``, which writes Orbax).

The layout is the JAX package's: ``<root>/checkpoint-{step}/`` with a
``metadata.json`` blob (e.g. the data iterator's epoch and offset), and a
rolling ``total_limit``. The state is one ``torch.save`` file,
``state.pt``: the model's and the optimizer's ``state_dict`` and the step.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

_STEP_RE = re.compile(r"^checkpoint-(\d+)$")


def _ckpt_dirs(root: str):
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    return sorted(out)


def latest_checkpoint(root: str) -> Optional[str]:
    dirs = _ckpt_dirs(root)
    return dirs[-1][1] if dirs else None


def save_checkpoint(root: str, step: int, state,
                    metadata: Optional[Dict[str, Any]] = None,
                    total_limit: Optional[int] = None) -> str:
    """Write checkpoint-{step}/ under root (``state``: a ``TrainState``);
    prune the oldest beyond ``total_limit``."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"checkpoint-{step}")
    if os.path.exists(path):
        # idempotent re-save at the same step (e.g. the final save landing
        # on a periodic-save step)
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}, os.path.join(path, "state.pt"))
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(metadata or {}, f)

    if total_limit is not None:
        dirs = _ckpt_dirs(root)
        while len(dirs) > total_limit:
            _, victim = dirs.pop(0)
            shutil.rmtree(victim)
    return path


def restore_checkpoint(path: str, state) -> Tuple[Any, Dict]:
    """Load checkpoint ``path`` into ``state`` (a ``TrainState`` of the
    same shapes) in place; returns (state, metadata). The file is mapped,
    not read whole, and each tensor is copied onto its parameter's
    device."""
    blob = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                      mmap=True, weights_only=True)
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    metadata = {}
    meta_path = os.path.join(path, "metadata.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return state, metadata
