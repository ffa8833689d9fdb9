"""Training checkpoints: save, find the latest, resume (counterpart of
``frameino_tpu/core/checkpoint.py``, which writes Orbax).

The layout is the JAX package's: ``<root>/checkpoint-{step}/`` with a
``metadata.json`` blob (e.g. the data iterator's epoch and offset), and a
rolling ``total_limit``. The state is one ``torch.save`` file,
``state.pt``: the model's and the optimizer's ``state_dict`` and the step.

A state trained under a mesh (``training/trainer.init_train_state(...,
mesh=)``) is saved whole: every tensor is gathered, one at a time, to the
mesh's rank 0, which writes the single-process format (Orbax writes a
sharded state's shards; either restores on any layout). Restoring cuts
the file's whole tensors for the mesh of the state it restores into, so
a sharded run resumes on one process or on another mesh bit for bit.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

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
    prune the oldest beyond ``total_limit``. Under a mesh every rank calls
    it; the mesh's rank 0 writes."""
    mesh = state.optimizer.mesh
    path = os.path.join(root, f"checkpoint-{step}")
    if mesh is not None:
        model_sd, opt_sd = _gathered(state, mesh)
        if mesh.rank == 0:
            _write(root, path, model_sd, opt_sd, step, metadata, total_limit)
        del model_sd, opt_sd
        dist.barrier(group=mesh.group)
        return path
    _write(root, path, state.model.state_dict(),
           state.optimizer.state_dict(), step, metadata, total_limit)
    return path


def _gathered(state, mesh):
    """The model's and the optimizer's state dicts, every tensor whole on
    the mesh's rank 0 (on the CPU; the other ranks hold none)."""
    from frameino_tpu_torch.parallel.sharding import gather_state_dict
    opt = state.optimizer
    keep = mesh.rank == 0
    model_sd = gather_state_dict(state.model.state_dict(), mesh,
                                 state.model.cuts, keep)
    opt_sd = opt.state_dict()
    for key in (*opt.slots, "acc"):
        if key in opt_sd:
            opt_sd[key] = gather_state_dict(
                opt_sd[key], mesh, {n: opt.slot_cut(key, n)
                                    for n in opt_sd[key]}, keep)
    for key in ("estim_lr", "numerator_weighted"):
        if key in opt_sd:
            opt_sd[key] = opt_sd[key].cpu()
    return model_sd, opt_sd


def _write(root, path, model_sd, opt_sd, step, metadata, total_limit):
    os.makedirs(root, exist_ok=True)
    if os.path.exists(path):
        # idempotent re-save at the same step (e.g. the final save landing
        # on a periodic-save step)
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save({"model": model_sd, "optimizer": opt_sd, "step": int(step)},
               os.path.join(path, "state.pt"))
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(metadata or {}, f)

    if total_limit is not None:
        dirs = _ckpt_dirs(root)
        while len(dirs) > total_limit:
            _, victim = dirs.pop(0)
            shutil.rmtree(victim)


def restore_checkpoint(path: str, state) -> Tuple[Any, Dict]:
    """Load checkpoint ``path`` into ``state`` (a ``TrainState`` of the
    same shapes, or their slices under a mesh) in place; returns (state,
    metadata). The file is mapped, not read whole, and each tensor (each
    rank's slice of it under a mesh) is copied onto its parameter's
    device."""
    blob = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                      mmap=True, weights_only=True)
    mesh = state.optimizer.mesh
    model_sd, opt_sd = blob["model"], blob["optimizer"]
    if mesh is not None:
        from frameino_tpu_torch.parallel.sharding import (shard_state_dict,
                                                         shard_tensor)
        opt = state.optimizer
        model_sd = shard_state_dict(model_sd, mesh)
        opt_sd = dict(opt_sd)
        for key in (*opt.slots, "acc"):
            if key in opt_sd and getattr(opt, key, None) is not None:
                opt_sd[key] = {n: shard_tensor(t, opt.slot_cut(key, n), mesh)
                               for n, t in opt_sd[key].items()}
    state.model.load_state_dict(model_sd)
    state.optimizer.load_state_dict(opt_sd)
    state.step = int(blob["step"])
    metadata = {}
    meta_path = os.path.join(path, "metadata.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return state, metadata
