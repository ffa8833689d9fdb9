"""Multi-process runtime (counterpart of
``frameino_tpu/parallel/multihost.py``).

One process runs per rank, started by ``torch.multiprocessing``,
``torchrun`` (``initialize_from_env``) or any launcher that knows the rank
and the world size. ``initialize`` joins them into the default process
group; ``core.meshes.make_mesh`` then lays them out. The caller names the
collective backend: NCCL with one card a rank, gloo on the CPU or with
several ranks on one card (NCCL refuses two ranks on one GPU; gloo stages
CUDA tensors through host memory).

``local_batch`` is JAX's ``global_batch`` turned around: JAX assembles
each process's examples into one global array; here each process keeps
the examples its rank runs (``parallel.sharding.batch_slice``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(init_method: str, world_size: int, rank: int, *,
               backend: str) -> None:
    """``dist.init_process_group`` with everything named by the caller:
    ``init_method`` as ``tcp://host:port`` or ``file:///path``,
    ``backend`` "nccl" or "gloo"."""
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def initialize_from_env(backend: Optional[str] = None) -> dict:
    """Join the processes that ``torchrun`` started: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT``
    from the environment. ``backend`` None: NCCL with this process on
    ``cuda:LOCAL_RANK`` (one card a rank); "gloo" (several ranks on one
    card, or the CPU) keeps the current device. Returns {"rank",
    "world_size", "local_rank"}."""
    env = {k: int(os.environ[k.upper()])
           for k in ("rank", "world_size", "local_rank")}
    backend = backend or "nccl"
    if backend == "nccl":
        torch.cuda.set_device(env["local_rank"])
    initialize(f"tcp://{os.environ['MASTER_ADDR']}:"
               f"{os.environ['MASTER_PORT']}", env["world_size"],
               env["rank"], backend=backend)
    return env


def local_batch(batch: dict, mesh, batch_size: int) -> dict:
    """The examples of a global batch (tensors, arrays or lists along dim
    0; None kept) that this rank runs; ``batch_size`` is the global
    count (``mesh`` None: the batch as it is)."""
    if mesh is None:
        return batch
    from frameino_tpu_torch.parallel.sharding import batch_slice
    sl, _ = batch_slice(mesh, batch_size)
    return {k: None if v is None else v[sl] for k, v in batch.items()}


def assert_same_across_processes(value: float, atol: float = 0.0,
                                 group=None) -> None:
    """Raise on every process of ``group`` (default: the default group) if
    a host-side scalar differs across them: a gather of one float from
    each, compared everywhere. It catches desynchronized seeds or inputs
    before they diverge silently."""
    # NCCL takes tensors on the current card, gloo on the host
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    gathered = [torch.empty_like(t)
                for _ in range(dist.get_world_size(group))]
    dist.all_gather(gathered, t, group=group)
    vals = np.array([float(g) for g in gathered])
    if not np.allclose(vals, vals[0], atol=atol):
        raise AssertionError(f"cross-process divergence: {vals.tolist()}")


def broadcast_from_rank0(tensors, device, group=None) -> list:
    """The ``tensors`` (any of them None) of ``group``'s first process (the
    default group's rank 0 by default) on every process of ``group``:
    their shapes and dtypes first, as one object, then each tensor,
    received into new tensors on ``device``. What the other processes pass
    is ignored."""
    rank = dist.get_rank(group)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    meta = [[None if t is None else (tuple(t.shape), t.dtype)
             for t in tensors] if rank == 0 else None]
    dist.broadcast_object_list(meta, src=src, group=group)
    out = []
    for i, m in enumerate(meta[0]):
        if m is None:
            out.append(None)
            continue
        buf = (tensors[i].contiguous() if rank == 0
               else torch.empty(m[0], dtype=m[1], device=device))
        dist.broadcast(buf, src=src, group=group)
        out.append(buf)
    return out
