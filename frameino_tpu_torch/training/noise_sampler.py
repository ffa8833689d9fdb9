"""Rank-stratified timestep sampling (counterpart of
``frameino_tpu/training/noise_sampler.py``).

Reference ``architecture/noise_sampler.py`` (DiscreteSampling,
uniform_sampling=True): with W ranks, pick the largest group count G
dividing W with num_idx % G == 0; rank r samples uniformly from stratum
``r // (W/G)`` of the timestep index range. As in the JAX package the rule
is written over the global batch: example b sits on rank
``b // (B_global / W)``. The draws come from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import torch


def _group_num(world_size: int, num_idx: int) -> int:
    i = 1
    while True:
        if world_size % i != 0 or num_idx % (world_size // i) != 0:
            i += 1
        else:
            return world_size // i


def stratified_timestep_indices(generator: torch.Generator, batch_size: int,
                                num_idx: int = 1000,
                                world_size: int = 1) -> torch.Tensor:
    """[batch_size] int64 timestep indices in [0, num_idx), on the
    generator's device. batch_size is the GLOBAL batch; world_size the
    data-parallel rank count."""
    dev = generator.device
    if world_size <= 1:
        return torch.randint(0, num_idx, (batch_size,), generator=generator,
                             device=dev)
    g = _group_num(world_size, num_idx)
    group_width = world_size // g
    interval = num_idx // g
    per_rank = max(batch_size // world_size, 1)
    rank = torch.arange(batch_size, device=dev) // per_rank
    stratum = torch.clamp(rank // group_width, max=g - 1)
    u = torch.randint(0, interval, (batch_size,), generator=generator,
                      device=dev)
    return stratum * interval + u
