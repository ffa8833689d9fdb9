"""Process mesh over ``torch.distributed`` (counterpart of
``frameino_tpu/core/meshes.py``).

JAX lays its devices out as a ``jax.sharding.Mesh`` with named axes and
lets XLA insert the collectives. Here one process runs per rank, and the
mesh says which slice of the work this process owns and which process
groups its collectives run over:

    dp    data parallel: each dp rank runs its slice of the batch
    tp    tensor parallel: each tp rank holds a contiguous slice of the
          attention heads and of the FFN hidden width
    fsdp, sp, pp    not ported (ROADMAP.md queue 1, item 12): raise

Ranks are laid out as JAX's ``make_mesh`` lays out devices,
``reshape(pp, dp, fsdp, tp, sp)``, so the tp ranks of one dp slice are
contiguous.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# the order in which make_mesh reshapes the ranks (pp outermost)
_RANK_ORDER = ("pp", "dp", "fsdp", "tp", "sp")

NOT_PORTED = ("{}={} is not ported: fsdp, sp (ring attention) and pp are "
              "ROADMAP.md queue 1, item 12; only dp x tp meshes run")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.pp


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a dp x tp mesh: its rank, its coordinate on
    each axis, and the process groups of its tp ranks and its dp ranks
    (None where the mesh is only described, as in the sharding tests)."""

    cfg: MeshConfig
    rank: int
    tp_group: Optional[object] = None
    dp_group: Optional[object] = None

    @property
    def coords(self) -> dict:
        idx = np.unravel_index(self.rank, [getattr(self.cfg, a)
                                           for a in _RANK_ORDER])
        return {a: int(i) for a, i in zip(_RANK_ORDER, idx)}

    @property
    def tp(self) -> int:
        return self.cfg.tp

    @property
    def dp(self) -> int:
        return self.cfg.dp

    @property
    def tp_rank(self) -> int:
        return self.coords["tp"]

    @property
    def dp_rank(self) -> int:
        return self.coords["dp"]


def check_supported(cfg: MeshConfig) -> None:
    for axis in ("fsdp", "sp", "pp"):
        if getattr(cfg, axis) > 1:
            raise NotImplementedError(NOT_PORTED.format(axis,
                                                        getattr(cfg, axis)))


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The mesh over every process of the initialized default group
    (``parallel.multihost.initialize``); defaults to pure data parallel.
    Collective: every process calls it, in the same order as any other
    group creation, because it creates the tp and dp groups."""
    import torch.distributed as dist
    world = dist.get_world_size()
    if cfg is None:
        cfg = MeshConfig(dp=world)
    if cfg.size != world:
        raise ValueError(f"mesh {cfg} needs {cfg.size} processes, the "
                         f"group has {world}")
    check_supported(cfg)
    rank = dist.get_rank()
    grid = np.arange(world).reshape([getattr(cfg, a) for a in _RANK_ORDER])
    grid = grid[0, :, 0, :, 0]                              # [dp, tp]
    groups = {}
    # every process creates every group in the same order (new_group is
    # collective over the default group) and keeps the ones it is in
    for axis, lines in (("tp", grid), ("dp", grid.T)):
        for ranks in lines.tolist():
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return Mesh(cfg, rank, groups["tp"], groups["dp"])
