"""Process mesh over ``torch.distributed`` (counterpart of
``frameino_tpu/core/meshes.py``).

JAX lays its devices out as a ``jax.sharding.Mesh`` with named axes and
lets XLA insert the collectives. Here one process runs per rank, and the
mesh says which slice of the work this process owns and which process
groups its collectives run over:

    dp    data parallel: each dp rank runs its slice of the batch
    tp    tensor parallel: each tp rank holds a contiguous slice of the
          attention heads and of the FFN hidden width
    sp    sequence parallel: each sp rank runs its contiguous slice of the
          DiT's tokens; self-attention gathers the keys and values over
          the sp group (or passes them round it as a ring)
    fsdp, pp    not ported (ROADMAP.md queue 1, item 12): raise

Ranks are laid out as JAX's ``make_mesh`` lays out devices,
``reshape(pp, dp, fsdp, tp, sp)``, so the sp ranks of one tp slice are
contiguous, and the tp ranks of one dp slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

# the order in which make_mesh reshapes the ranks (pp outermost)
_RANK_ORDER = ("pp", "dp", "fsdp", "tp", "sp")

NOT_PORTED = ("{}={} is not ported: fsdp and pp are ROADMAP.md queue 1, "
              "item 12; only dp x tp x sp meshes run")


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
    """This process's place in a dp x tp x sp mesh: its rank in the mesh,
    its coordinate on each axis, and the process groups of its tp, dp and
    sp ranks (None where the mesh is only described, as in the sharding
    tests). ``ranks`` are the mesh's processes in the default group (its
    rank r is process ``ranks[r]``); ``group`` spans them all (None: the
    default group)."""

    cfg: MeshConfig
    rank: int
    tp_group: Optional[object] = None
    dp_group: Optional[object] = None
    sp_group: Optional[object] = None
    ranks: Optional[tuple] = None
    group: Optional[object] = None

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
    def sp(self) -> int:
        return self.cfg.sp

    @property
    def tp_rank(self) -> int:
        return self.coords["tp"]

    @property
    def dp_rank(self) -> int:
        return self.coords["dp"]

    @property
    def sp_rank(self) -> int:
        return self.coords["sp"]

    def process(self, rank: int) -> int:
        """The default group's rank of the mesh's rank ``rank``."""
        return rank if self.ranks is None else self.ranks[rank]


def check_supported(cfg: MeshConfig) -> None:
    for axis in ("fsdp", "pp"):
        if getattr(cfg, axis) > 1:
            raise NotImplementedError(NOT_PORTED.format(axis,
                                                        getattr(cfg, axis)))


def make_mesh(cfg: Optional[MeshConfig] = None,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """The mesh over the processes ``ranks`` of the initialized default
    group (``parallel.multihost.initialize``; the counterpart of JAX's
    ``devices=``), by default all of them; ``cfg`` defaults to pure data
    parallel. Collective: every process of the default group calls it, in
    the same order as any other group creation, because it creates the
    tp, dp and sp groups (and, over a part of the default group, the
    mesh's own). A process outside ``ranks`` gets None."""
    import torch.distributed as dist
    world = dist.get_world_size()
    ranks = tuple(range(world) if ranks is None else ranks)
    if cfg is None:
        cfg = MeshConfig(dp=len(ranks))
    if cfg.size != len(ranks):
        raise ValueError(f"mesh {cfg} needs {cfg.size} processes, "
                         f"{'the group has' if len(ranks) == world else 'given'}"
                         f" {len(ranks)}")
    if list(ranks) != sorted(set(ranks)) or not set(ranks) <= set(
            range(world)):
        # ascending: a group orders its members by their default rank, and
        # the sp gather concatenates in that order
        raise ValueError(f"ranks {ranks} are not ascending distinct "
                         f"processes of the default group of {world}")
    check_supported(cfg)
    me = dist.get_rank()
    # laid out as JAX lays out devices: the mesh's rank r sits at
    # np.unravel_index(r, (pp, dp, fsdp, tp, sp)), here fsdp = pp = 1
    grid = np.asarray(ranks).reshape(
        [getattr(cfg, a) for a in _RANK_ORDER])[0, :, 0, :, :]  # [dp, tp, sp]
    groups = {}
    # every process creates every group in the same order (new_group is
    # collective over the default group) and keeps the ones it is in
    lines = {"tp": grid.transpose(0, 2, 1).reshape(-1, cfg.tp),
             "dp": grid.transpose(1, 2, 0).reshape(-1, cfg.dp),
             "sp": grid.reshape(-1, cfg.sp)}
    for axis, members in lines.items():
        for line in members.tolist():
            g = dist.new_group(line)
            if me in line:
                groups[axis] = g
    whole = None
    if len(ranks) != world:
        whole = dist.new_group(list(ranks))
    if me not in ranks:
        return None
    return Mesh(cfg, ranks.index(me), groups["tp"], groups["dp"],
                groups["sp"], ranks, whole)
