"""Process mesh over ``torch.distributed`` (counterpart of
``frameino_tpu/core/meshes.py``).

JAX lays its devices out as a ``jax.sharding.Mesh`` with named axes and
lets XLA insert the collectives. Here one process runs per rank, and the
mesh says which slice of the work this process owns and which process
groups its collectives run over:

    dp    data parallel: each dp rank runs its slice of the batch
    tp    tensor parallel: each tp rank holds a contiguous slice of the
          attention heads and of the FFN hidden width
    fsdp  fully sharded data parallel (ZeRO-3): each fsdp rank holds a
          slice of the parameters and of their optimizer state, gathered
          before the layers that use them; the batch is cut over
          (dp, fsdp) together
    sp    sequence parallel: each sp rank runs its contiguous slice of the
          DiT's tokens; self-attention gathers the keys and values over
          the sp group (or passes them round it as a ring)
    pp    not ported (ROADMAP.md queue 1, item 12.3): raises

Ranks are laid out as JAX's ``make_mesh`` lays out devices,
``reshape(pp, dp, fsdp, tp, sp)``, so the sp ranks of one tp slice are
contiguous, the tp ranks of one fsdp slice, and the fsdp ranks of one dp
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

# the order in which make_mesh reshapes the ranks (pp outermost)
_RANK_ORDER = ("pp", "dp", "fsdp", "tp", "sp")

NOT_PORTED = ("{}={} is not ported: pp is ROADMAP.md queue 1, item 12.3; "
              "only dp x fsdp x tp x sp meshes run")


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
    """This process's place in a dp x fsdp x tp x sp mesh: its rank in the
    mesh, its coordinate on each axis, and the process groups of its tp,
    dp, sp and fsdp ranks and of its batch ranks, the dp x fsdp ranks that
    share its tp and sp coordinates (None where the mesh is only
    described, as in the sharding tests). ``ranks`` are the mesh's
    processes in the default group (its rank r is process ``ranks[r]``);
    ``group`` spans them all (None: the default group)."""

    cfg: MeshConfig
    rank: int
    tp_group: Optional[object] = None
    dp_group: Optional[object] = None
    sp_group: Optional[object] = None
    ranks: Optional[tuple] = None
    group: Optional[object] = None
    fsdp_group: Optional[object] = None
    batch_group: Optional[object] = None

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
    def fsdp(self) -> int:
        return self.cfg.fsdp

    @property
    def batch(self) -> int:
        """The ranks the batch is cut over: dp x fsdp."""
        return self.cfg.dp * self.cfg.fsdp

    @property
    def tp_rank(self) -> int:
        return self.coords["tp"]

    @property
    def dp_rank(self) -> int:
        return self.coords["dp"]

    @property
    def sp_rank(self) -> int:
        return self.coords["sp"]

    @property
    def fsdp_rank(self) -> int:
        return self.coords["fsdp"]

    @property
    def batch_rank(self) -> int:
        """This rank's place among the batch ranks, dp-major (JAX's
        ``P(("dp", "fsdp"))``)."""
        return self.dp_rank * self.cfg.fsdp + self.fsdp_rank

    def groups(self) -> list:
        """Every distinct process group of the mesh (to free them)."""
        out = []
        for g in (self.tp_group, self.dp_group, self.sp_group,
                  self.fsdp_group, self.batch_group, self.group):
            if g is not None and all(g is not h for h in out):
                out.append(g)
        return out

    def process(self, rank: int) -> int:
        """The default group's rank of the mesh's rank ``rank``."""
        return rank if self.ranks is None else self.ranks[rank]


def check_supported(cfg: MeshConfig) -> None:
    if cfg.pp > 1:
        raise NotImplementedError(NOT_PORTED.format("pp", cfg.pp))


def make_mesh(cfg: Optional[MeshConfig] = None,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """The mesh over the processes ``ranks`` of the initialized default
    group (``parallel.multihost.initialize``; the counterpart of JAX's
    ``devices=``), by default all of them; ``cfg`` defaults to pure data
    parallel. Collective: every process of the default group calls it, in
    the same order as any other group creation, because it creates the
    tp, dp, sp, fsdp and batch groups (and, over a part of the default
    group, the mesh's own). A process outside ``ranks`` gets None."""
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
    # np.unravel_index(r, (pp, dp, fsdp, tp, sp)), here pp = 1
    grid = np.asarray(ranks).reshape(
        [getattr(cfg, a) for a in _RANK_ORDER])[0]   # [dp, fsdp, tp, sp]
    groups = {}
    # every process creates every group in the same order (new_group is
    # collective over the default group) and keeps the ones it is in
    lines = {"tp": grid.transpose(0, 1, 3, 2).reshape(-1, cfg.tp),
             "dp": grid.transpose(1, 2, 3, 0).reshape(-1, cfg.dp),
             "sp": grid.reshape(-1, cfg.sp),
             "fsdp": grid.transpose(0, 2, 3, 1).reshape(-1, cfg.fsdp),
             "batch": grid.transpose(2, 3, 0, 1).reshape(
                 -1, cfg.dp * cfg.fsdp)}
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
                groups["sp"], ranks, whole, groups["fsdp"], groups["batch"])
