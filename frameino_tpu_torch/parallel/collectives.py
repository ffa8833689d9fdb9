"""Collectives that autograd sees (the sharded train step's counterpart of
the collectives GSPMD inserts into JAX's forward and backward).

``torch.distributed``'s calls are invisible to autograd; each function
here is a ``torch.autograd.Function`` whose backward issues the collective
its forward implies, so a sharded forward differentiates like the
unsharded one:

- ``gather_fsdp``: the all-gather of an fsdp-cut parameter along its cut
  dim; backward: the reduce-scatter (sum) of the full gradient, each rank
  keeping its slice;
- ``copy_to_tp``: tp's identity on a column-parallel layer's replicated
  input; backward: the all-reduce (sum) of the rank's partial gradient;
- ``reduce_from_tp``: tp's all-reduce (sum) of a row-parallel layer's
  partial products; backward: the identity (every rank's downstream
  gradient is already the whole one);
- ``all_reduce_sum``: an all-reduce whose backward all-reduces too (Wan's
  qk RMS statistic, a sum over every head: each rank's statistic feeds
  its own heads, so its gradient is the sum of every rank's).

Under NCCL the gather and the reduce-scatter are the single-tensor
collectives; gloo on the installed torch versions runs the list form of
all-gather on CUDA tensors (through host memory) and has no
reduce-scatter for them, so it all-reduces and keeps the rank's slice.
Every rank must call these in the same order, as any collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` joined along ``dim`` in the group's rank order
    (no autograd)."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    if _nccl(group):
        rows = t.movedim(dim, 0).contiguous()
        out = torch.empty((n * rows.shape[0],) + tuple(rows.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, rows, group=group)
        return out.movedim(0, dim).contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's sum of ``t``, this rank's contiguous slice of it along
    ``dim`` (no autograd)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    m = t.shape[dim] // n
    if _nccl(group):
        rows = t.movedim(dim, 0).contiguous()
        out = torch.empty((m,) + tuple(rows.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, rows, group=group)
        return out.movedim(0, dim).contiguous()
    full = t.contiguous().clone()
    dist.all_reduce(full, group=group)
    return full.narrow(dim, r * m, m).contiguous()


class _GatherFsdp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group), None, None


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def gather_fsdp(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole parameter from every fsdp rank's slice along ``dim``;
    its gradient is reduce-scattered back to the slices."""
    return _GatherFsdp.apply(shard, dim, group)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is (group None: no tp); its gradient is summed over
    the tp ranks."""
    if group is None or not torch.is_grad_enabled():
        return x
    return _CopyToTp.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every tp rank's ``x`` (in place where autograd does not
    record); the gradient passes as it is."""
    if not torch.is_grad_enabled():
        dist.all_reduce(x, group=group)
        return x
    return _ReduceFromTp.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (in place where autograd does not
    record); its gradient is summed too."""
    if not torch.is_grad_enabled():
        dist.all_reduce(x, group=group)
        return x
    return _AllReduceSum.apply(x, group)
