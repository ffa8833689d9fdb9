"""Normalization ops (counterpart of ``frameino_tpu/ops/norms.py``).

All statistics in fp32, matching the reference's ``FP32LayerNorm`` and
``_keep_in_fp32_modules`` recipe; callers cast back when needed.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from frameino_tpu_torch.ops.conv import low_precision_dtype
from frameino_tpu_torch.parallel.collectives import all_reduce_sum


def layer_norm(x, weight=None, bias=None, eps: float = 1e-6):
    """LayerNorm over the last dim, fp32 statistics, fp32 result.

    With ``weight is None`` this is the non-affine FP32LayerNorm of the
    Wan blocks' norm1/norm3.
    """
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y


def rms_norm(x, weight=None, eps: float = 1e-6, group=None):
    """RMSNorm over the last dim, fp32 statistics, result in x's dtype
    (Wan's ``qk_norm="rms_norm_across_heads"`` over the full inner_dim).

    ``group``: the tensor-parallel process group over whose ranks the last
    dim is cut in equal slices (x and weight are this rank's): the fp32
    sum of squares is all-reduced over it before the mean, as GSPMD
    completes the statistic of a sharded dim in JAX (``all_reduce_sum``,
    whose backward sums the statistic's gradient over the ranks too)."""
    xf = x.float()
    if group is None:
        ms = xf.square().mean(-1, keepdim=True)
    else:
        ms = all_reduce_sum(xf.square().sum(-1, keepdim=True), group)
        ms = ms / (xf.shape[-1] * dist.get_world_size(group))
    y = xf * torch.reciprocal(torch.sqrt(ms + eps))
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def l2_normalize_channel(x, scale: float, gamma, bias=0.0, dim: int = 1):
    """``WanRMS_norm``: F.normalize along ``dim`` * sqrt(C) * gamma + bias.

    torch's F.normalize clamps the L2 *norm* at 1e-12. ``gamma`` (and a
    tensor ``bias``) broadcast against x. Under a low-precision
    ``ops/conv.conv_dtype`` scope (the trainer's VAE encodes) the statistic
    stays fp32 and the apply runs in x's narrower dtype, as JAX's does
    under its scope.
    """
    xf = x.float()
    n = torch.linalg.vector_norm(xf, dim=dim, keepdim=True)
    if low_precision_dtype() is not None and x.dtype != torch.float32:
        r = (torch.reciprocal(torch.clamp(n, min=1e-12)) * scale).to(x.dtype)
        y = x * r * gamma.to(x.dtype)
        if not (isinstance(bias, float) and bias == 0.0):
            y = y + torch.as_tensor(bias, dtype=x.dtype, device=x.device)
        return y
    y = xf / torch.clamp(n, min=1e-12)
    y.mul_(scale).mul_(gamma.float())
    if not (isinstance(bias, float) and bias == 0.0):
        y = y + bias
    return y.to(x.dtype)
