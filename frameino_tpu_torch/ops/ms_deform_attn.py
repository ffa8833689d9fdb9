"""Multi-scale deformable attention, K13 (counterpart of
``frameino_tpu/ops/ms_deform_attn.py`` and of the reference's native
kernel, ``native/ms_deform_attn.cpp``).

OneFormer's pixel decoder samples, in each of its six deformable encoder
layers, for every (batch, query, head) the attention-weighted sum of
bilinearly sampled values across the feature levels and sampling points
(Deformable DETR):

    out[b, q, h] = sum_{l, p} w[b,q,h,l,p] *
                   bilinear(value[b, level l, h], loc[b,q,h,l,p])

with grid_sample(align_corners=False) coordinates, x = loc_x * W_l - 0.5,
and zero padding outside the level; fp32 in and out.

``ms_deform_attn`` launches the CUDA C++ kernel (``csrc/ms_deform_attn.cu``)
for CUDA tensors (fp32, contiguous) and raises on anything else; for CPU
tensors it runs the plain version, ``ms_deform_attn_ref``: the per-level
gather of the JAX function, step by step. Nothing on the card's path calls
the plain version, ``F.grid_sample`` or the reference's native library.
Launches are counted in ``ms_deform_attn.launches`` (``ms_deform_attn_cuda``
launches it, or another build of its C interface, uncounted).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from frameino_tpu_torch.ops.cuda_build import lib


# the kernel's work map (kWarpsPerBlock, kQueriesPerWarp and
# kQueriesPerBlock in csrc/ms_deform_attn.cu): a block takes 32 consecutive
# queries of one head, a quarter-warp one query, 8 lanes of 4 channels
WARPS_PER_BLOCK = 8
QUERIES_PER_WARP = 4
QUERIES_PER_BLOCK = WARPS_PER_BLOCK * QUERIES_PER_WARP


def _levels(spatial_shapes) -> list:
    return [(int(h), int(w)) for h, w in spatial_shapes]


def ms_deform_attn_ref(value, spatial_shapes: Sequence[Tuple[int, int]],
                       sampling_locations, attention_weights):
    """Plain version of K13. value [B, S, H, D] (S = sum H_l * W_l);
    sampling_locations [B, Q, H, L, P, 2] normalized (x, y); attention
    weights [B, Q, H, L, P]. Returns [B, Q, H * D]."""
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    shapes = _levels(spatial_shapes)
    offsets = np.concatenate([[0], np.cumsum([h * w for h, w in shapes])])
    if offsets[-1] != S:
        raise ValueError(f"ms_deform_attn: levels {shapes} hold "
                         f"{offsets[-1]} rows, value has {S}")
    out = torch.zeros((B, Q, H, D), dtype=torch.float32,
                      device=value.device)
    for lvl, (Hl, Wl) in enumerate(shapes):
        # [B, H, Hl*Wl, D]
        v = value[:, offsets[lvl]:offsets[lvl + 1]].permute(0, 2, 1, 3)
        loc = sampling_locations[:, :, :, lvl]             # [B, Q, H, P, 2]
        w = attention_weights[:, :, :, lvl]                # [B, Q, H, P]
        x = loc[..., 0] * Wl - 0.5
        y = loc[..., 1] * Hl - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0

        def gather(ix, iy):
            inside = (ix >= 0) & (ix < Wl) & (iy >= 0) & (iy < Hl)
            ixc = torch.clamp(ix, 0, Wl - 1).long()
            iyc = torch.clamp(iy, 0, Hl - 1).long()
            idx = (iyc * Wl + ixc).permute(0, 2, 1, 3)     # [B, H, Q, P]
            g = torch.gather(v, 2, idx.reshape(B, H, Q * P, 1)
                             .expand(B, H, Q * P, D))
            g = g.reshape(B, H, Q, P, D).permute(0, 2, 1, 3, 4)
            return g * inside[..., None]                   # [B, Q, H, P, D]

        sampled = (gather(x0, y0) * ((1 - fx) * (1 - fy))[..., None]
                   + gather(x0 + 1, y0) * (fx * (1 - fy))[..., None]
                   + gather(x0, y0 + 1) * ((1 - fx) * fy)[..., None]
                   + gather(x0 + 1, y0 + 1) * (fx * fy)[..., None])
        out = out + (sampled * w[..., None]).sum(dim=3)
    return out.reshape(B, Q, H * D)


def ms_deform_attn(value, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations, attention_weights):
    """K13 (replaces ``native/ms_deform_attn.cpp::ms_deform_attn_forward``
    and ``frameino_tpu/ops/ms_deform_attn.py::ms_deform_attn``): a block
    per 32 consecutive queries of one head, a quarter-warp per query, the
    lanes over the channels. CUDA: the kernel, contiguous fp32 only; CPU:
    ``ms_deform_attn_ref``."""
    if not value.is_cuda:
        return ms_deform_attn_ref(value, spatial_shapes, sampling_locations,
                                  attention_weights)
    out = ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                              attention_weights)
    ms_deform_attn.launches += 1
    return out


def ms_deform_attn_cuda(value, spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations, attention_weights, *,
                        library=None):
    """One launch of ``ms_deform_attn_fp32`` from ``csrc/ms_deform_attn.cu``
    (or from ``library``, another build of its C interface) on CUDA
    tensors, after the wrapper's checks; not counted."""
    B, S, H, D = value.shape
    if sampling_locations.ndim != 6 or sampling_locations.shape[-1] != 2:
        raise ValueError(f"ms_deform_attn: locations "
                         f"{tuple(sampling_locations.shape)} are not "
                         f"[B, Q, H, L, P, 2]")
    _, Q, _, L, P, _ = sampling_locations.shape
    if (sampling_locations.shape[:3] != (B, Q, H)
            or attention_weights.shape != (B, Q, H, L, P)):
        raise ValueError(f"ms_deform_attn: value {tuple(value.shape)}, "
                         f"locations {tuple(sampling_locations.shape)}, "
                         f"weights {tuple(attention_weights.shape)}")
    for name, t in (("value", value), ("locations", sampling_locations),
                    ("weights", attention_weights)):
        if not t.is_cuda or t.device != value.device:
            raise ValueError(f"ms_deform_attn: {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ms_deform_attn: the CUDA kernel takes float32 "
                            f"{name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ms_deform_attn: {name} must be contiguous")
    shapes = _levels(spatial_shapes)
    if len(shapes) != L:
        raise ValueError(f"ms_deform_attn: {len(shapes)} level shapes for "
                         f"{L} levels")
    levels = np.ascontiguousarray(np.asarray(shapes, np.int32).reshape(-1))
    out = torch.empty((B, Q, H * D), dtype=torch.float32, device=value.device)
    err = (library or lib("ms_deform_attn")).ms_deform_attn_fp32(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(),
        levels.ctypes.data_as(ctypes.c_void_p), B, S, H, D, Q, L, P,
        torch.cuda.current_stream(value.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn_fp32 launch failed: CUDA error "
                           f"{err}")
    return out


ms_deform_attn.launches = 0
