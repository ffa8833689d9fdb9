"""Interleaved-pair rotary embeddings for the Wan and CogVideoX DiTs
(counterpart of ``frameino_tpu/ops/rope.py``).

The rotation, with per-token cos/sin of shape [S, D/2]:

    x1, x2 = x[..., 0::2], x[..., 1::2]
    out[..., 0::2] = x1 * cos - x2 * sin
    out[..., 1::2] = x1 * sin + x2 * cos
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _freqs_1d(dim: int, positions: np.ndarray,
              theta: float = 10000.0) -> np.ndarray:
    """[S, dim/2] float64 angle table: outer(pos, theta^-(2i/dim))."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return np.outer(np.asarray(positions, np.float64), inv)


@functools.lru_cache(maxsize=32)
def wan_rope_table(head_dim: int, f: int, h: int, w: int,
                   theta: float = 10000.0,
                   max_seq_len: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables [f*h*w, head_dim/2] fp32 for an (f, h, w) patch grid,
    computed in float64 (reference ``freqs_dtype=torch.float64``).

    Axis dims: h_dim = w_dim = 2*(head_dim//6), t_dim = the rest
    (44/42/42 for head_dim 128).
    """
    h_dim = w_dim = 2 * (head_dim // 6)
    t_dim = head_dim - h_dim - w_dim
    pos = np.arange(max_seq_len)

    def grid_tab(dim, n):
        ang = _freqs_1d(dim, pos, theta)[:n]
        return np.cos(ang), np.sin(ang)

    (tc, ts), (hc, hs), (wc, ws) = (grid_tab(t_dim, f), grid_tab(h_dim, h),
                                    grid_tab(w_dim, w))

    def combine(a_t, a_h, a_w):
        a_t = np.broadcast_to(a_t[:, None, None, :], (f, h, w, t_dim // 2))
        a_h = np.broadcast_to(a_h[None, :, None, :], (f, h, w, h_dim // 2))
        a_w = np.broadcast_to(a_w[None, None, :, :], (f, h, w, w_dim // 2))
        return np.concatenate([a_t, a_h, a_w], axis=-1).reshape(
            f * h * w, head_dim // 2)

    return (combine(tc, hc, wc).astype(np.float32),
            combine(ts, hs, ws).astype(np.float32))


def get_resize_crop_region_for_grid(src_hw, tgt_width: int, tgt_height: int):
    """Aspect-preserving centre-crop region that anchors the CogVideoX RoPE
    grid at non-default resolutions: ((top, left), (bottom, right))."""
    th, tw = tgt_height, tgt_width
    h, w = src_hw
    if h / w > th / tw:
        resize_height = th
        resize_width = int(round(th / h * w))
    else:
        resize_width = tw
        resize_height = int(round(tw / w * h))
    crop_top = int(round((th - resize_height) / 2.0))
    crop_left = int(round((tw - resize_width) / 2.0))
    return ((crop_top, crop_left),
            (crop_top + resize_height, crop_left + resize_width))


@functools.lru_cache(maxsize=32)
def cogvideox_rope_table(head_dim: int, f: int, h: int, w: int,
                         base_h: int = 30, base_w: int = 45,
                         theta: float = 10000.0,
                         duplicate_first_frame_for_id: bool = False
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin [f*h*w (+h*w), head_dim/2] fp32 for CogVideoX 'linspace'
    grid RoPE, computed in float64.

    Axis dims: t = head_dim/4, h = w = 3*head_dim/8. Each axis grid is
    linspace(start, stop*(n-1)/n, n) over the crop region of the base
    (training) grid ``base_h`` x ``base_w`` (30 x 45 for CogVideoX-5B).
    ``duplicate_first_frame_for_id`` appends a copy of frame 0's rows for
    the FrameINO ID latent frame.
    """
    dim_t = head_dim // 4
    dim_h = dim_w = head_dim // 8 * 3
    (top, left), (bot, right) = get_resize_crop_region_for_grid(
        (h, w), base_w, base_h)
    grid_t = np.linspace(0, f * (f - 1) / f, f, dtype=np.float64)
    grid_h = np.linspace(top, bot * (h - 1) / h, h, dtype=np.float64)
    grid_w = np.linspace(left, right * (w - 1) / w, w, dtype=np.float64)
    at = _freqs_1d(dim_t, grid_t, theta)
    ah = _freqs_1d(dim_h, grid_h, theta)
    aw = _freqs_1d(dim_w, grid_w, theta)

    def combine(ft, fh, fw):
        ft = np.broadcast_to(ft[:, None, None, :], (f, h, w, dim_t // 2))
        fh = np.broadcast_to(fh[None, :, None, :], (f, h, w, dim_h // 2))
        fw = np.broadcast_to(fw[None, None, :, :], (f, h, w, dim_w // 2))
        return np.concatenate([ft, fh, fw], axis=-1).reshape(
            f * h * w, head_dim // 2)

    cos = combine(np.cos(at), np.cos(ah), np.cos(aw)).astype(np.float32)
    sin = combine(np.sin(at), np.sin(ah), np.sin(aw)).astype(np.float32)
    if duplicate_first_frame_for_id:
        cos = np.concatenate([cos, cos[:h * w]], axis=0)
        sin = np.concatenate([sin, sin[:h * w]], axis=0)
    return cos, sin


def apply_rope_interleaved(x, cos, sin):
    """Rotate interleaved pairs. x: [..., S, D]; cos/sin broadcastable to
    [S, D/2]. Math in fp32, returned in x's dtype."""
    shape = x.shape
    xf = x.float().reshape(*shape[:-1], shape[-1] // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    cos = cos.float()
    sin = sin.float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(shape).to(x.dtype)
