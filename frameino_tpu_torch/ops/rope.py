"""Interleaved-pair rotary embeddings for the Wan DiT (counterpart of
``frameino_tpu/ops/rope.py``; the CogVideoX tables are not ported).

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
