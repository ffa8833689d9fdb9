"""Timestep, text-projection and CogVideoX sincos position embeddings
(counterpart of ``frameino_tpu/ops/embeddings.py``)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from frameino_tpu_torch.ops.linear import dense, gelu_tanh, silu


def sinusoidal_timestep_embedding(timesteps, num_channels: int,
                                  flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0,
                                  max_period: float = 10000.0):
    """diffusers ``get_timestep_embedding``. timesteps: [...] float.
    Returns [..., num_channels] fp32."""
    half = num_channels // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[..., None] * torch.exp(exponent)
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[..., half:], emb[..., :half]], dim=-1)
    return emb


def timestep_embedding_mlp(temb, linear_1, linear_2):
    """TimestepEmbedding: linear_1 -> SiLU -> linear_2, in fp32 (the
    weights are cast up, as the JAX ``dense`` casts to x's dtype)."""
    h = dense(temb, linear_1.weight, linear_1.bias, out_dtype=torch.float32)
    h = silu(h)
    return dense(h, linear_2.weight, linear_2.bias, out_dtype=torch.float32)


def pixart_text_projection(text, linear_1, linear_2, out_dtype=None):
    """PixArtAlphaTextProjection with gelu_tanh."""
    h = dense(text, linear_1.weight, linear_1.bias, out_dtype=out_dtype)
    h = gelu_tanh(h)
    return dense(h, linear_2.weight, linear_2.bias, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# CogVideoX 3D sincos table (host side, float64 omega)
# ---------------------------------------------------------------------------

def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """[M, embed_dim]: concat(sin, cos) halves."""
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000.0 ** omega
    out = np.outer(pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


@functools.lru_cache(maxsize=16)
def cogvideox_3d_sincos_pos_embed(embed_dim: int, height: int, width: int,
                                  temporal: int,
                                  spatial_interpolation_scale: float = 1.875,
                                  temporal_interpolation_scale: float = 1.0
                                  ) -> np.ndarray:
    """[T, H*W, D] fp32: D/4 temporal, then 3D/4 spatial. The spatial half
    embeds the w coordinates first and the h coordinates second (diffusers
    ``get_3d_sincos_pos_embed``, meshgrid(w, h) stacked as (w, h))."""
    embed_dim_spatial = 3 * embed_dim // 4
    embed_dim_temporal = embed_dim // 4
    grid_h = np.arange(height, dtype=np.float32) / spatial_interpolation_scale
    grid_w = np.arange(width, dtype=np.float32) / spatial_interpolation_scale
    gw, gh = np.meshgrid(grid_w, grid_h)
    spatial = np.concatenate([_sincos_1d(embed_dim_spatial // 2, gw),
                              _sincos_1d(embed_dim_spatial // 2, gh)], axis=1)
    grid_t = np.arange(temporal, dtype=np.float32) \
        / temporal_interpolation_scale
    temporal_e = _sincos_1d(embed_dim_temporal, grid_t)
    spatial = np.broadcast_to(spatial[None], (temporal, height * width,
                                              embed_dim_spatial))
    temporal_e = np.broadcast_to(temporal_e[:, None], (temporal, height * width,
                                                       embed_dim_temporal))
    return np.concatenate([temporal_e, spatial], axis=-1).astype(np.float32)
