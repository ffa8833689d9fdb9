"""Timestep and text-projection embeddings (counterpart of
``frameino_tpu/ops/embeddings.py``; the CogVideoX sincos table is not
ported)."""

from __future__ import annotations

import math

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
