"""Spatial tiling and batch slicing for the Wan VAE (counterpart of
``frameino_tpu/models/wan_vae_tiling.py``).

Reference ``architecture/autoencoder_kl_wan.py``: ``enable_slicing``
(:1121-1133, a per-sample batch split) and ``enable_tiling``
(:1084-1112, :1270-1397): overlapping spatial tiles encoded or decoded
one after another and blended linearly (``blend_v``/``blend_h``,
:1254-1268), so the peak is one tile's activations. Tiles of 256 sample
pixels at a stride of 192 by default.

The hybrid forms stream each tile through ``wan_vae_streaming`` (a chunk
of frames at a time), so their peak is one chunk of one tile; the
streaming is exact, so hybrid equals tiled and only the blended seams
differ from the full-sequence forms.
"""

from __future__ import annotations

from typing import List

import torch

from frameino_tpu_torch.models import wan_vae
from frameino_tpu_torch.models.wan_vae_streaming import (
    streaming_decode, streaming_encode_moments)

TILE_SAMPLE_MIN = 256
TILE_SAMPLE_STRIDE = 192


def _positions(total: int, tile: int, stride: int) -> List[int]:
    """Tile start positions, stopping at the first tile that reaches the
    edge (the reference's ``range(0, total, stride)`` adds truncated tail
    tiles that cover nothing new)."""
    out = [0]
    while out[-1] + tile < total:
        out.append(out[-1] + stride)
    return out


def _blend_weights(extent: int, like, dim: int):
    w = torch.arange(extent, dtype=torch.float32, device=like.device) / extent
    shape = [1] * like.dim()
    shape[dim] = extent
    return w.reshape(shape)


def _blend_v(a, b, extent: int):
    """Blend the bottom rows of ``a`` into the top rows of ``b``
    (reference ``blend_v``)."""
    extent = min(a.shape[-2], b.shape[-2], extent)
    if extent <= 0:
        return b
    w = _blend_weights(extent, b, -2)
    top = a[..., -extent:, :] * (1 - w) + b[..., :extent, :] * w
    return torch.cat([top.to(b.dtype), b[..., extent:, :]], dim=-2)


def _blend_h(a, b, extent: int):
    extent = min(a.shape[-1], b.shape[-1], extent)
    if extent <= 0:
        return b
    w = _blend_weights(extent, b, -1)
    left = a[..., -extent:] * (1 - w) + b[..., :extent] * w
    return torch.cat([left.to(b.dtype), b[..., extent:]], dim=-1)


def _stitch(rows, n_rows: int, n_cols: int, stride: int, blend: int):
    """Blend each tile into its upper and left neighbours and keep its
    ``stride`` leading rows and columns (the last row and column keep their
    full extent: they cover the edge)."""
    result_rows = []
    for i, row in enumerate(rows):
        result_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_v(rows[i - 1][j], tile, blend)
            if j > 0:
                tile = _blend_h(row[j - 1], tile, blend)
            ch = stride if i < n_rows - 1 else tile.shape[-2]
            cw = stride if j < n_cols - 1 else tile.shape[-1]
            result_row.append(tile[..., :ch, :cw])
        result_rows.append(torch.cat(result_row, dim=-1))
    return torch.cat(result_rows, dim=-2)


@torch.no_grad()
def tiled_encode(vae: wan_vae.WanVAE, video,
                 tile_min: int = TILE_SAMPLE_MIN,
                 tile_stride: int = TILE_SAMPLE_STRIDE, encode_fn=None):
    """Overlapping-tile encode blended in latent space (reference
    ``tiled_encode`` :1270-1334). video [B, C, T, H, W] -> moments.
    ``encode_fn(tile) -> moments`` replaces the per-tile encoder."""
    H, W = video.shape[3], video.shape[4]
    if encode_fn is None:
        encode_fn = vae.encode_moments
    if H <= tile_min and W <= tile_min:
        return encode_fn(video)
    sc = vae.cfg.scale_factor_spatial
    lat_stride = tile_stride // sc
    blend = tile_min // sc - lat_stride
    ys = _positions(H, tile_min, tile_stride)
    xs = _positions(W, tile_min, tile_stride)
    rows = [[encode_fn(video[:, :, :, i:i + tile_min, j:j + tile_min])
             for j in xs] for i in ys]
    out = _stitch(rows, len(ys), len(xs), lat_stride, blend)
    return out[..., :H // sc, :W // sc]


@torch.no_grad()
def tiled_decode(vae: wan_vae.WanVAE, z, tile_min: int = TILE_SAMPLE_MIN,
                 tile_stride: int = TILE_SAMPLE_STRIDE, decode_fn=None):
    """Overlapping-tile decode blended in pixel space (reference
    ``tiled_decode`` :1336-1397). z [B, z, T, h, w] -> video in [-1, 1].
    ``decode_fn(tile) -> pixels`` (unclamped) replaces the per-tile
    decoder."""
    sc = vae.cfg.scale_factor_spatial
    h, w = z.shape[3], z.shape[4]
    lat_min = tile_min // sc
    lat_stride = tile_stride // sc
    if decode_fn is None:
        def decode_fn(t):
            return vae.decode(t, clamp=False)
    if h <= lat_min and w <= lat_min:
        return decode_fn(z).clamp_(-1.0, 1.0)
    ys = _positions(h, lat_min, lat_stride)
    xs = _positions(w, lat_min, lat_stride)
    rows = [[decode_fn(z[:, :, :, i:i + lat_min, j:j + lat_min])
             for j in xs] for i in ys]
    out = _stitch(rows, len(ys), len(xs), tile_stride,
                  tile_min - tile_stride)
    del rows
    return out[..., :h * sc, :w * sc].clamp_(-1.0, 1.0)


def hybrid_decode(vae: wan_vae.WanVAE, z, tile_min: int = TILE_SAMPLE_MIN,
                  tile_stride: int = TILE_SAMPLE_STRIDE,
                  chunk_latent_frames: int = 2):
    """Streaming x tiled decode: large spatial tiles (few, with little
    overlap) each decoded a chunk of latent frames at a time, so the peak
    is one chunk of one tile. The reference offers tiling only
    (:1336-1397); its frame-by-frame decode is a separate mode
    (:1198-1227)."""
    def decode_fn(tile):
        return streaming_decode(vae, tile,
                                chunk_latent_frames=chunk_latent_frames,
                                clamp=False)
    return tiled_decode(vae, z, tile_min=tile_min, tile_stride=tile_stride,
                        decode_fn=decode_fn)


def hybrid_encode(vae: wan_vae.WanVAE, video,
                  tile_min: int = TILE_SAMPLE_MIN,
                  tile_stride: int = TILE_SAMPLE_STRIDE,
                  chunk_pixel_frames: int = 16):
    """Streaming x tiled encode, the dual of ``hybrid_decode``."""
    def encode_fn(tile):
        return streaming_encode_moments(
            vae, tile, chunk_pixel_frames=chunk_pixel_frames)
    return tiled_encode(vae, video, tile_min=tile_min,
                        tile_stride=tile_stride, encode_fn=encode_fn)


def sliced_encode(vae: wan_vae.WanVAE, video, **kw):
    """Per-sample batch slicing (reference ``enable_slicing``
    :1187-1191) around ``tiled_encode``."""
    return torch.cat([tiled_encode(vae, video[i:i + 1], **kw)
                      for i in range(video.shape[0])], dim=0)


def sliced_decode(vae: wan_vae.WanVAE, z, **kw):
    return torch.cat([tiled_decode(vae, z[i:i + 1], **kw)
                      for i in range(z.shape[0])], dim=0)
