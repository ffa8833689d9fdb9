"""CogVideoX VAE, streaming (chunk-walking) and tiled encode/decode
(counterpart of ``frameino_tpu/models/cogvideox_vae_streaming.py``).

The reference's own protocol (diffusers ``AutoencoderKLCogVideoX._encode``
/ ``_decode`` with tiling and slicing on, as its evaluation runs it):

- the clip is walked in frame chunks (8 + r, 8, ... frames to encode; 2 + r,
  2, ... latent frames to decode, the first chunk taking the remainder);
  every kt = 3 causal conv carries its last two input frames to the next
  chunk (a conv cache), and each norm takes its statistics over the chunk;
- frame 0 bypasses the temporal pooling and upsampling only in odd-length
  chunks (the first), as the reference resamples within each chunk;
- large canvases run overlapping 256-pixel tiles (stride 192), each with
  the chunk walk, and blend the seams linearly: in latent space to encode,
  in pixel space to decode.

The numbers equal the segmented full-sequence form
(``models/cogvideox_vae.py``) by construction; the point is memory: one
frame chunk of one tile is live at a time.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from frameino_tpu_torch.models import cogvideox_vae as M

TILE_MIN = 256
TILE_STRIDE = 192


class Chunk:
    """How one chunk pads, norms and resamples: the causal front comes from
    the conv cache (replicated frame 0 on the first chunk), norms take
    per-chunk statistics, frame 0 bypasses resampling in odd chunks."""

    def __init__(self, cache: List[torch.Tensor]):
        self.cache = cache
        self.idx = 0

    def cconv(self, cc: M.CausalConv3d, x):
        kt = cc.kt
        if kt == 1:
            return M.conv3d(x, cc.conv)
        i = self.idx
        self.idx += 1
        if i < len(self.cache):
            front = self.cache[i]
            xx = torch.cat([front.to(x.dtype), x], dim=2)
        else:
            xx = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x],
                           dim=2)
            self.cache.append(None)
        # a copy, so the chunk's activation is not kept alive by the cache
        self.cache[i] = xx[:, :, -(kt - 1):].clone()
        return M.conv3d(xx, cc.conv)

    def norm(self, norm, x):
        return M.group_norm(x, norm)

    def spatial_norm(self, sn: M.SpatialNorm3D, f, zq):
        t = f.shape[2]
        zq = M.repeat_zq(zq, f.shape, bypass_first=t > 1 and t % 2 == 1)
        nf = self.norm(sn.norm_layer, f)
        y = M.conv3d(zq, sn.conv_y.conv)
        b = M.conv3d(zq, sn.conv_b.conv)
        # in the feature dtype, as the JAX walk under a bf16 accumulation
        # scope; fp32 features keep fp32 math
        return nf * y + b

    def pool(self, x):
        return M.pool_time(x, bypass_first=x.shape[2] % 2 == 1)

    def upsample(self, rs, x, time: bool):
        return M.upsample(rs, x, time, bypass_first=x.shape[2] % 2 == 1)


def _chunk_bounds(T: int, fb: int):
    """The first chunk absorbs the remainder (fb + T % fb frames); the
    rest are fb long."""
    nb = max(T // fb, 1)
    r = T - fb * nb
    bounds = [(0, fb + r)]
    for i in range(1, nb):
        s = fb + r + fb * (i - 1)
        bounds.append((s, s + fb))
    return bounds


@torch.no_grad()
def streaming_encode_moments(vae: M.CogVideoXVAE, video):
    """video [B, 3, T, H, W] -> moments [B, 2z, T', H', W'], one frame
    chunk at a time (== ``vae.encode_moments``)."""
    x = video.to(vae.dtype)
    cache: List[torch.Tensor] = []
    outs = []
    for s, e in _chunk_bounds(x.shape[2], vae.cfg.frame_batch_size_encode):
        outs.append(M.encoder_walk(vae.cfg, vae.encoder, x[:, :, s:e],
                                   Chunk(cache)))
    return torch.cat(outs, dim=2)


@torch.no_grad()
def streaming_decode(vae: M.CogVideoXVAE, z):
    """z [B, z, T', H', W'] -> video [B, 3, T, H, W], one latent chunk at
    a time (== ``vae.decode``; not clamped)."""
    x = z.to(vae.dtype)
    cache: List[torch.Tensor] = []
    outs = []
    for s, e in _chunk_bounds(x.shape[2], vae.cfg.frame_batch_size_decode):
        outs.append(M.decoder_walk(vae.cfg, vae.decoder, x[:, :, s:e],
                                   Chunk(cache)))
    return torch.cat(outs, dim=2)


def streaming_encode(vae: M.CogVideoXVAE, video,
                     generator: Optional[torch.Generator] = None,
                     scale: float = 1.0):
    """The condition encode: tiled streaming moments, then a posterior
    sample times ``scale`` (fp32; ``M.sample_posterior``)."""
    return M.sample_posterior(tiled_streaming_encode_moments(vae, video),
                              generator, scale=scale)


# ---------------------------------------------------------------------------
# Spatial tiling x streaming
# ---------------------------------------------------------------------------

def _positions(total: int, tile: int, stride: int):
    """Tile starts, stopping at the first tile that reaches the edge."""
    out = [0]
    while out[-1] + tile < total:
        out.append(out[-1] + stride)
    return out


def _blend_v(a, b, extent: int):
    """Blend the bottom rows of ``a`` into the top rows of ``b``."""
    extent = min(a.shape[-2], b.shape[-2], extent)
    if extent <= 0:
        return b
    w = (torch.arange(extent, dtype=torch.float32, device=b.device)
         / extent).reshape(1, 1, 1, extent, 1)
    top = a[..., -extent:, :] * (1 - w) + b[..., :extent, :] * w
    return torch.cat([top.to(b.dtype), b[..., extent:, :]], dim=-2)


def _blend_h(a, b, extent: int):
    extent = min(a.shape[-1], b.shape[-1], extent)
    if extent <= 0:
        return b
    w = (torch.arange(extent, dtype=torch.float32, device=b.device)
         / extent).reshape(1, 1, 1, 1, extent)
    left = a[..., -extent:] * (1 - w) + b[..., :extent] * w
    return torch.cat([left.to(b.dtype), b[..., extent:]], dim=-1)


def _stitch(rows, blend: int, stride: int):
    """Blend each tile into its upper and left neighbours, crop to the
    stride (the last row/column keeps its remainder) and assemble."""
    out_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_v(rows[i - 1][j], tile, blend)
            if j > 0:
                tile = _blend_h(row[j - 1], tile, blend)
            ch = stride if i < len(rows) - 1 else tile.shape[-2]
            cw = stride if j < len(row) - 1 else tile.shape[-1]
            out_row.append(tile[..., :ch, :cw])
        out_rows.append(torch.cat(out_row, dim=-1))
    return torch.cat(out_rows, dim=-2)


@torch.no_grad()
def tiled_streaming_decode(vae: M.CogVideoXVAE, z, tile_min: int = TILE_MIN,
                           tile_stride: int = TILE_STRIDE):
    """z [B, z, T', h, w] -> video [B, 3, T, H, W]: overlapping tiles, each
    decoded with the chunk walk, blended in pixel space. A canvas that
    fits one tile takes the untiled walk."""
    sc = vae.cfg.spatial_compression_ratio
    h, w = z.shape[3], z.shape[4]
    lat_min, lat_stride = tile_min // sc, tile_stride // sc
    if h <= lat_min and w <= lat_min:
        return streaming_decode(vae, z)
    rows = [[streaming_decode(vae, z[:, :, :, i:i + lat_min, j:j + lat_min])
             for j in _positions(w, lat_min, lat_stride)]
            for i in _positions(h, lat_min, lat_stride)]
    out = _stitch(rows, tile_min - tile_stride, tile_stride)
    return out[:, :, :, :h * sc, :w * sc]


@torch.no_grad()
def tiled_streaming_encode_moments(vae: M.CogVideoXVAE, video,
                                   tile_min: int = TILE_MIN,
                                   tile_stride: int = TILE_STRIDE):
    """video [B, 3, T, H, W] -> moments [B, 2z, T', h, w]: overlapping
    tiles, each encoded with the chunk walk, blended in latent space. A
    canvas that fits one tile takes the untiled walk."""
    sc = vae.cfg.spatial_compression_ratio
    H, W = video.shape[3], video.shape[4]
    if H <= tile_min and W <= tile_min:
        return streaming_encode_moments(vae, video)
    rows = [[streaming_encode_moments(
        vae, video[:, :, :, i:i + tile_min, j:j + tile_min])
        for j in _positions(W, tile_min, tile_stride)]
        for i in _positions(H, tile_min, tile_stride)]
    out = _stitch(rows, (tile_min - tile_stride) // sc, tile_stride // sc)
    return out[:, :, :, :H // sc, :W // sc]
