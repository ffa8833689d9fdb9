"""Streaming (temporally chunked) Wan VAE decode and encode (counterpart of
``frameino_tpu/models/wan_vae_streaming.py``).

The full-sequence ``WanVAE.decode`` holds every decoder activation of the
clip at once: one fp32 tensor of the 704x1280x81 decode is 81 x 352 x 640 x
256 channels, 18.7 GB. This module walks the same ``WanVAE`` modules a
chunk of frames at a time at full width, carrying the reference's per-conv
feature caches across chunks (``autoencoder_kl_wan.py:1198-1227``
frame-by-frame decode, ``:1145-1169`` 1 + 4k encode), so the peak is one
chunk's activations. Decode takes 1 latent frame, then
``chunk_latent_frames`` a step; encode takes 1 pixel frame, then
``chunk_pixel_frames`` (a multiple of 4).

The JAX module runs each chunk as one jitted program; here the chunks run
eagerly and free their activations as they go. Every cache is a tensor,
as in JAX: the reference's "Rep" marker on a fresh upsample3d cache (full
causal zero padding for the time conv, then a zero frame seeded) is
exactly a cache of two zero frames. Numerics equal ``WanVAE.decode`` /
``encode_moments`` (the chunk protocol equals the full-sequence form).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from frameino_tpu_torch.models import wan_vae as M
from frameino_tpu_torch.ops import conv as cops

CACHE_T = 2


class _Caches:
    """The per-conv caches of one streaming pass, one slot per stateful
    layer in call order; ``start`` rewinds to the first slot for the next
    chunk."""

    def __init__(self):
        self.slots: List[torch.Tensor] = []
        self.i = 0

    def start(self):
        self.i = 0

    def get(self) -> Optional[torch.Tensor]:
        return self.slots[self.i] if self.i < len(self.slots) else None

    def put(self, x: torch.Tensor):
        if self.i < len(self.slots):
            self.slots[self.i] = x
        else:
            self.slots.append(x)
        self.i += 1


def _cconv_fwd(x, conv, cache, padding, stride=1):
    """WanCausalConv3d.forward with an explicit cache (the previous
    chunk's last frames stand in for part of the front zero padding)."""
    front = 2 * cops._triple(padding)[0]
    if cache is not None and front > 0:
        x = torch.cat([cache, x], dim=2)
        front -= cache.shape[2]
    # an int8 conv's activation scale spans the cache and the chunk, as JAX
    return cops.causal_conv3d(x, **cops.conv_weights(conv), stride=stride,
                              padding=padding, front=front)


def _tail(x, cache):
    """The last CACHE_T frames of x, a copy (a view would keep the whole
    chunk alive); with one frame, the previous cache's last frame first."""
    tail = x[:, :, -CACHE_T:].clone()
    if tail.shape[2] < CACHE_T and cache is not None:
        tail = torch.cat([cache[:, :, -1:], tail], dim=2)
    return tail


def _cconv_call(x, conv, caches: _Caches):
    cache = caches.get()
    tail = _tail(x, cache)
    out = _cconv_fwd(x, conv, cache, conv.causal_padding)
    caches.put(tail)
    return out


def _res_chunk(blk: M.ResidualBlock, x, caches: _Caches):
    h = blk.conv_shortcut(x) if blk.conv_shortcut is not None else x
    x = _cconv_call(cops.silu_(blk.norm1(x)), blk.conv1, caches)
    x = _cconv_call(cops.silu_(blk.norm2(x)), blk.conv2, caches)
    return x.add_(h)


def _up3d_chunk(rs: M.Resample, x, caches: _Caches):
    """upsample3d: on the first chunk (an empty slot, "Rep" in the
    reference) the time conv is bypassed and the cache seeded with two
    zero frames; later chunks double their frames through it."""
    B, C, T, H, W = x.shape
    cache = caches.get()
    if cache is None:
        caches.put(x.new_zeros(B, C, CACHE_T, H, W))
    else:
        tail = _tail(x, cache)
        x = _cconv_fwd(x, rs.time_conv, cache, (1, 0, 0))
        caches.put(tail)
        # channel halves interleave into frame pairs, as in Resample
        x = x.reshape(B, 2, C, T, H, W).permute(0, 2, 3, 1, 4, 5).reshape(
            B, C, 2 * T, H, W)
    return rs._spatial(x)


def _down3d_chunk(rs: M.Resample, x, caches: _Caches):
    """downsample3d: the first chunk passes as an identity and caches only
    its last frame; later chunks run the stride-2 time conv over that frame
    and their own."""
    x = rs._spatial(x)
    cache = caches.get()
    tail = x[:, :, -1:].clone()
    if cache is not None:
        x = cops.conv3d(torch.cat([cache, x], dim=2),
                        **cops.conv_weights(rs.time_conv), stride=(2, 1, 1))
    caches.put(tail)
    return x


def _resample_chunk(rs: M.Resample, x, caches: _Caches):
    if rs.mode == "upsample3d":
        return _up3d_chunk(rs, x, caches)
    if rs.mode == "downsample3d":
        return _down3d_chunk(rs, x, caches)
    return rs(x)                         # 2D modes: per frame, no state


def _mid_chunk(mid: M.MidBlock, x, caches: _Caches):
    x = _res_chunk(mid.resnets[0], x, caches)
    x = mid.attentions[0](x)
    return _res_chunk(mid.resnets[1], x, caches)


def _decoder_chunk(dec: M.Decoder, x, caches: _Caches, first_chunk: bool):
    caches.start()
    x = _cconv_call(x, dec.conv_in, caches)
    x = _mid_chunk(dec.mid_block, x, caches)
    for blk in dec.up_blocks:
        x_copy = x
        for r in blk.resnets:
            x = _res_chunk(r, x, caches)
        up = getattr(blk, "upsampler", None)
        if up is None and getattr(blk, "upsamplers", None):
            up = blk.upsamplers[0]
        if up is not None:
            x = _resample_chunk(up, x, caches)
        if blk.dup_shortcut:
            x = x.add_(M.dup_up3d(x_copy, blk.out_dim, blk.factor_t, 2,
                                  first_chunk=first_chunk))
    x = cops.silu_(dec.norm_out(x))
    return _cconv_call(x, dec.conv_out, caches)


def _encoder_chunk(enc: M.Encoder, x, caches: _Caches):
    caches.start()
    x = _cconv_call(x, enc.conv_in, caches)
    for blk in enc.down_blocks:
        if isinstance(blk, M.ResidualBlock):
            x = _res_chunk(blk, x, caches)
        elif isinstance(blk, M.Resample):
            x = _resample_chunk(blk, x, caches)
        elif isinstance(blk, M.ResidualDownBlock):
            x_copy = x
            for r in blk.resnets:
                x = _res_chunk(r, x, caches)
            if blk.downsampler is not None:
                x = _resample_chunk(blk.downsampler, x, caches)
            x = x.add_(M.avg_down3d(x_copy, blk.out_dim, blk.factor_t,
                                    blk.factor_s))
        else:                            # AttentionBlock: per frame
            x = blk(x)
    x = _mid_chunk(enc.mid_block, x, caches)
    x = cops.silu_(enc.norm_out(x))
    return _cconv_call(x, enc.conv_out, caches)


def _chunk_sizes(total: int, chunk: int) -> List[int]:
    """1 frame (the causal bootstrap), then ``chunk`` frames a step."""
    sizes = [1]
    while sum(sizes) < total:
        sizes.append(min(chunk, total - sum(sizes)))
    return sizes


@torch.no_grad()
def streaming_decode(vae: M.WanVAE, z, chunk_latent_frames: int = 2,
                     clamp: bool = True):
    """z [B, z, T', h, w] -> video [B, Cout, T, H, W], decoded 1 latent
    frame and then ``chunk_latent_frames`` a step with the conv caches
    carried; the peak is about one chunk's decoder activations."""
    x = vae.post_quant_conv(z)
    caches, outs, pos = _Caches(), [], 0
    for ci, n in enumerate(_chunk_sizes(x.shape[2], chunk_latent_frames)):
        outs.append(_decoder_chunk(vae.decoder, x[:, :, pos:pos + n], caches,
                                   first_chunk=ci == 0))
        pos += n
    del caches, x
    out = torch.cat(outs, dim=2)
    del outs
    if vae.cfg.patch_size is not None:
        out = M.unpatchify(out, vae.cfg.patch_size)
    return out.clamp_(-1.0, 1.0) if clamp else out


def encode_moments_inline(vae: M.WanVAE, video, chunk_pixel_frames: int = 8):
    """Chunked encode with autograd left as the caller has it (the train
    step's form; the JAX function is the traceable one that runs inside
    the one-jit step): 1 pixel frame, then ``chunk_pixel_frames`` (a
    multiple of 4) a step. video [B, Cin, T, H, W] -> moments [B, 2z, T',
    H', W'], equal to ``WanVAE.encode_moments``."""
    if chunk_pixel_frames % 4:
        raise ValueError(f"chunk_pixel_frames must be a multiple of 4, got "
                         f"{chunk_pixel_frames}")
    x = video
    if vae.cfg.patch_size is not None:
        x = M.patchify(x, vae.cfg.patch_size)
    caches, outs, pos = _Caches(), [], 0
    for n in _chunk_sizes(x.shape[2], chunk_pixel_frames):
        outs.append(_encoder_chunk(vae.encoder, x[:, :, pos:pos + n], caches))
        pos += n
    del caches
    return vae.quant_conv(torch.cat(outs, dim=2))


@torch.no_grad()
def streaming_encode_moments(vae: M.WanVAE, video,
                             chunk_pixel_frames: int = 8):
    """Chunked encode (1 pixel frame, then multiples of 4) without
    autograd: ``encode_moments_inline`` under ``torch.no_grad``."""
    return encode_moments_inline(vae, video, chunk_pixel_frames)
