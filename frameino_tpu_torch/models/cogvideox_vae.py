"""CogVideoX causal 3D video VAE, segmented full-sequence form (counterpart
of ``frameino_tpu/models/cogvideox_vae.py``).

diffusers' ``AutoencoderKLCogVideoX``: causal 3D convs with replicated
first frames as temporal padding, 4x temporal (frame 0 bypasses the
pooling) and 8x spatial compression, a GroupNorm encoder and a decoder
whose norms are conditioned on the latent (SpatialNorm3D). Module and
parameter names are diffusers', so its state dict and the weight bridge
load through ``load_state_dict``.

The reference encodes in frame batches (8 + r, 8, ...) and decodes in
latent batches (2 + r, 2, ...) with a conv cache, and its norms take their
statistics per batch. The full-sequence form here runs each conv once
over the clip and reproduces the per-batch statistics with *segmented*
norms (a first segment, then ``count`` segments of ``rest`` frames at every
depth). The chunk walk itself is ``models/cogvideox_vae_streaming.py``;
both share the encoder and decoder walks below through a small context
object that says how convs pad in time, how norms segment and how the
temporal pooling and upsampling treat frame 0.

Layout is torch's channels-first: video [B, C, T, H, W]. The VAE runs in
its weights' dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from frameino_tpu_torch.ops.conv import (low_precision_dtype, scoped_conv,
                                        silu_)


@dataclasses.dataclass(frozen=True)
class CogVideoXVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    latent_channels: int = 16
    layers_per_block: int = 3
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    temporal_compression_ratio: int = 4
    scaling_factor: float = 1.15258426
    frame_batch_size_encode: int = 8
    frame_batch_size_decode: int = 2

    @property
    def temporal_compress_level(self) -> int:
        return int(math.log2(self.temporal_compression_ratio))

    @property
    def spatial_compression_ratio(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


COGVIDEOX_VAE_CONFIG = CogVideoXVAEConfig()


def tiny_vae_config(**kw) -> CogVideoXVAEConfig:
    base = dict(block_out_channels=(8, 8, 16), latent_channels=4,
                layers_per_block=1, norm_num_groups=4)
    base.update(kw)
    return CogVideoXVAEConfig(**base)


class Seg(NamedTuple):
    """Temporal segmentation: a first segment + ``count`` of ``rest``."""
    first: int
    rest: int
    count: int


def _segments(num_frames: int, fb: int) -> Seg:
    nb = max(num_frames // fb, 1)
    if nb == 1:
        return Seg(num_frames, 0, 0)
    return Seg(fb + num_frames % fb, fb, nb - 1)


# ---------------------------------------------------------------------------
# Modules (diffusers names)
# ---------------------------------------------------------------------------

class CausalConv3d(nn.Module):
    """CogVideoXCausalConv3d: the Conv3d lives at ``.conv``."""

    def __init__(self, cin, cout, kernel, **kw):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel, **kw)

    @property
    def kt(self) -> int:
        return self.conv.weight.shape[2]


class SpatialNorm3D(nn.Module):
    """GroupNorm(f) * conv_y(zq) + conv_b(zq)."""

    def __init__(self, f_ch, zq_ch, groups, eps, **kw):
        super().__init__()
        self.norm_layer = nn.GroupNorm(groups, f_ch, eps=eps, **kw)
        self.conv_y = CausalConv3d(zq_ch, f_ch, 1, **kw)
        self.conv_b = CausalConv3d(zq_ch, f_ch, 1, **kw)


class ResnetBlock3D(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, cin, cout, zq_ch=None, **kw):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        if zq_ch is None:
            self.norm1 = nn.GroupNorm(g, cin, eps=eps, **kw)
            self.norm2 = nn.GroupNorm(g, cout, eps=eps, **kw)
        else:
            self.norm1 = SpatialNorm3D(cin, zq_ch, g, eps, **kw)
            self.norm2 = SpatialNorm3D(cout, zq_ch, g, eps, **kw)
        self.conv1 = CausalConv3d(cin, cout, 3, **kw)
        self.conv2 = CausalConv3d(cout, cout, 3, **kw)
        # diffusers' default shortcut: a plain 1x1x1 (Safe)Conv3d
        self.conv_shortcut = (nn.Conv3d(cin, cout, 1, **kw)
                              if cin != cout else None)


class _Resample(nn.Module):
    """CogVideoXDownsample3D / CogVideoXUpsample3D: a per-frame Conv2d."""

    def __init__(self, ch, stride, padding, **kw):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=padding, **kw)


class _Block(nn.Module):
    def __init__(self, resnets, sampler_name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class Encoder(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, **kw):
        super().__init__()
        boc = cfg.block_out_channels
        self.conv_in = CausalConv3d(cfg.in_channels, boc[0], 3, **kw)
        blocks = []
        ch = boc[0]
        for i, out_ch in enumerate(boc):
            res = []
            for _ in range(cfg.layers_per_block):
                res.append(ResnetBlock3D(cfg, ch, out_ch, **kw))
                ch = out_ch
            down = (_Resample(ch, 2, 0, **kw) if i < len(boc) - 1 else None)
            blocks.append(_Block(res, "downsamplers", down))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _Block([ResnetBlock3D(cfg, ch, ch, **kw)
                                 for _ in range(2)])
        self.norm_out = nn.GroupNorm(cfg.norm_num_groups, ch,
                                     eps=cfg.norm_eps, **kw)
        self.conv_out = CausalConv3d(ch, 2 * cfg.latent_channels, 3, **kw)


class Decoder(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, **kw):
        super().__init__()
        rboc = list(reversed(cfg.block_out_channels))
        zc = cfg.latent_channels
        self.conv_in = CausalConv3d(zc, rboc[0], 3, **kw)
        self.mid_block = _Block([ResnetBlock3D(cfg, rboc[0], rboc[0], zc,
                                               **kw) for _ in range(2)])
        blocks = []
        ch = rboc[0]
        for i, out_ch in enumerate(rboc):
            res = []
            for _ in range(cfg.layers_per_block + 1):
                res.append(ResnetBlock3D(cfg, ch, out_ch, zc, **kw))
                ch = out_ch
            up = (_Resample(ch, 1, 1, **kw) if i < len(rboc) - 1 else None)
            blocks.append(_Block(res, "upsamplers", up))
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = SpatialNorm3D(ch, zc, cfg.norm_num_groups,
                                      cfg.norm_eps, **kw)
        self.conv_out = CausalConv3d(ch, cfg.out_channels, 3, **kw)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def conv3d(x, conv: nn.Conv3d, front=None):
    """Conv with zero spatial SAME padding; ``front`` (the kt - 1 frames
    before x) is prepended in time. Weights are cast to x's dtype."""
    if front is not None:
        x = torch.cat([front.to(x.dtype), x], dim=2)
    ph = conv.weight.shape[-1] // 2
    return scoped_conv(F.conv3d, x, conv.weight, conv.bias,
                       padding=(0, ph, ph))


def group_norm(x, norm: nn.GroupNorm, seg: Optional[Seg] = None):
    """GroupNorm with statistics over (C/G, T_segment, H, W) per segment of
    ``seg`` (one segment when None). Under a low-precision ``conv_dtype``
    scope it normalizes and scales in fp32 and rounds once, as
    ``group_norm_seg`` in JAX."""
    if low_precision_dtype() is not None and x.dtype != torch.float32:
        w, b = norm.weight.float(), norm.bias.float()

        def gn(y):
            return F.group_norm(y.float(), norm.num_groups, w, b,
                                norm.eps).to(y.dtype)
    else:
        w, b = norm.weight.to(x.dtype), norm.bias.to(x.dtype)

        def gn(y):
            return F.group_norm(y, norm.num_groups, w, b, norm.eps)

    if seg is None or seg.count == 0:
        return gn(x)
    B, C, _, H, W = x.shape
    rest = x[:, :, seg.first:].reshape(B, C, seg.count, seg.rest, H, W)
    rest = rest.transpose(1, 2).reshape(B * seg.count, C, seg.rest, H, W)
    rest = gn(rest).reshape(B, seg.count, C, seg.rest, H, W).transpose(1, 2)
    return torch.cat([gn(x[:, :, :seg.first]),
                      rest.reshape(B, C, seg.count * seg.rest, H, W)], dim=2)


def _pair_mean(x):
    """Mean of consecutive frame pairs: [B, C, 2n, H, W] -> [B, C, n, H, W]
    (summed in fp32, as jnp.mean does for bf16)."""
    B, C, T, H, W = x.shape
    return x.reshape(B, C, T // 2, 2, H, W).float().mean(3).to(x.dtype)


def pool_time(x, bypass_first: bool):
    """Temporal 2x average pooling; frame 0 bypasses it when asked."""
    if not bypass_first:
        return _pair_mean(x)
    if x.shape[2] == 1:
        return x
    return torch.cat([x[:, :, :1], _pair_mean(x[:, :, 1:])], dim=2)


def spatial_downsample(rs: _Resample, x):
    """ZeroPad (0, 1, 0, 1) + per-frame Conv2d stride 2."""
    x = F.pad(x, (0, 1, 0, 1))
    return scoped_conv(F.conv3d, x, rs.conv.weight[:, :, None], rs.conv.bias,
                       stride=(1, 2, 2))


def upsample(rs: _Resample, x, time: bool, bypass_first: bool):
    """CogVideoXUpsample3D: nearest 2x in time (frame 0 bypassing when
    asked) and space, then a per-frame Conv2d 3x3."""
    if time and x.shape[2] > 1:
        if bypass_first:
            x = torch.cat([x[:, :, :1],
                           x[:, :, 1:].repeat_interleave(2, dim=2)], dim=2)
        else:
            x = x.repeat_interleave(2, dim=2)
    x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    return scoped_conv(F.conv3d, x, rs.conv.weight[:, :, None], rs.conv.bias,
                       padding=(0, 1, 1))


def repeat_zq(zq, f_shape, bypass_first: bool):
    """Nearest resize of the latent zq to the feature grid (SpatialNorm3D's
    F.interpolate): with ``bypass_first`` frame 0 maps to frame 0 and the
    rest repeat uniformly; integer spatial repeat."""
    Tf, Hf, Wf = f_shape[2], f_shape[3], f_shape[4]
    Tz, Hz, Wz = zq.shape[2], zq.shape[3], zq.shape[4]
    if Tf != Tz:
        if bypass_first:
            r = (Tf - 1) // max(Tz - 1, 1)
            zq = torch.cat([zq[:, :, :1],
                            zq[:, :, 1:].repeat_interleave(r, dim=2)], dim=2)
        else:
            zq = zq.repeat_interleave(Tf // Tz, dim=2)
    if Hf != Hz:
        zq = zq.repeat_interleave(Hf // Hz, dim=3).repeat_interleave(
            Wf // Wz, dim=4)
    return zq


# ---------------------------------------------------------------------------
# The walks, shared by the full-sequence and the chunked forms
# ---------------------------------------------------------------------------

class FullSequence:
    """How the full-sequence form pads, norms and resamples: replicated
    first frames as the causal front, segmented norms, frame 0 always
    bypassing the temporal pooling and upsampling."""

    def __init__(self, seg: Seg):
        self.seg = seg

    def cconv(self, cc: CausalConv3d, x):
        kt = cc.kt
        front = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1) if kt > 1 \
            else None
        return conv3d(x, cc.conv, front)

    def norm(self, norm: nn.GroupNorm, x):
        return group_norm(x, norm, self.seg)

    def spatial_norm(self, sn: SpatialNorm3D, f, zq):
        zq = repeat_zq(zq, f.shape, bypass_first=True)
        nf = self.norm(sn.norm_layer, f)
        y = conv3d(zq, sn.conv_y.conv)
        b = conv3d(zq, sn.conv_b.conv)
        return (nf.float() * y.float() + b.float()).to(f.dtype)

    def pool(self, x):
        s = self.seg
        self.seg = Seg((s.first + 1) // 2, s.rest // 2, s.count)
        return pool_time(x, bypass_first=True)

    def upsample(self, rs, x, time: bool):
        if time:
            s = self.seg
            self.seg = Seg(2 * s.first - 1, 2 * s.rest, s.count)
        return upsample(rs, x, time, bypass_first=True)


def _norm(ctx, norm, x, zq):
    if zq is None:
        return ctx.norm(norm, x)
    return ctx.spatial_norm(norm, x, zq)


def resnet_forward(ctx, res: ResnetBlock3D, x, zq=None):
    h = silu_(_norm(ctx, res.norm1, x, zq))
    h = ctx.cconv(res.conv1, h)
    h = silu_(_norm(ctx, res.norm2, h, zq))
    h = ctx.cconv(res.conv2, h)
    if res.conv_shortcut is not None:
        x = conv3d(x, res.conv_shortcut)
    return x + h


def encoder_walk(cfg: CogVideoXVAEConfig, enc: Encoder, x, ctx):
    x = ctx.cconv(enc.conv_in, x)
    for i, blk in enumerate(enc.down_blocks):
        for r in blk.resnets:
            x = resnet_forward(ctx, r, x)
        if hasattr(blk, "downsamplers"):
            if i < cfg.temporal_compress_level:
                x = ctx.pool(x)
            x = spatial_downsample(blk.downsamplers[0], x)
    for r in enc.mid_block.resnets:
        x = resnet_forward(ctx, r, x)
    x = silu_(ctx.norm(enc.norm_out, x))
    return ctx.cconv(enc.conv_out, x)


def decoder_walk(cfg: CogVideoXVAEConfig, dec: Decoder, z, ctx):
    zq = z
    x = ctx.cconv(dec.conv_in, z)
    for r in dec.mid_block.resnets:
        x = resnet_forward(ctx, r, x, zq)
    for i, blk in enumerate(dec.up_blocks):
        for r in blk.resnets:
            x = resnet_forward(ctx, r, x, zq)
        if hasattr(blk, "upsamplers"):
            x = ctx.upsample(blk.upsamplers[0], x,
                             i < cfg.temporal_compress_level)
    x = silu_(ctx.spatial_norm(dec.norm_out, x, zq))
    return ctx.cconv(dec.conv_out, x)


class CogVideoXVAE(nn.Module):
    """AutoencoderKLCogVideoX, full-sequence encode/decode."""

    def __init__(self, cfg: CogVideoXVAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.encoder = Encoder(cfg, **kw)
        self.decoder = Decoder(cfg, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.conv_in.conv.weight.dtype

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Seeded init mirroring ``init_cogvideox_vae``: uniform(+-1/
        sqrt(fan_in)) conv weights and biases, unit GroupNorm gains and
        zero biases."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv3d)):
                bound = mod.weight[0].numel() ** -0.5
                for p in (mod.weight, mod.bias):
                    r = torch.rand(p.shape, generator=generator,
                                   device=generator.device,
                                   dtype=torch.float32)
                    p.copy_(r.mul_(2 * bound).sub_(bound))
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        return self

    @torch.no_grad()
    def encode_moments(self, video, dtype: Optional[torch.dtype] = None):
        """video [B, 3, T, H, W] -> moments [B, 2z, T', H', W'], computed
        in ``dtype`` (default the weights'; the convs and norms cast their
        weights to it)."""
        seg = _segments(video.shape[2], self.cfg.frame_batch_size_encode)
        return encoder_walk(self.cfg, self.encoder,
                            video.to(dtype or self.dtype), FullSequence(seg))

    def encode(self, video, sample_mode: str = "sample",
               generator: Optional[torch.Generator] = None, noise=None):
        """The posterior of ``encode_moments``: its mean ("argmax"), or a
        sample (``sample_posterior``: logvar clipped to [-30, 20], mean +
        std * noise) with ``noise`` given or drawn from ``generator``; the
        sample is fp32."""
        moments = self.encode_moments(video)
        if sample_mode == "argmax":
            return moments[:, :self.cfg.latent_channels]
        if sample_mode != "sample":
            raise ValueError(f"sample_mode must be 'sample' or 'argmax', "
                             f"got {sample_mode!r}")
        return sample_posterior(moments, generator, noise)

    @torch.no_grad()
    def decode(self, z):
        """z [B, z, T', H', W'] -> video [B, 3, T, H, W] (not clamped)."""
        seg = _segments(z.shape[2], self.cfg.frame_batch_size_decode)
        return decoder_walk(self.cfg, self.decoder, z.to(self.dtype),
                            FullSequence(seg))


def sample_posterior(moments, generator: Optional[torch.Generator] = None,
                     noise=None, scale: float = 1.0):
    """(mean + exp(logvar / 2) * noise) * scale as fp32, logvar clipped to
    [-30, 20]; ``noise`` (shaped like the mean) is drawn from ``generator``
    unless given. Under a low-precision ``conv_dtype`` scope, low-precision
    moments take each step in their own dtype, as JAX's ``encode`` and the
    ``* scaling_factor`` after it (the scale rounded to that dtype too);
    otherwise the math is fp32."""
    mean, logvar = moments.chunk(2, dim=1)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=generator.device if generator is not None
                            else mean.device, dtype=torch.float32)
    noise = noise.to(mean.device)
    if low_precision_dtype() is not None and mean.dtype != torch.float32:
        # a Python scale is weakly typed in JAX: it rounds to mean's dtype
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        z = mean + std * noise.to(mean.dtype)
        return (z * torch.tensor(scale, dtype=mean.dtype)).float()
    std = torch.exp(0.5 * logvar.float().clamp(-30.0, 20.0))
    return (mean.float() + std * noise.float()) * scale


def init_cogvideox_vae(cfg: CogVideoXVAEConfig, generator: torch.Generator,
                       dtype: torch.dtype = torch.float32) -> CogVideoXVAE:
    """Seeded random CogVideoXVAE on ``generator``'s device."""
    model = CogVideoXVAE(cfg, device="meta", dtype=dtype)
    model.to_empty(device=generator.device)
    return model.init_random_(generator).eval()
