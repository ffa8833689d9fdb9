"""Wan causal 3D video VAE (Wan 2.1 / 2.2), full-sequence form (counterpart
of ``frameino_tpu/models/wan_vae.py``).

As in the JAX package, every causal conv runs once over the whole clip:
for stride-1 temporal convs that equals the reference's chunked
feature-cache streaming, and the temporal down/upsampling layers' first-
frame bypass is reproduced in closed form (see the JAX module's note).
Module and parameter names follow diffusers ``AutoencoderKLWan``, so its
state dict and the weight bridge load through ``load_state_dict``.

Layout is torch's channels-first: video [B, C, T, H, W]. The VAE runs in
fp32. The mid-block attention is the plain ``attention_ref``, as the JAX
package uses ``attention_xla`` there.

The streaming, tiled and hybrid forms walk these modules in
``wan_vae_streaming.py`` and ``wan_vae_tiling.py``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from frameino_tpu_torch.ops import conv as cops
from frameino_tpu_torch.ops.attention import attention_ref
from frameino_tpu_torch.ops.norms import l2_normalize_channel

# In-repo Wan2.1 normalization stats (reference autoencoder_kl_wan.py).
WAN21_LATENTS_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
)
WAN21_LATENTS_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    base_dim: int = 96
    decoder_base_dim: Optional[int] = None
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    is_residual: bool = False
    in_channels: int = 3
    out_channels: int = 3
    patch_size: Optional[int] = None
    scale_factor_temporal: int = 4
    scale_factor_spatial: int = 8
    latents_mean: Tuple[float, ...] = WAN21_LATENTS_MEAN
    latents_std: Tuple[float, ...] = WAN21_LATENTS_STD

    @property
    def temperal_upsample(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.temperal_downsample))

    @property
    def dec_base_dim(self) -> int:
        return self.decoder_base_dim or self.base_dim


# Wan2.2-TI2V-5B VAE (z=48, 4x temporal / 16x spatial via patchify,
# residual blocks). The checkpoint's normalization stats load with its
# weights; unit placeholders here.
WAN22_VAE_CONFIG = WanVAEConfig(
    base_dim=160, decoder_base_dim=256, z_dim=48, is_residual=True,
    in_channels=12, out_channels=12, patch_size=2, scale_factor_spatial=16,
    latents_mean=tuple([0.0] * 48), latents_std=tuple([1.0] * 48))


# ---------------------------------------------------------------------------
# Blocks (diffusers names)
# ---------------------------------------------------------------------------

class CausalConv3d(nn.Conv3d):
    """WanCausalConv3d: front-only temporal padding (2 * pad_t)."""

    def __init__(self, cin, cout, kernel, padding=0, **kw):
        super().__init__(cin, cout, kernel, **kw)
        self.causal_padding = cops._triple(padding)

    def forward(self, x):
        return cops.causal_conv3d(x, self.weight, self.bias,
                                  padding=self.causal_padding)


class RMSNormC(nn.Module):
    """WanRMS_norm over channels (dim 1); gamma [C, 1, 1(, 1)]."""

    def __init__(self, dim, images: bool = False, **kw):
        super().__init__()
        shape = (dim, 1, 1) if images else (dim, 1, 1, 1)
        self.gamma = nn.Parameter(torch.empty(shape, **kw))

    def forward(self, x):
        return l2_normalize_channel(x, x.shape[1] ** 0.5, self.gamma, dim=1)


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.norm1 = RMSNormC(cin, **kw)
        self.conv1 = CausalConv3d(cin, cout, 3, padding=1, **kw)
        self.norm2 = RMSNormC(cout, **kw)
        self.conv2 = CausalConv3d(cout, cout, 3, padding=1, **kw)
        self.conv_shortcut = (CausalConv3d(cin, cout, 1, **kw)
                              if cin != cout else None)

    def forward(self, x):
        h = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        x = self.conv1(cops.silu_(self.norm1(x)))
        x = self.conv2(cops.silu_(self.norm2(x)))
        return x.add_(h)


class AttentionBlock(nn.Module):
    """Per-frame single-head spatial self-attention."""

    def __init__(self, dim, **kw):
        super().__init__()
        self.norm = RMSNormC(dim, images=True, **kw)
        self.to_qkv = nn.Conv2d(dim, 3 * dim, 1, **kw)
        self.proj = nn.Conv2d(dim, dim, 1, **kw)

    def forward(self, x):
        B, C, T, H, W = x.shape
        identity = x
        x4 = x.permute(0, 2, 1, 3, 4).reshape(B * T, C, H, W)
        qkv = cops.conv2d(self.norm(x4), self.to_qkv.weight,
                          self.to_qkv.bias, padding="valid")
        qkv = qkv.reshape(B * T, 3 * C, H * W).transpose(1, 2)[:, None]
        q, k, v = qkv.chunk(3, dim=-1)                  # [BT, 1, HW, C]
        o = attention_ref(q, k, v)[:, 0].transpose(1, 2)
        o = cops.conv2d(o.reshape(B * T, C, H, W), self.proj.weight,
                        self.proj.bias, padding="valid")
        return o.reshape(B, T, C, H, W).permute(0, 2, 1, 3, 4) + identity


class Resample(nn.Module):
    """WanResample: per-frame 2D up/down conv (``resample.1``) plus the
    temporal ``time_conv`` of the 3D modes."""

    def __init__(self, dim, mode: str, upsample_out_dim=None, **kw):
        super().__init__()
        self.mode = mode
        if mode.startswith("upsample"):
            out = upsample_out_dim if upsample_out_dim is not None \
                else dim // 2
            conv = nn.Conv2d(dim, out, 3, **kw)
        else:
            conv = nn.Conv2d(dim, dim, 3, **kw)
        self.resample = nn.ModuleList([nn.Identity(), conv])
        self.time_conv = None
        if mode == "downsample3d":
            self.time_conv = CausalConv3d(dim, dim, (3, 1, 1), **kw)
        elif mode == "upsample3d":
            self.time_conv = CausalConv3d(dim, 2 * dim, (3, 1, 1), **kw)

    def _spatial(self, x):
        B, C, T, H, W = x.shape
        x2 = x.permute(0, 2, 1, 3, 4).reshape(B * T, C, H, W)
        conv = self.resample[1]
        if self.mode.startswith("upsample"):
            x2 = cops.nearest_exact_upsample2d(x2.float()).to(x.dtype)
            x2 = cops.conv2d(x2, **cops.conv_weights(conv), padding="same")
        else:
            # nn.ZeroPad2d((0, 1, 0, 1)), then the stride-2 'valid' conv
            x2 = cops.conv2d(x2, **cops.conv_weights(conv), stride=2,
                             padding=((0, 1), (0, 1)))
        return x2.reshape(B, T, *x2.shape[1:]).permute(0, 2, 1, 3, 4)

    def forward(self, x):
        if self.mode == "upsample3d":
            # frame 0 bypasses the temporal conv and is zeroed out of later
            # frames' receptive field; channel halves interleave into
            # frame pairs
            B, C, T, H, W = x.shape
            xz = x.clone()
            xz[:, :, 0] = 0.0
            o = cops.causal_conv3d(xz, **cops.conv_weights(self.time_conv),
                                   padding=(1, 0, 0))
            del xz
            o = o[:, :, 1:].reshape(B, 2, C, T - 1, H, W)
            o = o.permute(0, 2, 3, 1, 4, 5).reshape(B, C, 2 * (T - 1), H, W)
            x = torch.cat([x[:, :, :1], o], dim=2)
            del o
        x = self._spatial(x)
        if self.mode == "downsample3d" and x.shape[2] >= 3:
            # shorter clips have no full window: frame 0 alone passes
            y = cops.conv3d(x, **cops.conv_weights(self.time_conv),
                            stride=(2, 1, 1))
            x = torch.cat([x[:, :, :1], y], dim=2)
        elif self.mode == "downsample3d":
            x = x[:, :, :1]
        return x


def avg_down3d(x, out_c: int, ft: int, fs: int):
    """AvgDown3D (reference :37-87), channels-first."""
    B, C, T, H, W = x.shape
    pad_t = (-T) % ft
    if pad_t:
        x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
    T2 = (T + pad_t) // ft
    group = C * ft * fs * fs // out_c
    x = x.reshape(B, C, T2, ft, H // fs, fs, W // fs, fs)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)            # B,C,ft,fs,fs,T2,Hs,Ws
    return x.reshape(B, out_c, group, T2, H // fs, W // fs).mean(dim=2)


def dup_up3d(x, out_c: int, ft: int, fs: int, first_chunk: bool):
    """DupUp3D (reference :90-131), channels-first."""
    B, C, T, H, W = x.shape
    repeats = out_c * ft * fs * fs // C
    x = x.repeat_interleave(repeats, dim=1)
    x = x.reshape(B, out_c, ft, fs, fs, T, H, W)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)            # B,C,T,ft,H,fs,W,fs
    x = x.reshape(B, out_c, T * ft, H * fs, W * fs)
    return x[:, :, ft - 1:] if first_chunk else x


def patchify(x, p: int):
    """Wan2.2 space-to-channel, channels-first; channel layout
    (C, p_w, p_h) slow -> fast, as in the reference."""
    if p == 1:
        return x
    B, C, T, H, W = x.shape
    x = x.reshape(B, C, T, H // p, p, W // p, p)
    x = x.permute(0, 1, 6, 4, 2, 3, 5)               # B,C,pw,ph,T,Hp,Wp
    return x.reshape(B, C * p * p, T, H // p, W // p)


def unpatchify(x, p: int):
    if p == 1:
        return x
    B, CP, T, Hp, Wp = x.shape
    C = CP // (p * p)
    x = x.reshape(B, C, p, p, T, Hp, Wp)             # B,C,pw,ph,T,Hp,Wp
    x = x.permute(0, 1, 4, 5, 3, 6, 2)               # B,C,T,Hp,ph,Wp,pw
    return x.reshape(B, C, T, Hp * p, Wp * p)


class ResidualDownBlock(nn.Module):
    def __init__(self, din, dout, num_res_blocks, temporal, down_flag, **kw):
        super().__init__()
        self.out_dim = dout
        self.factor_t = 2 if temporal else 1
        self.factor_s = 2 if down_flag else 1
        self.resnets = nn.ModuleList(
            [ResidualBlock(din if j == 0 else dout, dout, **kw)
             for j in range(num_res_blocks)])
        self.downsampler = (Resample(dout, "downsample3d" if temporal
                                     else "downsample2d", **kw)
                            if down_flag else None)

    def forward(self, x):
        shortcut = avg_down3d(x, self.out_dim, self.factor_t, self.factor_s)
        for r in self.resnets:
            x = r(x)
        if self.downsampler is not None:
            x = self.downsampler(x)
        return x.add_(shortcut)


class UpBlock(nn.Module):
    """WanResidualUpBlock (``upsampler``, DupUp3D shortcut) or the plain
    WanUpBlock (``upsamplers.0``)."""

    def __init__(self, din, dout, num_res_blocks, temporal, up_flag,
                 residual: bool, **kw):
        super().__init__()
        self.out_dim = dout
        self.factor_t = 2 if temporal else 1
        self.dup_shortcut = residual and up_flag
        self.resnets = nn.ModuleList(
            [ResidualBlock(din if j == 0 else dout, dout, **kw)
             for j in range(num_res_blocks + 1)])
        mode = "upsample3d" if temporal else "upsample2d"
        up = None
        if up_flag:
            up = Resample(dout, mode, upsample_out_dim=dout if residual
                          else None, **kw)
        if residual:
            self.upsampler = up
        else:
            self.upsamplers = nn.ModuleList([up] if up is not None else [])

    def forward(self, x):
        x_copy = x
        for r in self.resnets:
            x = r(x)
        up = getattr(self, "upsampler", None)
        if up is None and getattr(self, "upsamplers", None):
            up = self.upsamplers[0]
        if up is not None:
            x = up(x)
        if self.dup_shortcut:
            x = x.add_(dup_up3d(x_copy, self.out_dim, self.factor_t, 2,
                                first_chunk=True))
        return x


class MidBlock(nn.Module):
    def __init__(self, dim, **kw):
        super().__init__()
        self.resnets = nn.ModuleList([ResidualBlock(dim, dim, **kw),
                                      ResidualBlock(dim, dim, **kw)])
        self.attentions = nn.ModuleList([AttentionBlock(dim, **kw)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, **kw):
        super().__init__()
        dims = [cfg.base_dim * u for u in (1,) + tuple(cfg.dim_mult)]
        self.conv_in = CausalConv3d(cfg.in_channels, dims[0], 3, padding=1,
                                    **kw)
        blocks = []
        scale = 1.0
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            last = i == len(cfg.dim_mult) - 1
            temporal = cfg.temperal_downsample[i] if not last else False
            if cfg.is_residual:
                blocks.append(ResidualDownBlock(din, dout, cfg.num_res_blocks,
                                                temporal, not last, **kw))
                continue
            cin = din
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResidualBlock(cin, dout, **kw))
                if scale in cfg.attn_scales:
                    blocks.append(AttentionBlock(dout, **kw))
                cin = dout
            if not last:
                blocks.append(Resample(dout, "downsample3d" if temporal
                                       else "downsample2d", **kw))
                scale /= 2.0
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(dims[-1], **kw)
        self.norm_out = RMSNormC(dims[-1], **kw)
        self.conv_out = CausalConv3d(dims[-1], 2 * cfg.z_dim, 3, padding=1,
                                     **kw)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(cops.silu_(self.norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, **kw):
        super().__init__()
        d = cfg.dec_base_dim
        dims = [d * u for u in (cfg.dim_mult[-1],)
                + tuple(reversed(cfg.dim_mult))]
        self.conv_in = CausalConv3d(cfg.z_dim, dims[0], 3, padding=1, **kw)
        self.mid_block = MidBlock(dims[0], **kw)
        blocks = []
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            if i > 0 and not cfg.is_residual:
                din = din // 2                 # the upsampler halved it
            up_flag = i != len(cfg.dim_mult) - 1
            temporal = cfg.temperal_upsample[i] if up_flag else False
            blocks.append(UpBlock(din, dout, cfg.num_res_blocks, temporal,
                                  up_flag, cfg.is_residual, **kw))
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = RMSNormC(dims[-1], **kw)
        self.conv_out = CausalConv3d(dims[-1], cfg.out_channels, 3,
                                     padding=1, **kw)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(cops.silu_(self.norm_out(x)))


class WanVAE(nn.Module):
    """AutoencoderKLWan, full-sequence encode/decode."""

    def __init__(self, cfg: WanVAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.encoder = Encoder(cfg, **kw)
        self.decoder = Decoder(cfg, **kw)
        self.quant_conv = CausalConv3d(2 * cfg.z_dim, 2 * cfg.z_dim, 1, **kw)
        self.post_quant_conv = CausalConv3d(cfg.z_dim, cfg.z_dim, 1, **kw)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Seeded init mirroring ``init_wan_vae``: uniform(+-1/sqrt(fan_in))
        conv weights and biases, unit gammas, zero attention biases."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv3d)):
                bound = mod.weight[0].numel() ** -0.5
                for p in (mod.weight, mod.bias):
                    r = torch.rand(p.shape, generator=generator,
                                   device=generator.device,
                                   dtype=torch.float32)
                    p.copy_(r.mul_(2 * bound).sub_(bound))
            elif isinstance(mod, RMSNormC):
                mod.gamma.fill_(1.0)
        for mod in self.modules():
            if isinstance(mod, AttentionBlock):
                mod.to_qkv.bias.zero_()
                mod.proj.bias.zero_()
        return self

    @torch.no_grad()
    def encode_moments(self, video):
        """video [B, Cin, T, H, W] -> moments [B, 2z, T', H', W']."""
        x = video
        if self.cfg.patch_size is not None:
            x = patchify(x, self.cfg.patch_size)
        return self.quant_conv(self.encoder(x))

    def encode(self, video):
        """Posterior mode (the 'argmax' mode every reference pipeline
        uses)."""
        return self.encode_moments(video)[:, :self.cfg.z_dim]

    @torch.no_grad()
    def decode(self, z, clamp: bool = True):
        """z [B, z, T', H', W'] -> video [B, Cout, T, H, W]."""
        x = self.decoder(self.post_quant_conv(z))
        if self.cfg.patch_size is not None:
            x = unpatchify(x, self.cfg.patch_size)
        return x.clamp_(-1.0, 1.0) if clamp else x


def init_wan_vae(cfg: WanVAEConfig, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> WanVAE:
    """Seeded random WanVAE on ``generator``'s device."""
    model = WanVAE(cfg, device="meta", dtype=dtype)
    model.to_empty(device=generator.device)
    return model.init_random_(generator).eval()


def _warn_placeholder_stats(cfg: WanVAEConfig):
    """WAN22_VAE_CONFIG ships unit placeholder latent stats (the real ones
    come with the checkpoint); say so instead of denormalizing silently."""
    if (cfg.z_dim == 48 and tuple(cfg.latents_mean) == (0.0,) * 48
            and tuple(cfg.latents_std) == (1.0,) * 48):
        warnings.warn(
            "Wan2.2 VAE latents_mean/std are unit PLACEHOLDERS — latents "
            "are not checkpoint-normalized.", stacklevel=3)


def _stats(cfg: WanVAEConfig, z):
    mean = torch.tensor(cfg.latents_mean, dtype=z.dtype, device=z.device)
    std = torch.tensor(cfg.latents_std, dtype=z.dtype, device=z.device)
    return mean.reshape(1, -1, 1, 1, 1), std.reshape(1, -1, 1, 1, 1)


def normalize_latents(cfg: WanVAEConfig, z):
    """(z - mean) / std with per-channel stats."""
    _warn_placeholder_stats(cfg)
    mean, std = _stats(cfg, z)
    return (z - mean) / std


def denormalize_latents(cfg: WanVAEConfig, z):
    _warn_placeholder_stats(cfg)
    mean, std = _stats(cfg, z)
    return z * std + mean
