"""Swin Transformer backbone, OneFormer's Swin-L feature extractor
(counterpart of ``frameino_tpu/models/swin.py``; the reference's detectron2
variant, ``preprocess/oneformer_code/oneformer/modeling/backbone/swin.py``).

The forward computes from a flat state dict under the released names
(``patch_embed.proj.*``, ``layers.N.blocks.M.*``, ``layers.N.downsample.*``,
``norm{i}.*``, behind the ``backbone.`` prefix in OneFormer checkpoints),
NHWC as the JAX module:

- per-block padding of H, W to window multiples, the cyclic shift of odd
  blocks with the 9-region -100 attention mask;
- PatchMerging: norm BEFORE the bias-free 4C -> 2C reduction, odd sizes
  padded;
- stage outputs normed by ``norm{i}``, returned as {res2..res5}.

The shifted-window attention is plain torch (matmuls and a softmax): the
JAX module computes it in XLA with no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from frameino_tpu_torch.models.param_table import ParamTable


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    layer_norm_eps: float = 1e-5


# OneFormer COCO Swin-L (configs/coco/oneformer_swin_large_*.yaml)
SWIN_L = SwinConfig()


def tiny_swin_config() -> SwinConfig:
    return SwinConfig(embed_dim=16, depths=(2, 2), num_heads=(2, 4),
                      window_size=4)


def swin_param_table(cfg: SwinConfig = SWIN_L, prefix: str = "",
                     path: Tuple = ()) -> ParamTable:
    """The released names (after ``prefix``) with their shapes and JAX tree
    paths (under ``path``)."""
    t = ParamTable()
    ps, e = cfg.patch_size, cfg.embed_dim
    t.add(f"{prefix}patch_embed.proj.weight", (e, cfg.in_chans, ps, ps),
          "normal", (*path, "patch_embed", "w"), "conv")
    t.add(f"{prefix}patch_embed.proj.bias", (e,), "zeros",
          (*path, "patch_embed", "b"))
    t.norm(f"{prefix}patch_embed.norm", e, (*path, "patch_embed", "norm"))
    for i, depth in enumerate(cfg.depths):
        c = e * 2 ** i
        hidden = int(c * cfg.mlp_ratio)
        for b in range(depth):
            n = f"{prefix}layers.{i}.blocks.{b}"
            p = (*path, f"layer{i}", f"block{b}")
            t.norm(f"{n}.norm1", c, (*p, "norm1"))
            t.linear(f"{n}.attn.qkv", c, 3 * c, (*p, "attn", "qkv"),
                     bias=cfg.qkv_bias)
            t.linear(f"{n}.attn.proj", c, c, (*p, "attn", "proj"))
            t.add(f"{n}.attn.relative_position_bias_table",
                  ((2 * cfg.window_size - 1) ** 2, cfg.num_heads[i]),
                  "normal", (*p, "attn", "rel_bias_table"), scale=0.02)
            t.norm(f"{n}.norm2", c, (*p, "norm2"))
            t.linear(f"{n}.mlp.fc1", c, hidden, (*p, "mlp_fc1"))
            t.linear(f"{n}.mlp.fc2", hidden, c, (*p, "mlp_fc2"))
        if i < len(cfg.depths) - 1:
            n = f"{prefix}layers.{i}.downsample"
            p = (*path, f"layer{i}", "downsample")
            t.norm(f"{n}.norm", 4 * c, (*p, "norm"))
            t.add(f"{n}.reduction.weight", (2 * c, 4 * c), "normal",
                  (*p, "reduction_w"), "linear")
        if i in cfg.out_indices:
            t.norm(f"{prefix}norm{i}", c, (*path, f"out_norm{i}"))
    return t


def _ln(sd, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"],
                        sd[f"{name}.bias"], eps)


def _linear(sd, name, x):
    return F.linear(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"))


@functools.lru_cache(maxsize=None)
def _rel_position_index(window: int) -> np.ndarray:
    """[W*W, W*W] index into the (2W-1)^2 bias table (``swin.py:112-124``)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    cf = coords.reshape(2, -1)
    rel = cf[:, :, None] - cf[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def _shift_attn_mask(Hp: int, Wp: int, window: int,
                     shift: int) -> np.ndarray:
    """The 9-region SW-MSA mask, additive 0/-100 (``swin.py:414-438``)."""
    img = np.zeros((Hp, Wp))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift),
               slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(Hp // window, window, Wp // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_attention(sd, name, x, cfg: SwinConfig, num_heads: int,
                      attn_mask=None):
    """x: [nW*B, WW, C] (``swin.py:132-173``)."""
    nwb, ww, c = x.shape
    d = c // num_heads
    qkv = _linear(sd, f"{name}.qkv", x).reshape(nwb, ww, 3, num_heads, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    attn = (q * (d ** -0.5)) @ k.transpose(-1, -2)          # [nwb,h,ww,ww]
    idx = torch.from_numpy(_rel_position_index(cfg.window_size)).to(
        x.device)
    bias = sd[f"{name}.relative_position_bias_table"][idx.reshape(-1)]
    attn = attn + bias.reshape(ww, ww, num_heads).permute(2, 0, 1)[None]
    if attn_mask is not None:                               # [nW, ww, ww]
        nw = attn_mask.shape[0]
        attn = attn.reshape(nwb // nw, nw, num_heads, ww, ww)
        attn = attn + attn_mask[None, :, None]
        attn = attn.reshape(nwb, num_heads, ww, ww)
    attn = torch.softmax(attn, dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(nwb, ww, c)
    return _linear(sd, f"{name}.proj", out)


def _swin_block(sd, name, x, H: int, W: int, cfg: SwinConfig,
                num_heads: int, shift: int):
    """x: [B, H*W, C] (``swin.py:236-296``)."""
    B, L, C = x.shape
    win = cfg.window_size
    eps = cfg.layer_norm_eps
    shortcut = x
    x = _ln(sd, f"{name}.norm1", x, eps).reshape(B, H, W, C)
    pad_b = (win - H % win) % win
    pad_r = (win - W % win) % win
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    Hp, Wp = H + pad_b, W + pad_r
    mask = None
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = torch.from_numpy(_shift_attn_mask(Hp, Wp, win, shift)).to(
            x.device, x.dtype)
    xw = x.reshape(B, Hp // win, win, Wp // win, win, C)
    xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, C)
    xw = _window_attention(sd, f"{name}.attn", xw, cfg, num_heads, mask)
    x = xw.reshape(B, Hp // win, Wp // win, win, win, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = x[:, :H, :W].reshape(B, L, C)
    x = shortcut + x
    h = _ln(sd, f"{name}.norm2", x, eps)
    h = _linear(sd, f"{name}.mlp.fc2",
                F.gelu(_linear(sd, f"{name}.mlp.fc1", h)))
    return x + h


def _patch_merging(sd, name, x, H: int, W: int, eps: float):
    """[B, H*W, C] -> [B, ceil(H/2)*ceil(W/2), 2C] (``swin.py:313-338``)."""
    B, L, C = x.shape
    x = x.reshape(B, H, W, C)
    x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], -1).reshape(B, -1, 4 * C)
    x = _ln(sd, f"{name}.norm", x, eps)
    return F.linear(x, sd[f"{name}.reduction.weight"])       # bias-free


def swin_forward(cfg: SwinConfig, sd, image,
                 prefix: str = "") -> Dict[str, torch.Tensor]:
    """image: [B, H, W, 3] (normalized). Returns {"res2": [B, h, w, C],
    ... "res5"}: the NHWC feature pyramid (strides 4/8/16/32)."""
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    B, H, W, _ = image.shape
    ps = cfg.patch_size
    eps = cfg.layer_norm_eps
    x = F.pad(image, (0, 0, 0, (ps - W % ps) % ps, 0, (ps - H % ps) % ps))
    x = F.conv2d(x.permute(0, 3, 1, 2), sd["patch_embed.proj.weight"],
                 sd["patch_embed.proj.bias"], stride=ps)
    Wh, Ww = x.shape[2], x.shape[3]
    x = x.flatten(2).transpose(1, 2)
    x = _ln(sd, "patch_embed.norm", x, eps)
    outs = {}
    Hc, Wc = Wh, Ww
    for i, depth in enumerate(cfg.depths):
        for b in range(depth):
            # shift_size = window // 2 on odd blocks unconditionally
            # (window > resolution is handled by the padding)
            shift = 0 if b % 2 == 0 else cfg.window_size // 2
            x = _swin_block(sd, f"layers.{i}.blocks.{b}", x, Hc, Wc, cfg,
                            cfg.num_heads[i], shift)
        if i in cfg.out_indices:
            o = _ln(sd, f"norm{i}", x, eps)
            outs[f"res{i + 2}"] = o.reshape(B, Hc, Wc,
                                            cfg.embed_dim * 2 ** i)
        if i < len(cfg.depths) - 1:
            x = _patch_merging(sd, f"layers.{i}.downsample", x, Hc, Wc, eps)
            Hc, Wc = (Hc + 1) // 2, (Wc + 1) // 2
    return outs
