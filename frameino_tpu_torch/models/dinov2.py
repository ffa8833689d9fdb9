"""DINOv2 ViT-B/14 image embedder (counterpart of
``frameino_tpu/models/dinov2.py``).

The reference scores identity preservation with the torch.hub
``dinov2_vitb14`` (``evaluation/evaluate_INO_DINO.py:74-80``: cosine
similarity of the CLS embedding of each cropped frame to the ID
reference). Module and parameter names are upstream's
(``DinoVisionTransformer``), so the released state dict loads with
``load_state_dict``:

  Conv patchify (14x14, stride 14) -> prepend CLS token -> add the
  bicubic-interpolated positional embeddings -> 12 pre-norm blocks (MHSA +
  LayerScale, GELU MLP + LayerScale, LN eps 1e-6) -> final LN -> CLS token.

The checkpoint is trained at 518x518 (a 37x37 patch grid); another grid
interpolates the patch table with ``F.interpolate(mode="bicubic",
scale_factor=((h0 + 0.1) / 37, (w0 + 0.1) / 37))``, upstream's own call,
which the JAX module reproduces in numpy. Attention is
``F.scaled_dot_product_attention`` (XLA einsums in JAX; no kernel of the
TPU package is on this path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Dinov2Config:
    img_size: int = 518             # pretrain grid: 518/14 = 37
    patch_size: int = 14
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    interpolate_offset: float = 0.1
    ln_eps: float = 1e-6

    @property
    def pretrain_grid(self) -> int:
        return self.img_size // self.patch_size


DINOV2_VITB14 = Dinov2Config()


def tiny_dinov2_config() -> Dinov2Config:
    return Dinov2Config(img_size=28, patch_size=7, dim=32, depth=2,
                        heads=2, mlp_ratio=2)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, **kw):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)

    def forward(self, x):
        B, S, D = x.shape
        q, k, v = self.qkv(x).reshape(B, S, 3, self.heads, D // self.heads
                                      ).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(B, S, D))


class _LayerScale(nn.Module):
    def __init__(self, dim: int, **kw):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim, **kw))

    def forward(self, x):
        return x * self.gamma


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, **kw):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, **kw)
        self.fc2 = nn.Linear(hidden, dim, **kw)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, cfg: Dinov2Config, **kw):
        super().__init__()
        d = cfg.dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps, **kw)
        self.attn = _Attention(d, cfg.heads, **kw)
        self.ls1 = _LayerScale(d, **kw)
        self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps, **kw)
        self.mlp = _Mlp(d, d * cfg.mlp_ratio, **kw)
        self.ls2 = _LayerScale(d, **kw)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: Dinov2Config, **kw):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.dim, cfg.patch_size,
                              stride=cfg.patch_size, **kw)


class Dinov2(nn.Module):
    """DinoVisionTransformer inference with upstream's parameter names."""

    def __init__(self, cfg: Dinov2Config, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        n = cfg.pretrain_grid ** 2
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.dim, **kw))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + n, cfg.dim, **kw))
        self.mask_token = nn.Parameter(torch.empty(1, cfg.dim, **kw))
        self.patch_embed = _PatchEmbed(cfg, **kw)
        self.blocks = nn.ModuleList(_Block(cfg, **kw)
                                    for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.dim, eps=cfg.ln_eps, **kw)

    def interpolate_pos_embed(self, grid_hw: Tuple[int, int]):
        """[1, 1 + h0*w0, D] table for the patch grid (upstream's
        ``interpolate_pos_encoding``)."""
        pe = self.pos_embed
        m = self.cfg.pretrain_grid
        h0, w0 = grid_hw
        if (h0, w0) == (m, m):
            return pe
        patch = pe[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
        off = self.cfg.interpolate_offset
        patch = F.interpolate(patch.float(), mode="bicubic",
                              scale_factor=((h0 + off) / m, (w0 + off) / m),
                              align_corners=False, antialias=False)
        assert patch.shape[-2:] == (h0, w0), patch.shape
        patch = patch.to(pe.dtype).permute(0, 2, 3, 1).reshape(1, h0 * w0,
                                                                 -1)
        return torch.cat([pe[:, :1], patch], dim=1)

    @torch.no_grad()
    def forward(self, x, pos_embed: Optional[torch.Tensor] = None):
        """x [B, 3, H, W] (ImageNet-normalized) -> CLS embedding [B, D];
        ``pos_embed`` as ``interpolate_pos_embed`` gives it (computed when
        None)."""
        p = self.cfg.patch_size
        grid = (x.shape[2] // p, x.shape[3] // p)
        tok = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        tok = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), tok], 1)
        if pos_embed is None:
            pos_embed = self.interpolate_pos_embed(grid)
        tok = tok + pos_embed
        for blk in self.blocks:
            tok = blk(tok)
        return self.norm(tok)[:, 0]


@torch.no_grad()
def init_dinov2(cfg: Dinov2Config, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Dinov2:
    """Seeded random Dinov2 on ``generator``'s device, the JAX init's
    scales: N(0, 0.02) matrices and tokens, unit norms, LayerScale 1e-5."""
    m = Dinov2(cfg, device="meta", dtype=dtype)
    m.to_empty(device=generator.device)
    for name, t in m.named_parameters():
        if name.endswith("gamma"):
            t.fill_(1e-5)
        elif "norm" in name.rsplit(".", 1)[0].rsplit(".", 1)[-1]:
            t.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias") or name == "mask_token":
            t.zero_()
        else:
            t.copy_(0.02 * torch.randn(t.shape, generator=generator,
                                       device=generator.device))
    return m.eval()


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_dinov2_torch(checkpoint_path: str,
                      cfg: Dinov2Config = DINOV2_VITB14,
                      input_size: int = 224, device: str = "cuda"):
    """The released ``dinov2_vitb14`` weights (``.pth`` or
    ``.safetensors``) as the ``embed(image)`` adapter."""
    from frameino_tpu_torch.models.weights import read_checkpoint
    m = Dinov2(cfg, device="meta")
    m.load_state_dict(read_checkpoint(checkpoint_path), strict=True,
                      assign=True)
    return make_embedder_adapter(m.to(device).eval(), input_size)


def make_embedder_adapter(model: Dinov2, input_size: int = 224):
    """``embed(image [H, W, 3] uint8) -> [D] float32``: the reference
    metric's preprocessing (224 resize, ImageNet normalization,
    ``evaluate_INO_DINO.py:63-71``) on the model's device."""
    import cv2
    grid = input_size // model.cfg.patch_size
    pe = model.interpolate_pos_embed((grid, grid)).detach()
    dev = pe.device

    def embed(image: np.ndarray) -> np.ndarray:
        img = cv2.resize(image, (input_size, input_size))
        img = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        x = torch.from_numpy(img).permute(2, 0, 1)[None].to(dev, pe.dtype)
        return model(x, pos_embed=pe)[0].float().cpu().numpy()

    return embed
