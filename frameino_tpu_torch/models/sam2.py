"""SAM2.1 (Segment Anything 2), the image-level graph (counterpart of
``frameino_tpu/models/sam2.py``).

The INO_VSeg_MAE metric video-propagates an object mask with
``facebook/sam2.1-hiera-large`` (``evaluation/evaluate_INO_VSeg_MAE.py:
33-48,160-196``). Module and parameter names are the released
checkpoint's (``sam2.1_hiera_large.pt['model']``), so it loads with
``load_state_dict`` (its unused ``mask_downsample`` conv aside). The memory
machinery and the video predictor are ``sam2_video.py``.

The graph is the JAX module's:

- **Hiera trunk**: 7x7 / stride-4 conv patch embed, windowed MHSA with the
  background + window positional embedding, 4 stages (dim and heads double
  at each transition through the qkv projection, 2x2 max-pool Q pooling at
  the 3 transition blocks), global-attention blocks, GELU MLP; a block's
  window lags its stage by one block, as the released checkpoints build it.
- **FPN neck**: 1x1 convs to 256, a nearest top-down merge on the
  configured levels, DETR sine position encodings; the stride-32 level is
  dropped, leaving stride-4/8/16 features.
- **Prompt encoder**: random-Gaussian point position encoding, per-label
  embeddings, the no-mask dense embedding.
- **Mask decoder**: the two-way transformer, object-score / IoU / mask
  tokens, transposed-conv upscaling fused with the stride-4/8 skip
  features, per-token hypernetwork MLPs, dynamic multimask by stability.

Tokens are channels-last [B, H, W, C] as in JAX; convolutions permute to
torch's channels-first. Attention is ``F.scaled_dot_product_attention``
(XLA einsums in JAX, ``sam2.py:170``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Sam2Config:
    image_size: int = 1024
    # Hiera trunk (sam2.1_hiera_l)
    embed_dim: int = 144
    num_heads: int = 2
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    global_att_blocks: Tuple[int, ...] = (23, 33, 43)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (7, 7)
    window_spec: Tuple[int, ...] = (8, 4, 16, 8)
    q_pool: int = 3
    mlp_ratio: float = 4.0
    # FPN neck
    d_model: int = 256
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    scalp: int = 1
    # SAM heads
    dec_heads: int = 8
    dec_mlp_dim: int = 2048
    num_multimask: int = 3
    # memory machinery (sam2_video.py)
    mem_dim: int = 64
    num_maskmem: int = 7
    mem_attn_layers: int = 4
    mem_ffn_dim: int = 2048
    rope_theta: float = 10000.0
    max_obj_ptrs_in_encoder: int = 16
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    stability_delta: float = 0.05
    stability_thresh: float = 0.98
    ln_eps: float = 1e-6

    @property
    def depth(self) -> int:
        return sum(self.stages)

    @property
    def stage_ends(self) -> Tuple[int, ...]:
        ends, tot = [], 0
        for s in self.stages:
            tot += s
            ends.append(tot - 1)
        return tuple(ends)

    @property
    def q_pool_blocks(self) -> Tuple[int, ...]:
        return tuple(e + 1 for e in self.stage_ends[:self.q_pool])

    def block_spec(self) -> List[Dict]:
        """Per-block (dim, dim_out, heads, window, q_pool): sam2's Hiera
        construction loop (the window lags the stage by one block)."""
        specs = []
        dim, heads, cur_stage = self.embed_dim, self.num_heads, 1
        for i in range(self.depth):
            dim_out = dim
            window = self.window_spec[cur_stage - 1]
            if i in self.global_att_blocks:
                window = 0
            if i - 1 in self.stage_ends:
                dim_out = dim * 2
                heads = heads * 2
                cur_stage += 1
            specs.append(dict(dim=dim, dim_out=dim_out, heads=heads,
                              window=window,
                              q_pool=i in self.q_pool_blocks))
            dim = dim_out
        return specs

    @property
    def backbone_dims(self) -> Tuple[int, ...]:
        d = self.embed_dim
        return tuple(d * (2 ** i) for i in range(len(self.stages)))


SAM21_HIERA_LARGE = Sam2Config()


def tiny_sam2_config() -> Sam2Config:
    return Sam2Config(image_size=64, embed_dim=8, num_heads=1,
                      stages=(1, 1, 2, 1), global_att_blocks=(2,),
                      window_spec=(4, 2, 4, 4), d_model=16, dec_heads=2,
                      dec_mlp_dim=32, mem_dim=8, mem_attn_layers=2,
                      mem_ffn_dim=32, num_maskmem=3,
                      max_obj_ptrs_in_encoder=4)


# ---------------------------------------------------------------------------
# Primitives (channels-last tokens)
# ---------------------------------------------------------------------------

def conv_nhwc(conv: nn.Conv2d, x, stride: int = 1, padding=0):
    """A torch conv on [B, H, W, C] tokens."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias,
                 stride=stride, padding=padding, groups=conv.groups)
    return y.permute(0, 2, 3, 1)


def ln2d(x, norm: "LayerNorm2d"):
    """sam2's LayerNorm2d on channels-last tokens (eps 1e-6)."""
    return F.layer_norm(x, x.shape[-1:], norm.weight, norm.bias, 1e-6)


def sine_pos_embed(h: int, w: int, num_pos_feats: int,
                   temperature: float = 10000.0) -> np.ndarray:
    """DETR-style sine PE (sam2 PositionEmbeddingSine, normalize=True):
    [H, W, C], y features then x."""
    half = num_pos_feats // 2
    eps, scale = 1e-6, 2 * math.pi
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w),
                                                                 np.float32)
    x = np.ones((h, 1), np.float32) * np.arange(1, w + 1,
                                                dtype=np.float32)[None, :]
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = np.arange(half, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / half)
    px = x[..., None] / dim_t
    py = y[..., None] / dim_t
    px = np.stack([np.sin(px[..., 0::2]), np.cos(px[..., 1::2])],
                  axis=-1).reshape(h, w, -1)
    py = np.stack([np.sin(py[..., 0::2]), np.cos(py[..., 1::2])],
                  axis=-1).reshape(h, w, -1)
    return np.concatenate([py, px], axis=-1)


class LayerNorm2d(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, **kw))
        self.bias = nn.Parameter(torch.empty(c, **kw))


class MLP(nn.Module):
    """``layers.{i}`` Linear stack, an activation between them."""

    def __init__(self, din: int, dh: int, dout: int, n: int, act=F.relu,
                 **kw):
        super().__init__()
        dims = [din] + [dh] * (n - 1) + [dout]
        self.layers = nn.ModuleList(nn.Linear(dims[i], dims[i + 1], **kw)
                                    for i in range(n))
        self.act = act

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return x


class Attention(nn.Module):
    """SAM's Attention: separate q/k/v/out projections, an internal width
    (``internal``) below the token width."""

    def __init__(self, dim: int, internal: int, heads: int,
                 kv_dim: Optional[int] = None, **kw):
        super().__init__()
        kv_dim = kv_dim or dim
        self.heads = heads
        self.q_proj = nn.Linear(dim, internal, **kw)
        self.k_proj = nn.Linear(kv_dim, internal, **kw)
        self.v_proj = nn.Linear(kv_dim, internal, **kw)
        self.out_proj = nn.Linear(internal, dim, **kw)

    def heads_of(self, proj: nn.Linear, x):
        B, L = x.shape[:2]
        return proj(x).reshape(B, L, self.heads, -1).transpose(1, 2)

    def forward(self, q, k, v):
        o = F.scaled_dot_product_attention(self.heads_of(self.q_proj, q),
                                           self.heads_of(self.k_proj, k),
                                           self.heads_of(self.v_proj, v))
        return self.out_proj(o.transpose(1, 2).reshape(q.shape[0],
                                                       q.shape[1], -1))


# ---------------------------------------------------------------------------
# Hiera trunk and FPN neck
# ---------------------------------------------------------------------------

def _window_partition(x, win: int):
    """[B, H, W, C] -> [B * nH * nW, win, win, C] (SAM2's 1024 grid divides
    at every stage)."""
    B, H, W, C = x.shape
    assert H % win == 0 and W % win == 0, (H, W, win)
    x = x.reshape(B, H // win, win, W // win, win, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, C)


def _window_unpartition(x, win: int, hw: Tuple[int, int]):
    H, W = hw
    C = x.shape[-1]
    B = x.shape[0] // ((H // win) * (W // win))
    x = x.reshape(B, H // win, W // win, win, win, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def _max_pool2x2(x):
    """nn.MaxPool2d(2, 2) on [B, H, W, C]."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class _HieraAttn(nn.Module):
    def __init__(self, dim: int, dim_out: int, **kw):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim_out, **kw)
        self.proj = nn.Linear(dim_out, dim_out, **kw)


class HieraBlock(nn.Module):
    """One MultiScaleBlock."""

    def __init__(self, spec: Dict, mlp_ratio: float, **kw):
        super().__init__()
        d, do = spec["dim"], spec["dim_out"]
        self.spec = spec
        self.norm1 = nn.LayerNorm(d, eps=1e-6, **kw)
        self.attn = _HieraAttn(d, do, **kw)
        self.norm2 = nn.LayerNorm(do, eps=1e-6, **kw)
        self.mlp = MLP(do, int(do * mlp_ratio), do, 2, act=F.gelu, **kw)
        if d != do:
            self.proj = nn.Linear(d, do, **kw)

    def forward(self, x):
        spec = self.spec
        heads, win = spec["heads"], spec["window"]
        H, W = x.shape[1:3]
        shortcut = x
        x = self.norm1(x)
        if spec["dim"] != spec["dim_out"]:
            shortcut = _max_pool2x2(self.proj(x))
        if win > 0:
            x = _window_partition(x, win)
        b, h, w = x.shape[:3]
        qkv = self.attn.qkv(x).reshape(b, h * w, 3, heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        if spec["q_pool"]:
            qs = _max_pool2x2(q.transpose(1, 2).reshape(b, h, w, -1))
            h, w = qs.shape[1:3]
            q = qs.reshape(b, h * w, heads, -1).transpose(1, 2)
        o = F.scaled_dot_product_attention(q, k, v)
        o = self.attn.proj(o.transpose(1, 2).reshape(b, h, w, -1))
        if spec["q_pool"]:
            win = win // 2
            H, W = shortcut.shape[1:3]
        if spec["window"] > 0:
            o = _window_unpartition(o, win, (H, W))
        x = shortcut + o
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: Sam2Config, **kw):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, 7, stride=4, padding=3,
                              **kw)


class Hiera(nn.Module):
    def __init__(self, cfg: Sam2Config, **kw):
        super().__init__()
        self.cfg = cfg
        E = cfg.embed_dim
        self.patch_embed = _PatchEmbed(cfg, **kw)
        self.pos_embed = nn.Parameter(torch.empty(
            1, E, *cfg.window_pos_embed_bkg_spatial_size, **kw))
        self.pos_embed_window = nn.Parameter(torch.empty(
            1, E, cfg.window_spec[0], cfg.window_spec[0], **kw))
        self.blocks = nn.ModuleList(HieraBlock(s, cfg.mlp_ratio, **kw)
                                    for s in cfg.block_spec())

    def pos_embed_for(self, hw: Tuple[int, int]):
        """The background PE bicubic-resized to the token grid plus the
        window PE tiled across it (sam2 Hiera._get_pos_embed): [1, h, w, C]."""
        h, w = hw
        bkg = F.interpolate(self.pos_embed, size=(h, w), mode="bicubic",
                            align_corners=False)
        wh, ww = self.pos_embed_window.shape[-2:]
        tiled = self.pos_embed_window.tile(1, 1, h // wh, w // ww)
        return (bkg + tiled).permute(0, 2, 3, 1)

    def forward(self, x, pos_embed=None) -> List[torch.Tensor]:
        """x [B, 3, H, W] (normalized) -> the stage-end features, low to
        high stride, each [B, h, w, C]."""
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        if pos_embed is None:
            pos_embed = self.pos_embed_for(x.shape[1:3])
        x = x + pos_embed
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.cfg.stage_ends:
                outs.append(x)
        return outs


class _NeckConv(nn.Module):
    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, **kw)


class FpnNeck(nn.Module):
    def __init__(self, cfg: Sam2Config, **kw):
        super().__init__()
        self.cfg = cfg
        self.convs = nn.ModuleList(_NeckConv(d, cfg.d_model, **kw)
                                   for d in reversed(cfg.backbone_dims))

    def forward(self, xs: List[torch.Tensor]):
        """Per-level 1x1 conv and a nearest top-down merge on the configured
        levels; returns (features, sine position encodings), scalped."""
        cfg = self.cfg
        n = len(xs) - 1
        out: List[Optional[torch.Tensor]] = [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):
            lateral = conv_nhwc(self.convs[n - i].conv, xs[i])
            if i in cfg.fpn_top_down_levels and prev is not None:
                prev = lateral + prev.repeat_interleave(2, 1
                                                        ).repeat_interleave(
                                                            2, 2)
            else:
                prev = lateral
            out[i] = prev
        pos = [torch.from_numpy(sine_pos_embed(f.shape[1], f.shape[2],
                                               cfg.d_model)
                                ).to(f.device, f.dtype)[None] for f in out]
        if cfg.scalp:
            out, pos = out[:-cfg.scalp], pos[:-cfg.scalp]
        return out, pos


class ImageEncoder(nn.Module):
    def __init__(self, cfg: Sam2Config, **kw):
        super().__init__()
        self.trunk = Hiera(cfg, **kw)
        self.neck = FpnNeck(cfg, **kw)


# ---------------------------------------------------------------------------
# Prompt encoder
# ---------------------------------------------------------------------------

class _PE(nn.Module):
    def __init__(self, cfg: Sam2Config, **kw):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.empty(2, cfg.d_model // 2, **kw))


def pe_with_coords(gauss, coords, size: Tuple[int, int]):
    """PositionEmbeddingRandom.forward_with_coords: coords [..., 2] (x, y)
    in pixels -> [..., 2 * half]."""
    c = coords / torch.tensor([size[1], size[0]], dtype=coords.dtype,
                              device=coords.device)
    c = 2 * math.pi * ((2 * c - 1) @ gauss)
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: Sam2Config, **kw):
        super().__init__()
        C = cfg.d_model
        self.cfg = cfg
        self.pe_layer = _PE(cfg, **kw)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, C, **kw)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, C, **kw)
        self.no_mask_embed = nn.Embedding(1, C, **kw)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, 4, 2, stride=2, **kw), LayerNorm2d(4, **kw),
            nn.GELU(), nn.Conv2d(4, 16, 2, stride=2, **kw),
            LayerNorm2d(16, **kw), nn.GELU(), nn.Conv2d(16, C, 1, **kw))

    def points(self, points, labels):
        """Sparse embeddings of point prompts (``_embed_points``, pad=True):
        points [B, N, 2] pixel (x, y), labels [B, N] in {-1 pad, 0 neg,
        1 pos}; a (0, 0) / -1 pad point is appended."""
        B = points.shape[0]
        s = self.cfg.image_size
        points = torch.cat([points + 0.5,
                            points.new_zeros((B, 1, 2))], dim=1)
        labels = torch.cat([labels, -labels.new_ones((B, 1))], dim=1)
        pe = pe_with_coords(self.pe_layer.positional_encoding_gaussian_matrix,
                            points, (s, s))
        lab = labels[..., None]
        pe = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        for i in range(4):
            pe = pe + torch.where(lab == i, self.point_embeddings[i].weight[0],
                                  torch.zeros_like(pe))
        return pe

    def dense_pe(self, grid: int):
        """PositionEmbeddingRandom on the feature grid: [1, g, g, C]."""
        gauss = self.pe_layer.positional_encoding_gaussian_matrix
        t = (torch.arange(grid, dtype=torch.float32, device=gauss.device)
             + 0.5) / grid
        c = torch.stack(torch.meshgrid(t, t, indexing="xy"), dim=-1)
        c = 2 * math.pi * ((2 * c - 1) @ gauss)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)[None]


# ---------------------------------------------------------------------------
# Two-way transformer and mask decoder
# ---------------------------------------------------------------------------

class TwoWayBlock(nn.Module):
    def __init__(self, cfg: Sam2Config, **kw):
        super().__init__()
        C, h = cfg.d_model, cfg.dec_heads
        self.self_attn = Attention(C, C, h, **kw)
        self.cross_attn_token_to_image = Attention(C, C // 2, h, **kw)
        self.cross_attn_image_to_token = Attention(C, C // 2, h, **kw)
        self.mlp = MLP(C, cfg.dec_mlp_dim, C, 2, **kw)
        for i in range(1, 5):
            setattr(self, f"norm{i}", nn.LayerNorm(C, eps=1e-5, **kw))


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: Sam2Config, **kw):
        super().__init__()
        C = cfg.d_model
        self.layers = nn.ModuleList(TwoWayBlock(cfg, **kw) for _ in range(2))
        self.final_attn_token_to_image = Attention(C, C // 2, cfg.dec_heads,
                                                   **kw)
        self.norm_final_attn = nn.LayerNorm(C, eps=1e-5, **kw)

    def forward(self, image_embedding, image_pe, tokens):
        """image_embedding / image_pe [B, h, w, C]; tokens [B, N, C] ->
        (queries [B, N, C], keys [B, hw, C])."""
        B, h, w, C = image_embedding.shape
        keys = image_embedding.reshape(B, h * w, C)
        key_pe = image_pe.reshape(1, h * w, C).expand_as(keys)
        queries = tokens
        for li, lp in enumerate(self.layers):
            if li == 0:
                # skip_first_layer_pe: the first self-attention REPLACES
                # the queries (no residual)
                queries = lp.self_attn(queries, queries, queries)
            else:
                q = queries + tokens
                queries = queries + lp.self_attn(q, q, queries)
            queries = lp.norm1(queries)
            q = queries + tokens
            k = keys + key_pe
            queries = lp.norm2(queries + lp.cross_attn_token_to_image(
                q, k, keys))
            queries = lp.norm3(queries + lp.mlp(queries))
            q = queries + tokens
            k = keys + key_pe
            keys = lp.norm4(keys + lp.cross_attn_image_to_token(k, q,
                                                                queries))
        q = queries + tokens
        k = keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


def _mask_stability(masks, delta: float):
    """IoU of the +delta / -delta logit thresholdings, per mask."""
    hi = (masks > delta).sum((-1, -2)).float()
    lo = (masks > -delta).sum((-1, -2)).float()
    return torch.where(lo > 0, hi / lo.clamp_min(1e-6),
                       torch.ones_like(lo))


class MaskDecoder(nn.Module):
    def __init__(self, cfg: Sam2Config, **kw):
        super().__init__()
        C = cfg.d_model
        n_mask = 1 + cfg.num_multimask
        self.cfg = cfg
        self.transformer = TwoWayTransformer(cfg, **kw)
        self.iou_token = nn.Embedding(1, C, **kw)
        self.mask_tokens = nn.Embedding(n_mask, C, **kw)
        self.obj_score_token = nn.Embedding(1, C, **kw)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(C, C // 4, 2, stride=2, **kw),
            LayerNorm2d(C // 4, **kw), nn.GELU(),
            nn.ConvTranspose2d(C // 4, C // 8, 2, stride=2, **kw), nn.GELU())
        self.conv_s0 = nn.Conv2d(C, C // 8, 1, **kw)
        self.conv_s1 = nn.Conv2d(C, C // 4, 1, **kw)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(C, C, C // 8, 3, **kw) for _ in range(n_mask))
        self.iou_prediction_head = MLP(C, C, n_mask, 3, **kw)
        self.pred_obj_score_head = MLP(C, C, 1, 3, **kw)

    def _up(self, conv: nn.ConvTranspose2d, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias,
                               stride=2)
        return y.permute(0, 2, 3, 1)

    def forward(self, src, image_pe, sparse_prompt,
                high_res_feats: Sequence[torch.Tensor],
                multimask_output: bool, dynamic_multimask: bool = True):
        """src [B, h, w, C] = image features + dense prompt; returns
        (low_res_masks [B, K, 4h, 4w], iou [B, K], sam_tokens [B, K, C],
        object_score_logits [B, 1]): the K = 3 multimask candidates, or
        K = 1 (token 0, with the dynamic stability fallback)."""
        cfg = self.cfg
        B = src.shape[0]
        out_tokens = torch.cat([self.obj_score_token.weight,
                                self.iou_token.weight,
                                self.mask_tokens.weight], dim=0)
        n_mask = 1 + cfg.num_multimask
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1),
                            sparse_prompt], dim=1)
        hs, keys = self.transformer(src, image_pe, tokens)
        iou_tok = hs[:, 1]
        mask_toks = hs[:, 2:2 + n_mask]
        h, w, C = src.shape[1:]
        src_out = keys.reshape(B, h, w, C)
        feat_s0, feat_s1 = high_res_feats
        ups = self.output_upscaling
        up = self._up(ups[0], src_out) + feat_s1
        up = F.gelu(ln2d(up, ups[1]))
        up = F.gelu(self._up(ups[3], up) + feat_s0)
        hyper = torch.stack([self.output_hypernetworks_mlps[i](mask_toks[:, i])
                             for i in range(n_mask)], dim=1)  # [B, 4, C/8]
        hb, wb = up.shape[1:3]
        masks = (hyper @ up.reshape(B, hb * wb, -1).transpose(1, 2)
                 ).reshape(B, n_mask, hb, wb)
        iou_pred = torch.sigmoid(self.iou_prediction_head(iou_tok))
        obj_score = self.pred_obj_score_head(hs[:, 0])
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:], mask_toks[:, 1:], obj_score
        m0, i0, tok0 = masks[:, 0:1], iou_pred[:, 0:1], mask_toks[:, 0:1]
        if dynamic_multimask:
            stability = _mask_stability(m0, cfg.stability_delta)[:, 0]
            best = iou_pred[:, 1:].argmax(-1)
            bidx = torch.arange(B, device=src.device)
            mb = masks[:, 1:][bidx, best][:, None]
            ib = iou_pred[:, 1:][bidx, best][:, None]
            use0 = (stability >= cfg.stability_thresh)[:, None]
            m0 = torch.where(use0[..., None, None], m0, mb)
            i0 = torch.where(use0, i0, ib)
        return m0, i0, tok0, obj_score


# ---------------------------------------------------------------------------
# The whole model (the memory modules are sam2_video.py's)
# ---------------------------------------------------------------------------

class Sam2(nn.Module):
    """SAM2.1 with the released checkpoint's names."""

    def __init__(self, cfg: Sam2Config = SAM21_HIERA_LARGE, device=None,
                 dtype=None):
        from frameino_tpu_torch.models.sam2_video import (MemoryAttention,
                                                          MemoryEncoder)
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        C, M = cfg.d_model, cfg.mem_dim
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg, **kw)
        self.sam_prompt_encoder = PromptEncoder(cfg, **kw)
        self.sam_mask_decoder = MaskDecoder(cfg, **kw)
        self.memory_attention = MemoryAttention(cfg, **kw)
        self.memory_encoder = MemoryEncoder(cfg, **kw)
        self.maskmem_tpos_enc = nn.Parameter(torch.empty(
            cfg.num_maskmem, 1, 1, M, **kw))
        self.no_mem_embed = nn.Parameter(torch.empty(1, 1, C, **kw))
        self.no_mem_pos_enc = nn.Parameter(torch.empty(1, 1, C, **kw))
        self.no_obj_ptr = nn.Parameter(torch.empty(1, C, **kw))
        self.no_obj_embed_spatial = nn.Parameter(torch.empty(1, M, **kw))
        self.obj_ptr_proj = MLP(C, C, C, 3, **kw)
        self.obj_ptr_tpos_proj = nn.Linear(C, M, **kw)

    @torch.no_grad()
    def encode_image(self, x, pos_embed=None):
        """x [B, 3, S, S] normalized -> (backbone features [stride 4 with
        conv_s0, stride 8 with conv_s1, stride 16], their sine PEs), each
        [B, h, w, C] (SAM2Base.forward_image)."""
        dec = self.sam_mask_decoder
        feats, pos = self.image_encoder.neck(
            self.image_encoder.trunk(x, pos_embed))
        feats = list(feats)
        feats[0] = conv_nhwc(dec.conv_s0, feats[0])
        feats[1] = conv_nhwc(dec.conv_s1, feats[1])
        return feats, pos


@torch.no_grad()
def init_sam2(cfg: Sam2Config, generator: torch.Generator,
              dtype: torch.dtype = torch.float32) -> Sam2:
    """Seeded random SAM2 on ``generator``'s device at the JAX init's
    scale: every tensor N(0, 0.1), the Gaussian PE matrix N(0, 1), every
    norm's gain 1."""
    m = Sam2(cfg, device="meta", dtype=dtype)
    m.to_empty(device=generator.device)
    for mod in m.modules():
        for name, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            if name == "weight" and isinstance(mod, (nn.LayerNorm,
                                                     LayerNorm2d)):
                t.fill_(1.0)
                continue
            scale = 1.0 if name == "positional_encoding_gaussian_matrix" \
                else 0.1
            t.copy_(scale * torch.randn(t.shape, generator=generator,
                                        device=generator.device))
    return m.eval()
