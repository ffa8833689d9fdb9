"""Qwen2.5-VL: the vision tower, the M-RoPE text decoder with a static KV
cache, and greedy decoding (counterpart of ``frameino_tpu/models/qwen_vl.py``).

The reference runs Qwen2.5-VL-32B-Instruct as the INO_VLM judge
(``evaluation/evaluate_INO_VLM.py:36-49``) through transformers. Module and
parameter names are transformers' (``model.visual.*``,
``model.language_model.*``, ``lm_head``), so a released checkpoint loads
with ``load_state_dict``; ``qwen_vl_state_dict`` also takes the legacy
``visual.*`` / ``model.layers.*`` names (JAX's ``_canon``).

- **Vision tower**: the 2x14x14 patch projection as a dense, 2-D rotary
  embedding over the window-permuted patch order, windowed attention as an
  equal-capacity padded gather with a -1e30 key bias, the full-attention
  blocks within each temporal slice, RMSNorm and a biased SwiGLU MLP, the
  2x2 merger with exact GELU, and the inverse cell permutation. The layout
  (permutations, gather, rotary table) is computed on the host in numpy
  (``vision_layout``), as in JAX.
- **Text decoder**: GQA with q/k/v biases, M-RoPE (the head-dim channels
  split into t/h/w sections fed by 3-D position ids), RMSNorm, SwiGLU, an
  untied ``lm_head``; a static-capacity KV cache written in place; the
  softmax in fp32 cast back to the input dtype; prefill attention taken 512
  query rows at a time.
- **int8** (``quantize_qwen_int8``): q/k/v/o and gate/up/down of every
  text layer become ``QuantLinear`` (per-output-channel weight scales,
  ``models/quant.quantize_weight``); their products run K7
  (``ops/dyn_quant.py``) on the activation rows, then ``torch._int_mm``,
  then JAX's dequant ``y.float() * (s_x * w_s)``, the bias added after in
  the activation dtype. Embeddings, ``lm_head``, the norms and the vision
  tower stay in high precision.

Attention here is plain tensor code in both packages (JAX: einsums and
``jax.nn.softmax``, no Pallas kernel), so no hand kernel is on this path
except K7.

Dtypes. In fp32 the port computes what JAX computes, cast for cast. JAX
cannot generate in bf16: its M-RoPE tables are fp32, promote k to fp32 and
``dynamic_update_slice`` into the bf16 cache raises (ROADMAP queue 3). In
bf16 the port follows transformers' Qwen2.5-VL instead: the text M-RoPE
tables are cast to the activation dtype; the vision tower runs in the
weights' dtype (the pixels are cast to it; JAX's promotion would run it in
fp32), with its 2-D rotary in fp32 cast back and its softmax in fp32.

Differences from JAX: the generator skips the decode step after the last
token (JAX runs it and drops its logits); tensor parallelism
(``shard_qwen_params``) is not ported.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from frameino_tpu_torch.models.quant import (QuantLinear,
                                             quantize_dit_int8)
from frameino_tpu_torch.ops.linear import dense_int8

TP_NOT_PORTED = ("tensor-parallel Qwen2.5-VL (shard_qwen_params, a mesh) is "
                 "not ported: ROADMAP.md queue 1, item 12")
# query rows of one prefill attention chunk (JAX's bound on the [L, T]
# score tensor)
PREFILL_CHUNK = 512


@dataclasses.dataclass(frozen=True)
class QwenVLVisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    num_heads: int = 16
    intermediate_size: int = 3456
    out_hidden_size: int = 5120        # 32B
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    tokens_per_second: float = 2.0
    rms_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2

    @property
    def merger_window(self) -> int:
        return self.window_size // self.spatial_merge_size \
            // self.patch_size

    @property
    def patch_dim(self) -> int:
        return 3 * self.temporal_patch_size * self.patch_size ** 2


@dataclasses.dataclass(frozen=True)
class QwenVLTextConfig:
    hidden_size: int = 5120            # 32B
    num_layers: int = 64
    num_heads: int = 40
    num_kv_heads: int = 8
    intermediate_size: int = 27648
    vocab_size: int = 152064
    rope_theta: float = 1_000_000.0
    mrope_section: Tuple[int, ...] = (16, 24, 24)
    rms_eps: float = 1e-6
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class QwenVLConfig:
    vision: QwenVLVisionConfig = QwenVLVisionConfig()
    text: QwenVLTextConfig = QwenVLTextConfig()
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    eos_token_id: int = 151645         # <|im_end|>


QWEN25_VL_32B = QwenVLConfig()


def tiny_qwen_vl_config() -> QwenVLConfig:
    return QwenVLConfig(
        vision=QwenVLVisionConfig(
            depth=3, hidden_size=16, num_heads=2, intermediate_size=32,
            out_hidden_size=24, window_size=56,
            fullatt_block_indexes=(1,)),
        text=QwenVLTextConfig(
            hidden_size=24, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=48, vocab_size=64, rope_theta=10000.0,
            mrope_section=(1, 2, 0)),
        image_token_id=60, video_token_id=61, vision_start_token_id=62,
        eos_token_id=63)


def qwen_vl_config_from_json(path: str) -> QwenVLConfig:
    """The config of a checkpoint's ``config.json`` (3B/7B/32B/72B)."""
    with open(path) as f:
        c = json.load(f)
    v = c["vision_config"]
    t = c.get("text_config", c)
    vision = QwenVLVisionConfig(
        depth=v["depth"], hidden_size=v["hidden_size"],
        num_heads=v["num_heads"], intermediate_size=v["intermediate_size"],
        out_hidden_size=v["out_hidden_size"],
        patch_size=v.get("patch_size", 14),
        temporal_patch_size=v.get("temporal_patch_size", 2),
        spatial_merge_size=v.get("spatial_merge_size", 2),
        window_size=v.get("window_size", 112),
        fullatt_block_indexes=tuple(v["fullatt_block_indexes"]),
        tokens_per_second=v.get("tokens_per_second", 2.0))
    text = QwenVLTextConfig(
        hidden_size=t["hidden_size"], num_layers=t["num_hidden_layers"],
        num_heads=t["num_attention_heads"],
        num_kv_heads=t["num_key_value_heads"],
        intermediate_size=t["intermediate_size"],
        vocab_size=t["vocab_size"], rope_theta=t.get("rope_theta", 1e6),
        mrope_section=tuple(t["rope_scaling"]["mrope_section"]),
        rms_eps=t.get("rms_norm_eps", 1e-6),
        tie_word_embeddings=t.get("tie_word_embeddings", False))
    return QwenVLConfig(
        vision=vision, text=text,
        image_token_id=c.get("image_token_id", 151655),
        video_token_id=c.get("video_token_id", 151656),
        vision_start_token_id=c.get("vision_start_token_id", 151652),
        eos_token_id=(c.get("eos_token_id") or 151645))


def qwen_vl_config_to_json(cfg: QwenVLConfig) -> Dict:
    """The ``config.json`` keys that ``qwen_vl_config_from_json`` reads."""
    v, t = cfg.vision, cfg.text
    return {
        "vision_config": {
            "depth": v.depth, "hidden_size": v.hidden_size,
            "num_heads": v.num_heads,
            "intermediate_size": v.intermediate_size,
            "out_hidden_size": v.out_hidden_size,
            "patch_size": v.patch_size,
            "temporal_patch_size": v.temporal_patch_size,
            "spatial_merge_size": v.spatial_merge_size,
            "window_size": v.window_size,
            "fullatt_block_indexes": list(v.fullatt_block_indexes),
            "tokens_per_second": v.tokens_per_second},
        "hidden_size": t.hidden_size, "num_hidden_layers": t.num_layers,
        "num_attention_heads": t.num_heads,
        "num_key_value_heads": t.num_kv_heads,
        "intermediate_size": t.intermediate_size,
        "vocab_size": t.vocab_size, "rope_theta": t.rope_theta,
        "rope_scaling": {"type": "mrope",
                         "mrope_section": list(t.mrope_section)},
        "rms_norm_eps": t.rms_eps,
        "tie_word_embeddings": t.tie_word_embeddings,
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "eos_token_id": cfg.eos_token_id}


# ---------------------------------------------------------------------------
# host-side layout and tables (numpy, as in JAX)
# ---------------------------------------------------------------------------

def vision_layout(grid_thw: Tuple[int, int, int],
                  cfg: QwenVLVisionConfig) -> Dict[str, np.ndarray]:
    """The static layout of one image/video grid (t, h, w in patches): the
    window permutation and its inverse, the padded-window gather and the
    rotary table over the permuted order (transformers' ``get_window_index``
    and ``rot_pos_emb``)."""
    t, h, w = grid_thw
    m = cfg.spatial_merge_size
    lh, lw = h // m, w // m
    vw = cfg.merger_window
    # window index over the merged cells, per temporal slice
    index = np.arange(t * lh * lw).reshape(t, lh, lw)
    pad_h, pad_w = (-lh) % vw, (-lw) % vw
    nh, nw = (lh + pad_h) // vw, (lw + pad_w) // vw
    ip = np.pad(index, ((0, 0), (0, pad_h), (0, pad_w)),
                constant_values=-100)
    ip = ip.reshape(t, nh, vw, nw, vw).transpose(0, 1, 3, 2, 4)
    ip = ip.reshape(t * nh * nw, vw * vw)
    win_lens = (ip != -100).sum(-1)                 # cells per window
    window_index = ip.reshape(-1)
    window_index = window_index[window_index != -100]
    # rotary position ids over the original cell x merge order
    hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
    hpos = hpos.reshape(lh, m, lw, m).transpose(0, 2, 1, 3).reshape(-1)
    wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))
    wpos = wpos.reshape(lh, m, lw, m).transpose(0, 2, 1, 3).reshape(-1)
    pos = np.tile(np.stack([hpos, wpos], -1), (t, 1))   # [S, 2]
    hd = cfg.head_dim
    inv = 1.0 / (10000.0 ** (np.arange(0, hd // 2, 2,
                                       dtype=np.float32) / (hd // 2)))
    # [S, hd/2]: the h angles, then the w angles
    freqs = (pos[:, :, None] * inv[None, None]).reshape(len(pos), -1)
    # tokens (cells x merge unit) permuted into window order
    mu = cfg.merge_unit
    S = t * h * w
    tok_perm = (window_index[:, None] * mu
                + np.arange(mu)[None]).reshape(-1)  # [S]
    emb = np.concatenate([freqs[tok_perm]] * 2, axis=-1)
    # the padded-window token gather (capacity vw * vw cells); index S is
    # a zero row
    cap = vw * vw * mu
    starts = np.concatenate([[0], np.cumsum(win_lens)[:-1]]) * mu
    gather = np.full((len(win_lens), cap), S, np.int64)
    for i, (s, n) in enumerate(zip(starts, win_lens * mu)):
        gather[i, :n] = np.arange(s, s + n)
    return {"tok_perm": tok_perm, "inv_tok_perm": np.argsort(tok_perm),
            "cell_perm": window_index,
            "cos": np.cos(emb).astype(np.float32),
            "sin": np.sin(emb).astype(np.float32),
            "win_gather": gather, "win_valid": gather < S,
            "grid": np.asarray(grid_thw)}


def mrope_tables(pos_ids: np.ndarray, cfg: QwenVLTextConfig
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """pos_ids [3, S] -> (cos, sin) [S, head_dim] fp32, each channel taking
    its angle from the t, h or w ids by ``mrope_section``."""
    hd = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta
                 ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    freqs = pos_ids[:, :, None].astype(np.float32) * inv  # [3, S, hd/2]
    emb = np.concatenate([freqs, freqs], axis=-1)         # [3, S, hd]
    sections = list(cfg.mrope_section) * 2
    axis = np.concatenate([np.full(n, i % 3, np.int64)
                           for i, n in enumerate(sections)])
    cos = np.take_along_axis(np.cos(emb), axis[None, None, :], axis=0)[0]
    sin = np.take_along_axis(np.sin(emb), axis[None, None, :], axis=0)[0]
    return cos.astype(np.float32), sin.astype(np.float32)


def get_rope_index(input_ids: np.ndarray,
                   grid_thw: Optional[Tuple[int, int, int]],
                   cfg: QwenVLConfig, is_video: bool = True,
                   second_per_grid_t: float = 1.0) -> np.ndarray:
    """Position ids [3, S] of one sequence with at most one image or video
    (transformers' ``get_rope_index`` at batch 1)."""
    ids = list(np.asarray(input_ids, np.int64))
    S = len(ids)
    if grid_thw is None:
        return np.broadcast_to(np.arange(S), (3, S)).copy()
    tok = cfg.video_token_id if is_video else cfg.image_token_id
    ed = ids.index(tok)
    t, h, w = grid_thw
    m = cfg.vision.spatial_merge_size
    lt, lh, lw = t, h // m, w // m
    parts = [np.broadcast_to(np.arange(ed), (3, ed))]
    tps = second_per_grid_t * cfg.vision.tokens_per_second if is_video \
        else 0.0
    t_idx = (np.arange(lt)[:, None] * tps).astype(np.int64)
    t_idx = np.broadcast_to(t_idx, (lt, lh * lw)).reshape(-1)
    h_idx = np.broadcast_to(np.arange(lh)[None, :, None],
                            (lt, lh, lw)).reshape(-1)
    w_idx = np.broadcast_to(np.arange(lw)[None, None, :],
                            (lt, lh, lw)).reshape(-1)
    parts.append(np.stack([t_idx, h_idx, w_idx]) + ed)
    st = ed + lt * lh * lw
    if st < S:
        st_idx = parts[-1].max() + 1
        parts.append(np.broadcast_to(np.arange(S - st), (3, S - st))
                     + st_idx)
    return np.concatenate(parts, axis=1)


# ---------------------------------------------------------------------------
# shared primitives
# ---------------------------------------------------------------------------

def _rms(x, w, eps):
    xf = x.float()
    v = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps)).to(x.dtype) * w


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _mm(x, layer):
    """x @ W^T without the bias. A ``QuantLinear`` takes the w8a8 path: K7
    on the rows of x, ``torch._int_mm``, then y.float() * (s_x * scale) in
    x's dtype (JAX's ``_mm``)."""
    if isinstance(layer, QuantLinear):
        return dense_int8(x, layer.weight_q, layer.scale)
    return F.linear(x, layer.weight)


def _lin(x, layer):
    """``_mm``, then the bias in x's dtype (JAX adds it after the product
    is rounded)."""
    y = _mm(x, layer)
    return y if layer.bias is None else y + layer.bias


class _RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, **kw))
        self.eps = eps

    def forward(self, x):
        return _rms(x, self.weight, self.eps)


class _SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int, bias: bool, **kw):
        super().__init__()
        self.gate_proj = nn.Linear(dim, hidden, bias=bias, **kw)
        self.up_proj = nn.Linear(dim, hidden, bias=bias, **kw)
        self.down_proj = nn.Linear(hidden, dim, bias=bias, **kw)

    def forward(self, x):
        g = F.silu(_lin(x, self.gate_proj))
        return _lin(g * _lin(x, self.up_proj), self.down_proj)


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------

class _VisionAttention(nn.Module):
    def __init__(self, dim: int, heads: int, **kw):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        self.heads = heads

    def forward(self, x, cos, sin, bias=None):
        """x [..., L, C] (leading dims fold); cos/sin fp32 [..., L, d]; bias
        fp32, added to the scores."""
        *lead, L, C = x.shape
        qkv = _lin(x, self.qkv).reshape(*lead, L, 3, self.heads, -1)
        q, k, v = (qkv[..., i, :, :].movedim(-2, -3) for i in range(3))
        c, s = cos[..., None, :, :], sin[..., None, :, :]
        q = (q.float() * c + _rotate_half(q.float()) * s).to(x.dtype)
        k = (k.float() * c + _rotate_half(k.float()) * s).to(x.dtype)
        att = ((q * q.shape[-1] ** -0.5) @ k.transpose(-1, -2)).float()
        if bias is not None:
            att = att + bias
        att = torch.softmax(att, dim=-1).to(x.dtype)
        o = (att @ v).movedim(-3, -2).reshape(*lead, L, C)
        return _lin(o, self.proj)


class _VisionBlock(nn.Module):
    def __init__(self, v: QwenVLVisionConfig, **kw):
        super().__init__()
        self.norm1 = _RMSNorm(v.hidden_size, v.rms_eps, **kw)
        self.norm2 = _RMSNorm(v.hidden_size, v.rms_eps, **kw)
        self.attn = _VisionAttention(v.hidden_size, v.num_heads, **kw)
        self.mlp = _SwiGLU(v.hidden_size, v.intermediate_size, True, **kw)


class _Merger(nn.Module):
    def __init__(self, v: QwenVLVisionConfig, **kw):
        super().__init__()
        width = v.hidden_size * v.merge_unit
        self.ln_q = _RMSNorm(v.hidden_size, v.rms_eps, **kw)
        self.mlp = nn.Sequential(nn.Linear(width, width, **kw), nn.GELU(),
                                 nn.Linear(width, v.out_hidden_size, **kw))


class QwenVisionTower(nn.Module):
    def __init__(self, v: QwenVLVisionConfig, **kw):
        super().__init__()
        self.cfg = v
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv3d(
            3, v.hidden_size, (v.temporal_patch_size, v.patch_size,
                               v.patch_size), bias=False, **kw)
        self.blocks = nn.ModuleList(_VisionBlock(v, **kw)
                                    for _ in range(v.depth))
        self.merger = _Merger(v, **kw)

    def forward(self, pixels, layout: Dict[str, np.ndarray]):
        """pixels [S, 3*tp*p*p] (the processor's flattened patches, original
        order) -> merged embeddings [S / merge_unit, out_hidden] in the
        original cell order (JAX's ``qwen_vision_forward``)."""
        v = self.cfg
        w = self.patch_embed.proj.weight
        dev = w.device

        def idx(a):
            return torch.from_numpy(np.asarray(a)).to(dev)
        x = F.linear(pixels.to(dev, w.dtype), w.reshape(w.shape[0], -1))
        S, C = x.shape
        x = x[idx(layout["tok_perm"])]
        cos, sin = idx(layout["cos"]), idx(layout["sin"])
        t = int(layout["grid"][0])
        gather = idx(layout["win_gather"])
        win_bias = torch.where(idx(layout["win_valid"]), 0.0,
                               -1e30)[:, None, None, :]
        keep = idx(np.nonzero(layout["win_valid"].reshape(-1))[0])
        zero = cos.new_zeros(1, cos.shape[-1])
        cosw = torch.cat([cos, zero])[gather]
        sinw = torch.cat([sin, zero])[gather]
        for i, blk in enumerate(self.blocks):
            h = blk.norm1(x)
            if i in v.fullatt_block_indexes:
                # full attention within each temporal slice (equal sizes)
                att = blk.attn(h.reshape(t, S // t, C),
                               cos.reshape(t, S // t, -1),
                               sin.reshape(t, S // t, -1))
                x = x + att.reshape(S, C)
            else:
                hw = torch.cat([h, h.new_zeros(1, C)])[gather]
                att = blk.attn(hw, cosw, sinw, win_bias)
                x = x + att.reshape(-1, C)[keep]
            x = x + blk.mlp(blk.norm2(x))
        m = self.merger
        h = m.ln_q(x).reshape(S // v.merge_unit, -1)
        h = F.gelu(_lin(h, m.mlp[0]))
        out = _lin(h, m.mlp[2])
        return out[idx(np.argsort(layout["cell_perm"]))]


# ---------------------------------------------------------------------------
# text decoder with a static KV cache
# ---------------------------------------------------------------------------

class _TextAttention(nn.Module):
    def __init__(self, t: QwenVLTextConfig, **kw):
        super().__init__()
        hd = t.head_dim
        self.q_proj = nn.Linear(t.hidden_size, t.num_heads * hd, **kw)
        self.k_proj = nn.Linear(t.hidden_size, t.num_kv_heads * hd, **kw)
        self.v_proj = nn.Linear(t.hidden_size, t.num_kv_heads * hd, **kw)
        self.o_proj = nn.Linear(t.num_heads * hd, t.hidden_size, bias=False,
                                **kw)


class _TextLayer(nn.Module):
    def __init__(self, t: QwenVLTextConfig, **kw):
        super().__init__()
        self.cfg = t
        self.input_layernorm = _RMSNorm(t.hidden_size, t.rms_eps, **kw)
        self.self_attn = _TextAttention(t, **kw)
        self.post_attention_layernorm = _RMSNorm(t.hidden_size, t.rms_eps,
                                                 **kw)
        self.mlp = _SwiGLU(t.hidden_size, t.intermediate_size, False, **kw)

    def forward(self, x, cos, sin, cache, idx: int, mask):
        """x [B, L, C]; cos/sin [L, hd] in x's dtype; cache (k, v) [B, kvh,
        T, hd], written in place at idx..idx+L; mask [L, T] fp32 additive
        (JAX's ``_text_layer``)."""
        t = self.cfg
        B, L, C = x.shape
        nh, kvh, hd = t.num_heads, t.num_kv_heads, t.head_dim
        a = self.self_attn
        h = self.input_layernorm(x)
        q = _lin(h, a.q_proj).reshape(B, L, nh, hd).transpose(1, 2)
        k = _lin(h, a.k_proj).reshape(B, L, kvh, hd).transpose(1, 2)
        v = _lin(h, a.v_proj).reshape(B, L, kvh, hd).transpose(1, 2)
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        cache_k, cache_v = cache
        cache_k[:, :, idx:idx + L] = k
        cache_v[:, :, idx:idx + L] = v
        kk = cache_k.repeat_interleave(nh // kvh, dim=1).transpose(-1, -2)
        vv = cache_v.repeat_interleave(nh // kvh, dim=1)
        scale = hd ** -0.5
        # prefill: one chunk of query rows at a time bounds the [L, T]
        # scores
        o = torch.cat([
            torch.softmax(((q[:, :, r:r + PREFILL_CHUNK] * scale) @ kk
                           ).float() + mask[r:r + PREFILL_CHUNK], dim=-1
                          ).to(q.dtype) @ vv
            for r in range(0, L, PREFILL_CHUNK)], dim=2)
        x = x + _mm(o.transpose(1, 2).reshape(B, L, C), a.o_proj)
        return x + self.mlp(self.post_attention_layernorm(x))


class _LanguageModel(nn.Module):
    def __init__(self, t: QwenVLTextConfig, **kw):
        super().__init__()
        self.embed_tokens = nn.Embedding(t.vocab_size, t.hidden_size, **kw)
        self.layers = nn.ModuleList(_TextLayer(t, **kw)
                                    for _ in range(t.num_layers))
        self.norm = _RMSNorm(t.hidden_size, t.rms_eps, **kw)


class QwenVL(nn.Module):
    """Qwen2.5-VL under transformers' names: ``model.visual``,
    ``model.language_model``, ``lm_head``."""

    def __init__(self, cfg: QwenVLConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.model = nn.Module()
        self.model.visual = QwenVisionTower(cfg.vision, **kw)
        self.model.language_model = _LanguageModel(cfg.text, **kw)
        self.lm_head = nn.Linear(cfg.text.hidden_size, cfg.text.vocab_size,
                                 bias=False, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def vision(self, pixels, layout):
        return self.model.visual(pixels, layout)

    def new_caches(self, batch: int, capacity: int):
        t = self.cfg.text
        shape = (batch, t.num_kv_heads, capacity, t.head_dim)
        return [(torch.zeros(shape, dtype=self.dtype, device=self.device),
                 torch.zeros(shape, dtype=self.dtype, device=self.device))
                for _ in range(t.num_layers)]

    def text_forward(self, embeds, cos, sin, caches, idx: int, mask):
        """Hidden states [B, L, C] after the final norm (JAX's
        ``text_forward`` before ``lm_head``); the caches are written in
        place. cos/sin are cast to the activation dtype (transformers'
        rule; a no-op in fp32)."""
        lm = self.model.language_model
        x = embeds
        cos, sin = cos.to(x.device, x.dtype), sin.to(x.device, x.dtype)
        mask = mask.to(x.device, torch.float32)
        for layer, cache in zip(lm.layers, caches):
            x = layer(x, cos, sin, cache, idx, mask)
        return lm.norm(x)

    def logits(self, h):
        return F.linear(h, self.lm_head.weight)


def causal_mask(rows: int, capacity: int, start: int = 0):
    """[rows, capacity] fp32: 0 where key position <= start + row and below
    start + rows (the keys written so far), else -1e30."""
    pos = torch.arange(capacity)
    row = start + torch.arange(rows)[:, None]
    keep = (pos[None] <= row) & (pos[None] < start + rows)
    return torch.where(keep, 0.0, -1e30)


class QwenVLGenerator:
    """Greedy decoding with a static-capacity KV cache (JAX's
    ``QwenVLGenerator``): one prefill, then one forward a token, stopping
    at EOS or ``max_new_tokens``. After ``generate``, ``timings`` holds
    the prefill's and each decode step's seconds (host clock, each ending
    at the argmax's device sync) and ``logits`` the logits each new token
    was taken from."""

    def __init__(self, model: QwenVL, max_new_tokens: int = 8):
        self.model = model
        self.max_new = max_new_tokens
        self.timings: Dict = {}
        self.logits: List[torch.Tensor] = []

    def _tables(self, pos_ids):
        cos, sin = mrope_tables(pos_ids, self.model.cfg.text)
        return torch.from_numpy(cos), torch.from_numpy(sin)

    @torch.no_grad()
    def generate(self, input_ids: np.ndarray,
                 vision_embeds: Optional[torch.Tensor],
                 pos_ids: np.ndarray) -> List[int]:
        """input_ids [S] with the vision placeholders expanded;
        vision_embeds [n_vis, C] spliced at the placeholders; pos_ids [3, S]
        from ``get_rope_index``."""
        model, cfg = self.model, self.model.cfg
        ids = np.asarray(input_ids, np.int64)
        S = len(ids)
        table = model.model.language_model.embed_tokens.weight
        dev = table.device
        embeds = table[torch.from_numpy(ids).to(dev)]
        if vision_embeds is not None:
            (vis_idx,) = np.nonzero(np.isin(ids, [cfg.image_token_id,
                                                  cfg.video_token_id]))
            if len(vis_idx) != vision_embeds.shape[0]:
                raise ValueError(f"{len(vis_idx)} vision placeholders for "
                                 f"{vision_embeds.shape[0]} embeddings")
            embeds[torch.from_numpy(vis_idx).to(dev)] = vision_embeds.to(
                dev, embeds.dtype)
        capacity = S + self.max_new
        caches = model.new_caches(1, capacity)
        t0 = time.perf_counter()
        cos, sin = self._tables(pos_ids)
        h = model.text_forward(embeds[None], cos, sin, caches, 0,
                               causal_mask(S, capacity))
        logits = model.logits(h[:, -1])
        delta = int(pos_ids.max()) + 1 - S      # the rope_deltas rule
        out, self.logits, decode_s = [], [], []
        for step in range(self.max_new):
            tok = int(torch.argmax(logits[0]))
            if step == 0:
                prefill_s = time.perf_counter() - t0
            else:
                decode_s.append(time.perf_counter() - t0)
            self.logits.append(logits[0])
            out.append(tok)
            if tok == cfg.eos_token_id or step == self.max_new - 1:
                break
            t0 = time.perf_counter()
            idx = S + step
            c1, s1 = self._tables(np.full((3, 1), idx + delta, np.int64))
            h = model.text_forward(table[[tok]][None], c1, s1, caches, idx,
                                   causal_mask(1, capacity, idx))
            logits = model.logits(h[:, -1])
        self.timings = {"prefill_s": prefill_s, "decode_s": decode_s}
        return out


# ---------------------------------------------------------------------------
# random weights, int8, state dicts
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_qwen_vl(cfg: QwenVLConfig, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32,
                 std: float = 0.02) -> QwenVL:
    """Seeded random weights on the generator's device, drawn in ``dtype``
    one tensor at a time in module order (no fp32 copy of a bf16 model):
    dense weights, biases and embeddings N(0, std), norm weights
    1 + N(0, 0.1)."""
    model = QwenVL(cfg, device="meta", dtype=dtype)
    model.to_empty(device=generator.device)
    for name, p in model.named_parameters():
        if name.endswith(("norm.weight", "norm1.weight", "norm2.weight",
                          "layernorm.weight", "ln_q.weight")):
            p.normal_(1.0, 0.1, generator=generator)
        else:
            p.normal_(0.0, std, generator=generator)
    if cfg.text.tie_word_embeddings:
        model.lm_head.weight = model.model.language_model.embed_tokens.weight
    return model.eval()


# the products JAX's ``quantize_qwen_int8`` swaps: q/k/v/o and gate/up/down
# of every text layer (embeddings, lm_head, norms and the vision tower stay
# float)
_QUANT_PATTERN = re.compile(
    r"model\.language_model\.layers\.\d+\."
    r"(self_attn\.[qkvo]_proj|mlp\.(gate|up|down)_proj)")


def quantize_qwen_int8(model: QwenVL) -> QwenVL:
    """The text layers' products -> ``QuantLinear``, in place, one layer at
    a time (``models/quant.quantize_dit_int8``). Returns ``model``."""
    return quantize_dit_int8(model, _QUANT_PATTERN)


def shard_qwen_params(*args, **kwargs):
    """Tensor parallelism over several cards: not ported (raises)."""
    raise NotImplementedError(TP_NOT_PORTED)


def _canon(name: str) -> str:
    """Legacy checkpoint names -> transformers' canonical layout."""
    if name.startswith("visual."):
        return "model." + name
    if name == "lm_head.weight" or name.startswith("model.visual.") \
            or name.startswith("model.language_model."):
        return name
    if name.startswith("model."):
        return "model.language_model." + name[len("model."):]
    return name


def qwen_vl_state_dict(sd: Dict[str, torch.Tensor], cfg: QwenVLConfig
                       ) -> Dict[str, torch.Tensor]:
    """A released checkpoint's tensors under the port's names: legacy names
    canonicalized, rotary ``inv_freq`` buffers dropped, ``lm_head.weight``
    taken from the embedding when the checkpoint ties or omits it."""
    out = {_canon(k): v for k, v in sd.items()
           if not k.endswith("inv_freq")}
    emb = "model.language_model.embed_tokens.weight"
    if cfg.text.tie_word_embeddings or "lm_head.weight" not in out:
        out["lm_head.weight"] = out[emb]
    return out


def qwen_vl_from_state_dict(sd: Dict[str, torch.Tensor], cfg: QwenVLConfig,
                            dtype: torch.dtype = torch.float32,
                            device="cpu") -> QwenVL:
    """A ``QwenVL`` from a released checkpoint's state dict (every key
    consumed), each tensor moved and cast on its own."""
    sd = qwen_vl_state_dict(sd, cfg)
    model = QwenVL(cfg, device="meta", dtype=dtype)
    model.load_state_dict({k: v.to(device, dtype) for k, v in sd.items()},
                          strict=True, assign=True)
    return model.eval()


def load_qwen_vl_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every safetensors shard of a checkpoint directory (the port's
    reader), else its ``pytorch_model*.bin`` files."""
    from frameino_tpu_torch.models.weights import load_safetensors_dir
    if glob.glob(os.path.join(model_dir, "*.safetensors")):
        return load_safetensors_dir(model_dir)
    sd = {}
    for binf in sorted(glob.glob(os.path.join(model_dir,
                                              "pytorch_model*.bin"))):
        sd.update(torch.load(binf, map_location="cpu", weights_only=True))
    if not sd:
        raise FileNotFoundError(f"no safetensors/bin weights under "
                                f"{model_dir}")
    return sd


def load_qwen_vl_torch(model_dir: str, max_new_tokens: int = 8,
                       dtype: torch.dtype = torch.bfloat16,
                       device="cuda", quantize: Optional[str] = None,
                       mesh=None, processor=None):
    """Qwen2.5-VL from a checkpoint directory: returns ``run(frames
    [T, H, W, 3] uint8, instruction) -> str``. Tokenization and video
    patching go through the directory's processor (``transformers``,
    imported here, local files only) unless ``processor`` is given (an
    object with transformers' ``apply_chat_template``, ``__call__`` and
    ``batch_decode``); the compute is this module's, on ``device``."""
    if mesh is not None:
        raise NotImplementedError(TP_NOT_PORTED)
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    cfg = qwen_vl_config_from_json(os.path.join(model_dir, "config.json"))
    model = qwen_vl_from_state_dict(load_qwen_vl_state_dict(model_dir), cfg,
                                    dtype=dtype, device=device)
    if quantize == "int8":
        quantize_qwen_int8(model)
    if processor is None:
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        from transformers import AutoProcessor
        processor = AutoProcessor.from_pretrained(model_dir,
                                                  local_files_only=True)
    generator = QwenVLGenerator(model, max_new_tokens)

    def run(frames: np.ndarray, instruction: str,
            max_pixels: int = 360 * 420, fps: float = 1.0) -> str:
        messages = [{"role": "user", "content": [
            {"type": "video", "video": [fr for fr in frames],
             "max_pixels": max_pixels, "fps": fps},
            {"type": "text", "text": instruction}]}]
        text = processor.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        frames_t = torch.from_numpy(np.stack(frames)).permute(0, 3, 1, 2)
        inputs = processor(text=[text], videos=[frames_t],
                           return_tensors="np")
        ids = np.asarray(inputs["input_ids"][0], np.int64)
        pixels = torch.from_numpy(np.asarray(inputs["pixel_values_videos"],
                                             np.float32))
        grid = tuple(int(g) for g in inputs["video_grid_thw"][0])
        spg = float(np.asarray(
            inputs.get("second_per_grid_ts", [1.0])).reshape(-1)[0])
        with torch.no_grad():
            vis = model.vision(pixels, vision_layout(grid, cfg.vision))
        pos = get_rope_index(ids, grid, cfg, is_video=True,
                             second_per_grid_t=spg)
        out_ids = generator.generate(ids, vis, pos)
        return processor.batch_decode([out_ids],
                                      skip_special_tokens=True)[0]

    return run
