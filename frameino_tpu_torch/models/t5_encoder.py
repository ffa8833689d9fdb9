"""T5 / UMT5 text encoders (counterpart of
``frameino_tpu/models/t5_encoder.py``).

The Wan pipelines encode prompts with UMT5-XXL (reference
``pipelines/pipeline_wan_i2v_motion_FrameINO.py:206-245`` through
``transformers.UMT5EncoderModel``) and CogVideoX with T5-XXL v1.1. Both
are relative-position-bias encoder stacks with RMS ("T5") layer norms
whose variance is taken in fp32, unscaled dot-product attention with fp32
scores and softmax, and gated tanh-GELU FFNs; UMT5 gives every layer its
own bias table, T5 shares layer 0's. The JAX package computes all of it
as plain XLA ops (no Pallas kernel), and so do these torch ops.

Module and parameter names are transformers' (``shared``,
``encoder.block.{i}.layer.{0,1}...``, ``encoder.final_layer_norm``), so a
released encoder's state dict loads through ``load_state_dict``; a file
that stores the embedding as ``encoder.embed_tokens`` loads through
``from_state_dict_names``.

After encoding, the Wan recipe zero-fills the embeddings past each
prompt's true length and pads to ``max_sequence_length`` (reference
``:226-243``): ``encode_and_mask``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 256384
    d_model: int = 4096
    d_kv: int = 64
    num_heads: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    per_layer_relative_bias: bool = True    # UMT5; False = classic T5
    gated_act: bool = True                  # v1.1 / UMT5 gated-gelu


UMT5_XXL = T5EncoderConfig()
T5_XXL_V11 = T5EncoderConfig(vocab_size=32128, per_layer_relative_bias=False)


def tiny_config(**kw) -> T5EncoderConfig:
    base = dict(vocab_size=64, d_model=16, d_kv=4, num_heads=2, d_ff=32,
                num_layers=2)
    base.update(kw)
    return T5EncoderConfig(**base)


# ---------------------------------------------------------------------------
# Relative position bias (T5 bucket scheme, bidirectional)
# ---------------------------------------------------------------------------

def relative_position_bucket(relative_position: np.ndarray,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """transformers ``T5Attention._relative_position_bucket``,
    bidirectional."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


def position_bias_indices(seq_len: int, cfg: T5EncoderConfig) -> np.ndarray:
    """[S, S] bucket indices (host side; fixed per length)."""
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    return relative_position_bucket(
        mem - ctx, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)


# ---------------------------------------------------------------------------
# Modules (transformers names)
# ---------------------------------------------------------------------------

class T5LayerNorm(nn.Module):
    """No mean subtraction; the variance in fp32; the weight in the input's
    dtype."""

    def __init__(self, d, eps, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d, **kw))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = (xf * torch.rsqrt(var + self.eps)).to(x.dtype)
        return y * self.weight.to(x.dtype)


def _linear(x, lin: nn.Linear):
    return F.linear(x, lin.weight.to(x.dtype))


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_bias: bool, **kw):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False, **kw)
        self.k = nn.Linear(cfg.d_model, inner, bias=False, **kw)
        self.v = nn.Linear(cfg.d_model, inner, bias=False, **kw)
        self.o = nn.Linear(inner, cfg.d_model, bias=False, **kw)
        self.relative_attention_bias = (
            nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads,
                         **kw) if has_bias else None)
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv

    def forward(self, h, bias):
        """h [B, S, d]; bias [1 or B, heads, S, S] fp32 (position bias plus
        the additive mask)."""
        B, S, _ = h.shape

        def proj(lin):
            return _linear(h, lin).reshape(B, S, self.heads, self.d_kv
                                           ).transpose(1, 2)
        q, k, v = proj(self.q), proj(self.k), proj(self.v)
        # T5 attention: no 1/sqrt(d) scale; fp32 scores and softmax
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(B, S, -1)
        return _linear(o, self.o)


class _AttnLayer(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_bias: bool, **kw):
        super().__init__()
        self.SelfAttention = T5SelfAttention(cfg, has_bias, **kw)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                      **kw)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, **kw):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **kw)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **kw)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, **kw)

    def forward(self, h):
        gate = F.gelu(_linear(h, self.wi_0), approximate="tanh")
        return _linear(gate * _linear(h, self.wi_1), self.wo)


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, **kw):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg, **kw)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                      **kw)


class T5Block(nn.Module):
    """Pre-norm self-attention, then the FFN (no dropout)."""

    def __init__(self, cfg: T5EncoderConfig, has_bias: bool, **kw):
        super().__init__()
        self.layer = nn.ModuleList([_AttnLayer(cfg, has_bias, **kw),
                                    _FFLayer(cfg, **kw)])

    def forward(self, x, bias):
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, **kw):
        super().__init__()
        self.block = nn.ModuleList(
            [T5Block(cfg, cfg.per_layer_relative_bias or i == 0, **kw)
             for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model,
                                            cfg.layer_norm_epsilon, **kw)


class T5Encoder(nn.Module):
    """The encoder stack of ``T5EncoderModel`` / ``UMT5EncoderModel``
    (gated FFNs: both released encoders are gated)."""

    def __init__(self, cfg: T5EncoderConfig, device=None, dtype=None):
        super().__init__()
        if not cfg.gated_act:
            raise NotImplementedError(
                "a T5 encoder without the gated FFN is not ported (UMT5 "
                "and T5 v1.1 are gated)")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.encoder = _Stack(cfg, **kw)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Seeded init mirroring ``init_t5_encoder``'s scales: unit-normal
        embeddings, uniform(+-1/sqrt(fan_in)) linears, 0.02-normal bias
        tables, unit norms."""
        def draw(p, fn, scale):
            r = fn(p.shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
            p.copy_(r.mul_(scale))

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                bound = mod.weight.shape[1] ** -0.5
                draw(mod.weight, torch.rand, 2 * bound)
                mod.weight.sub_(bound)
            elif isinstance(mod, nn.Embedding):
                draw(mod.weight, torch.randn,
                     1.0 if mod is self.shared else 0.02)
            elif isinstance(mod, T5LayerNorm):
                mod.weight.fill_(1.0)
        return self

    def forward(self, input_ids, attention_mask=None):
        """input_ids [B, S] -> [B, S, d_model] (``t5_encode``)."""
        cfg = self.cfg
        S = input_ids.shape[1]
        dev = self.shared.weight.device
        x = self.shared.weight[input_ids.to(dev)]
        buckets = torch.from_numpy(position_bias_indices(S, cfg)).to(dev)
        if attention_mask is not None:
            mask_add = torch.where(
                attention_mask.to(dev)[:, None, None, :] > 0, 0.0,
                torch.finfo(torch.float32).min)
        else:
            mask_add = torch.zeros(1, 1, 1, S, device=dev)

        def bias_of(blk):
            table = blk.layer[0].SelfAttention.relative_attention_bias
            return table.weight[buckets].permute(2, 0, 1)[None].float() \
                + mask_add

        bias = bias_of(self.encoder.block[0])
        for i, blk in enumerate(self.encoder.block):
            if cfg.per_layer_relative_bias and i > 0:
                bias = bias_of(blk)
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)


def from_state_dict_names(sd: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """A transformers T5 / UMT5 encoder state dict under the module's
    names: ``encoder.embed_tokens`` (the tied copy) folds into ``shared``,
    and a stack saved without its ``encoder.`` prefix gets it (as JAX's
    ``t5_from_state_dict`` reads both)."""
    if not any(k.startswith("encoder.") for k in sd):
        sd = {(k if k == "shared.weight" else f"encoder.{k}"): v
              for k, v in sd.items()}
    sd = dict(sd)
    tied = sd.pop("encoder.embed_tokens.weight", None)
    if "shared.weight" not in sd and tied is not None:
        sd["shared.weight"] = tied
    return sd


def init_t5_encoder(cfg: T5EncoderConfig, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> T5Encoder:
    """Seeded random T5Encoder on ``generator``'s device."""
    model = T5Encoder(cfg, device="meta", dtype=dtype)
    model.to_empty(device=generator.device)
    return model.init_random_(generator).eval()


@torch.no_grad()
def t5_encode(model: T5Encoder, input_ids,
              attention_mask: Optional[torch.Tensor] = None):
    """input_ids [B, S] -> [B, S, d_model] in the weights' dtype."""
    return model(input_ids, attention_mask)


@torch.no_grad()
def encode_and_mask(model: T5Encoder, input_ids, attention_mask,
                    max_sequence_length: int = 512):
    """The Wan prompt-embedding recipe (reference ``:226-243``): encode
    with the mask, zero-fill past each true length, pad or cut to
    ``max_sequence_length``."""
    emb = model(input_ids, attention_mask)
    emb = emb * attention_mask.to(emb.device)[..., None].to(emb.dtype)
    S = emb.shape[1]
    if S < max_sequence_length:
        emb = F.pad(emb, (0, 0, 0, max_sequence_length - S))
    return emb[:, :max_sequence_length]
