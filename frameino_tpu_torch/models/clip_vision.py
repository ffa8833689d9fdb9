"""CLIP vision tower, the Wan2.1 I2V condition-image encoder (counterpart of
``frameino_tpu/models/clip_vision.py``).

The Wan2.1 I2V pipeline encodes its condition image with a
``CLIPVisionModel`` (ViT-H/14) and feeds ``hidden_states[-2]``, the input
of the last layer without the post-layernorm, into the DiT's image-KV
branch. ``CLIPVision`` holds transformers' ``CLIPVisionModel`` names
without their ``vision_model.`` prefix (the checkpoint loader strips it
and drops the text tower and projections of ``CLIPModel`` /
``CLIPVisionModelWithProjection`` files). The forward is the JAX one:
patchify as a bias-free dense, class token, learned positions,
pre-layernorm, pre-LN residual layers with exact GELU (or quick_gelu) and
plain attention (``attention_ref``, JAX's ``attention_xla``: 257 tokens of
head_dim 80, a width the flash kernels do not take); fp32 statistics in
every LayerNorm, each rounded to the activations' dtype.

``preprocess_image`` follows the JAX function: bicubic resize of the short
side to 224 with ``jax.image.resize``'s antialiased Keys kernel
(``ops/resize.py``; ``F.interpolate`` differs), Python's rounding of the
resized sizes, a centre crop and CLIP's normalisation, computed on the
tensor's device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn
from torch.nn.functional import gelu

from frameino_tpu_torch.ops.attention import attention_ref
from frameino_tpu_torch.ops.linear import dense
from frameino_tpu_torch.ops.norms import layer_norm
from frameino_tpu_torch.ops.resize import resize_antialiased

# CLIPImageProcessor normalisation constants (OpenAI CLIP).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"      # "gelu" (ViT-H) or "quick_gelu" (OpenAI)

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


# Wan2.1 I2V image encoder: CLIP ViT-H/14 (laion2B), penultimate states.
CLIP_VIT_H_14 = CLIPVisionConfig()


def tiny_config(**kw) -> CLIPVisionConfig:
    base = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                num_attention_heads=2, image_size=28, patch_size=14)
    base.update(kw)
    return CLIPVisionConfig(**base)


# ---------------------------------------------------------------------------
# Modules (transformers names)
# ---------------------------------------------------------------------------

class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **kw):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.empty(d, **kw))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False,
                                         **kw)
        self.position_embedding = nn.Embedding(cfg.num_positions, d, **kw)


class _SelfAttention(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.out_proj = nn.Linear(d, d, **kw)


class _MLP(nn.Module):
    def __init__(self, d, inner, **kw):
        super().__init__()
        self.fc1 = nn.Linear(d, inner, **kw)
        self.fc2 = nn.Linear(inner, d, **kw)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **kw):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.self_attn = _SelfAttention(d, **kw)
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, **kw)
        self.mlp = _MLP(d, cfg.intermediate_size, **kw)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, **kw)

    def forward(self, x):
        cfg, a = self.cfg, self.self_attn
        eps, nh = cfg.layer_norm_eps, cfg.num_attention_heads
        B, S, D = x.shape

        def heads(t):
            return t.reshape(B, S, nh, -1).permute(0, 2, 1, 3)

        h = layer_norm(x, self.layer_norm1.weight, self.layer_norm1.bias,
                       eps=eps).to(x.dtype)
        o = attention_ref(heads(_lin(h, a.q_proj)), heads(_lin(h, a.k_proj)),
                          heads(_lin(h, a.v_proj)))
        x = x + _lin(o.permute(0, 2, 1, 3).reshape(B, S, D), a.out_proj)
        h = layer_norm(x, self.layer_norm2.weight, self.layer_norm2.bias,
                       eps=eps).to(x.dtype)
        h = _lin(h, self.mlp.fc1)
        h = h * torch.sigmoid(1.702 * h) if cfg.hidden_act == "quick_gelu" \
            else gelu(h)
        return x + _lin(h, self.mlp.fc2)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **kw):
        super().__init__()
        self.layers = nn.ModuleList([_EncoderLayer(cfg, **kw)
                                     for _ in range(cfg.num_hidden_layers)])


def _lin(x, layer: nn.Linear):
    return dense(x, layer.weight, layer.bias)


class CLIPVision(nn.Module):
    """CLIPVisionTransformer. Build with ``device="meta"`` and then
    ``to_empty`` + ``init_random_`` or ``load_state_dict(..., assign=True)``.
    """

    def __init__(self, cfg: CLIPVisionConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg, **kw)
        self.pre_layrnorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, **kw)
        self.encoder = _Encoder(cfg, **kw)
        self.post_layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.pre_layrnorm.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.pre_layrnorm.weight.device

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Seeded init: N(0, 0.02^2) class, patch and position embeddings,
        uniform(+-1/sqrt(fan_in)) dense weights and biases, unit / zero
        LayerNorms. Draws in fp32 on ``generator``'s device."""
        def draw(p, fn):
            return fn(p.shape, generator=generator, device=generator.device,
                      dtype=torch.float32)

        e = self.embeddings
        for p in (e.class_embedding, e.patch_embedding.weight,
                  e.position_embedding.weight):
            p.copy_(draw(p, torch.randn) * 0.02)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                bound = mod.in_features ** -0.5
                for p in (mod.weight, mod.bias):
                    p.copy_(draw(p, torch.rand).mul_(2 * bound).sub_(bound))
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        return self

    @torch.no_grad()
    def forward(self, pixel_values, penultimate: bool = True):
        """pixel_values [B, 3, H, W], CLIP-normalised. ``penultimate``:
        ``hidden_states[-2]`` (the first N - 1 layers; the Wan2.1
        ``image_embeds`` [B, 257, hidden]); otherwise the last layer's
        output (transformers' ``last_hidden_state``, no post-layernorm)."""
        cfg, e = self.cfg, self.embeddings
        x = pixel_values.to(self.device, self.dtype)
        B, C, H, W = x.shape
        p = cfg.patch_size
        x = x.reshape(B, C, H // p, p, W // p, p).permute(0, 2, 4, 1, 3, 5)
        x = dense(x.reshape(B, (H // p) * (W // p), C * p * p),
                  e.patch_embedding.weight.reshape(cfg.hidden_size, -1))
        cls = e.class_embedding.to(x.dtype).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + e.position_embedding.weight.to(
            x.dtype)[None]
        x = layer_norm(x, self.pre_layrnorm.weight, self.pre_layrnorm.bias,
                       eps=cfg.layer_norm_eps).to(x.dtype)
        layers = self.encoder.layers
        for layer in (layers[:-1] if penultimate else layers):
            x = layer(x)
        return x

    @torch.no_grad()
    def pooled_output(self, last_hidden_state):
        """post_layernorm(CLS token): transformers' ``pooler_output``."""
        return layer_norm(last_hidden_state[:, 0], self.post_layernorm.weight,
                          self.post_layernorm.bias,
                          eps=self.cfg.layer_norm_eps).to(
                              last_hidden_state.dtype)


def init_clip_vision(cfg: CLIPVisionConfig, generator: torch.Generator,
                     dtype: torch.dtype = torch.float32) -> CLIPVision:
    """Seeded random CLIPVision on ``generator``'s device."""
    model = CLIPVision(cfg, device="meta", dtype=dtype)
    model.to_empty(device=generator.device)
    return model.init_random_(generator).eval()


def from_state_dict_names(sd, module: CLIPVision):
    """A transformers CLIP file's tensors under ``CLIPVision``'s names: the
    ``vision_model.`` prefix stripped, the text tower, the projections and
    the ``position_ids`` buffer dropped."""
    own = set(module.state_dict())
    out = {}
    for k, v in sd.items():
        k = k[len("vision_model."):] if k.startswith("vision_model.") else k
        if k in own:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Preprocessing and the pipeline's image encoder
# ---------------------------------------------------------------------------

def preprocess_pixels(x, cfg: CLIPVisionConfig = CLIP_VIT_H_14):
    """[B, 3, H, W] fp32 RGB in [0, 1] -> [B, 3, S, S] CLIP-normalised, on
    x's device: the short side resized to S (bicubic, antialiased, sizes
    rounded as Python rounds), then the centre S x S crop."""
    h, w = x.shape[-2:]
    s = cfg.image_size
    scale = s / min(h, w)
    nh, nw = max(s, int(round(h * scale))), max(s, int(round(w * scale)))
    x = resize_antialiased(x.float(), (*x.shape[:-2], nh, nw), "cubic")
    top, left = (nh - s) // 2, (nw - s) // 2
    x = x[..., top:top + s, left:left + s]
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device).reshape(3, 1, 1)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device).reshape(3, 1, 1)
    return (x - mean) / std


def preprocess_image(image, cfg: CLIPVisionConfig = CLIP_VIT_H_14,
                     device=None):
    """The JAX function's contract: [H, W, 3] uint8 or float RGB (numpy or
    a tensor) -> [1, 3, S, S] normalised fp32, computed on ``device``
    (default: the tensor's, or the CPU)."""
    x = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image)
                        else image, device=device)
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    return preprocess_pixels(x.permute(2, 0, 1)[None], cfg)


def encode_condition_image(cfg: CLIPVisionConfig, model: CLIPVision, image):
    """Wan2.1 I2V ``image_embeds``: pixels [B, 3, H, W] in [-1, 1] ->
    [B, 257, hidden] penultimate states, on the model's device."""
    x = (torch.as_tensor(image).to(model.device, torch.float32) + 1.0) / 2.0
    return model(preprocess_pixels(x, cfg))


def make_image_encoder(cfg: CLIPVisionConfig, model: CLIPVision):
    """The pipeline's ``image_encoder`` callable."""
    return functools.partial(encode_condition_image, cfg, model)
