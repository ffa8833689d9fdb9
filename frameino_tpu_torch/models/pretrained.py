"""Checkpoint-directory loading: ``config.json`` + safetensors -> (config,
module) (counterpart of ``frameino_tpu/models/pretrained.py``).

The released checkpoints (Wan2.2-TI2V-5B, Wan2.1-I2V-14B with its CLIP
ViT-H/14 ``image_encoder/``, CogVideoX-5B and the ``uva-cv-lab/FrameINO_*``
finetunes, reference ``README.md:130-143``) ship in diffusers layout: each submodel directory holds a ``config.json`` with
every architecture hyperparameter, among them the Wan2.2 VAE's
per-channel ``latents_mean`` / ``latents_std`` (which appear nowhere in the
reference source), and ``*.safetensors`` weights.

``from_pretrained(dir)`` reads the config, builds the port's config
dataclass from it with no hand-supplied value, builds the module on the
meta device and fills it with ``load_state_dict(assign=True)`` from the
files, whose names the port's modules take as they are (diffusers names,
transformers' for the text and image encoders; the CLIP tower's without
their ``vision_model.`` prefix). The model class is dispatched on
the ``_class_name`` (diffusers) or ``architectures`` (transformers) field.
``save_pretrained`` writes a module and its config back in that layout.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import torch

from frameino_tpu_torch.models.safetensors_io import save_file
from frameino_tpu_torch.models.weights import load_safetensors_dir

class UnsupportedModelClass(ValueError):
    """A config.json names a model class this loader does not handle (the
    scheduler and tokenizer directories of a pipeline). Only this is
    skipped by ``load_pipeline_dir``; any other ValueError (such as the
    refusal of placeholder Wan2.2 latent statistics) propagates."""


def read_config_json(path: str) -> Dict[str, Any]:
    """``config.json`` of a checkpoint directory (or a direct path)."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    with open(path) as f:
        return json.load(f)


def _take(cj: Dict[str, Any], cls, alias: Dict[str, str] = (),
          **overrides):
    """Dataclass ``cls`` from the json dict: every field present in the
    json (directly or through ``alias``) is taken, lists as tuples; the
    rest keep their defaults. Other json keys (diffusers metadata such as
    ``_class_name``) are ignored."""
    alias = dict(alias or {})
    kwargs = {}
    for f in dataclasses.fields(cls):
        src = alias.get(f.name, f.name)
        if cj.get(src) is not None:
            v = cj[src]
            kwargs[f.name] = tuple(v) if isinstance(v, list) else v
    kwargs.update(overrides)
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# Configs from config.json
# ---------------------------------------------------------------------------

def wan_vae_config_from_json(cj: Dict[str, Any]):
    """diffusers AutoencoderKLWan config -> WanVAEConfig. Refuses a config
    without real normalization statistics: the in-code Wan2.2 defaults are
    unit placeholders, and serving with them corrupts every latent."""
    from frameino_tpu_torch.models.wan_vae import WanVAEConfig
    cfg = _take(cj, WanVAEConfig)
    z = cfg.z_dim
    if "latents_mean" not in cj or "latents_std" not in cj:
        raise ValueError(
            "checkpoint config.json lacks latents_mean/latents_std; "
            "refusing to fall back to placeholder normalization stats")
    if len(cfg.latents_mean) != z or len(cfg.latents_std) != z:
        raise ValueError(
            f"latents stats length {len(cfg.latents_mean)} != z_dim {z}")
    return cfg


def wan_dit_config_from_json(cj: Dict[str, Any]):
    """Wan2.2 or Wan2.1 (``image_dim``, ``added_kv_proj_dim``,
    ``pos_embed_seq_len``) DiT config."""
    from frameino_tpu_torch.models.wan_dit import WanDiTConfig
    return _take(cj, WanDiTConfig)


def cogvideox_dit_config_from_json(cj: Dict[str, Any]):
    from frameino_tpu_torch.models.cogvideox_dit import CogVideoXConfig
    # the reference's custom flag is spelled use_FrameIn
    # (architecture/cogvideox_transformer_3d.py:254-255)
    return _take(cj, CogVideoXConfig, alias={"use_frame_in": "use_FrameIn"})


def cogvideox_vae_config_from_json(cj: Dict[str, Any]):
    from frameino_tpu_torch.models.cogvideox_vae import CogVideoXVAEConfig
    return _take(cj, CogVideoXVAEConfig)


def t5_config_from_json(cj: Dict[str, Any]):
    from frameino_tpu_torch.models.t5_encoder import T5EncoderConfig
    is_umt5 = cj.get("model_type") == "umt5" \
        or "umt5" in cj.get("_name_or_path", "")
    act = cj.get("feed_forward_proj", cj.get("dense_act_fn", "gated-gelu"))
    return _take(cj, T5EncoderConfig, per_layer_relative_bias=is_umt5,
                 gated_act="gated" in str(act)
                 or bool(cj.get("is_gated_act", True)))


def clip_vision_config_from_json(cj: Dict[str, Any]):
    """transformers CLIPVisionConfig, or the ``vision_config`` of a full
    CLIPConfig."""
    from frameino_tpu_torch.models.clip_vision import CLIPVisionConfig
    return _take(cj.get("vision_config") or cj, CLIPVisionConfig)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _wan_vae(cfg, **kw):
    from frameino_tpu_torch.models.wan_vae import WanVAE
    return WanVAE(cfg, **kw)


def _wan_dit(cfg, **kw):
    from frameino_tpu_torch.models.wan_dit import WanDiT
    return WanDiT(cfg, **kw)


def _cog_dit(cfg, **kw):
    from frameino_tpu_torch.models.cogvideox_dit import CogVideoXDiT
    return CogVideoXDiT(cfg, **kw)


def _cog_vae(cfg, **kw):
    from frameino_tpu_torch.models.cogvideox_vae import CogVideoXVAE
    return CogVideoXVAE(cfg, **kw)


def _t5(cfg, **kw):
    from frameino_tpu_torch.models.t5_encoder import T5Encoder
    return T5Encoder(cfg, **kw)


def _clip(cfg, **kw):
    from frameino_tpu_torch.models.clip_vision import CLIPVision
    return CLIPVision(cfg, **kw)


_LOADERS = {
    "AutoencoderKLWan": (wan_vae_config_from_json, _wan_vae),
    "WanTransformer3DModel": (wan_dit_config_from_json, _wan_dit),
    "CogVideoXTransformer3DModel": (cogvideox_dit_config_from_json,
                                    _cog_dit),
    "AutoencoderKLCogVideoX": (cogvideox_vae_config_from_json, _cog_vae),
}
_T5_CLASSES = {"T5EncoderModel", "UMT5EncoderModel", "T5Model", "UMT5Model"}
_CLIP_CLASSES = {"CLIPVisionModel", "CLIPVisionModelWithProjection",
                 "CLIPModel"}


def _state_dict_for(module, sd: Dict[str, torch.Tensor]):
    """The file's tensors under the module's names: the T5 encoders fold
    the tied ``encoder.embed_tokens`` into ``shared`` and drop a T5 file's
    decoder; the CLIP tower drops the ``vision_model.`` prefix and what is
    not the vision tower; the CogVideoX DiT takes its sincos position table
    when the file has none (diffusers stores only a learned one)."""
    from frameino_tpu_torch.models import clip_vision, t5_encoder
    from frameino_tpu_torch.models.cogvideox_dit import CogVideoXDiT
    if isinstance(module, clip_vision.CLIPVision):
        sd = clip_vision.from_state_dict_names(sd, module)
    elif isinstance(module, t5_encoder.T5Encoder):
        sd = t5_encoder.from_state_dict_names(
            {k: v for k, v in sd.items()
             if not k.startswith(("decoder.", "lm_head."))})
    elif isinstance(module, CogVideoXDiT) and module.cfg.has_pos_embedding \
            and "patch_embed.pos_embedding" not in sd:
        sd = dict(sd, **{"patch_embed.pos_embedding":
                         module.patch_embed.default_pos_embedding(
                             module.cfg)})
    return sd


def from_pretrained(path: str, class_name: str = None, *,
                    device="cuda", dtype: torch.dtype = None
                    ) -> Tuple[Any, torch.nn.Module]:
    """Load one checkpoint directory -> (config dataclass, module in eval
    mode on ``device``). ``dtype`` casts the floating tensors (None keeps
    the file's); ``class_name`` overrides the config's ``_class_name`` /
    ``architectures`` dispatch."""
    cj = read_config_json(path)
    name = class_name or cj.get("_class_name")
    if name is None:
        archs = cj.get("architectures") or []
        name = archs[0] if archs else None
    if name is None:
        raise UnsupportedModelClass(
            f"{path}: config.json has no _class_name; pass class_name "
            f"explicitly")
    if name in _CLIP_CLASSES:
        cfg_fn, build = clip_vision_config_from_json, _clip
    elif name in _T5_CLASSES:
        cfg_fn, build = t5_config_from_json, _t5
    elif name in _LOADERS:
        cfg_fn, build = _LOADERS[name]
    else:
        raise UnsupportedModelClass(
            f"{path}: unsupported _class_name {name!r}")
    cfg = cfg_fn(cj)
    module = build(cfg, device="meta", dtype=dtype)
    sd = _state_dict_for(module, load_safetensors_dir(path))
    module.load_state_dict(
        {k: v.to(device, dtype) if dtype is not None and v.is_floating_point()
         else v.to(device) for k, v in sd.items()}, assign=True)
    return cfg, module.eval()


def load_pipeline_dir(root: str, **kw) -> Dict[str, Tuple[Any, Any]]:
    """Every submodel of a diffusers pipeline directory (``transformer/``,
    ``vae/``, ``text_encoder/`` ..., each with its config.json and
    safetensors) -> {subdirectory: (config, module)}; directories of other
    classes (``scheduler/``, ``tokenizer/``) are skipped. ``kw`` goes to
    ``from_pretrained``."""
    out = {}
    for sub in sorted(os.listdir(root)):
        d = os.path.join(root, sub)
        if not os.path.isdir(d) or not os.path.exists(
                os.path.join(d, "config.json")):
            continue
        try:
            out[sub] = from_pretrained(d, **kw)
        except UnsupportedModelClass:
            continue
    return out


def _class_entry(cfg, module) -> Dict[str, Any]:
    """The config.json fields that name the class of ``module``."""
    from frameino_tpu_torch.models import (clip_vision, cogvideox_dit,
                                           cogvideox_vae, t5_encoder, wan_dit,
                                           wan_vae)
    if isinstance(module, clip_vision.CLIPVision):
        return {"architectures": ["CLIPVisionModel"],
                "model_type": "clip_vision_model"}
    if isinstance(module, t5_encoder.T5Encoder):
        umt5 = cfg.per_layer_relative_bias
        return {"architectures": ["UMT5EncoderModel" if umt5
                                  else "T5EncoderModel"],
                "model_type": "umt5" if umt5 else "t5",
                "feed_forward_proj": "gated-gelu"}
    for cls, name in ((wan_vae.WanVAE, "AutoencoderKLWan"),
                      (wan_dit.WanDiT, "WanTransformer3DModel"),
                      (cogvideox_dit.CogVideoXDiT,
                       "CogVideoXTransformer3DModel"),
                      (cogvideox_vae.CogVideoXVAE, "AutoencoderKLCogVideoX")):
        if isinstance(module, cls):
            return {"_class_name": name}
    raise UnsupportedModelClass(f"no checkpoint class for "
                                f"{type(module).__name__}")


def save_pretrained(path: str, cfg, module: torch.nn.Module):
    """Write ``module`` as a checkpoint directory ``from_pretrained``
    reads: ``config.json`` (the config's fields under the released files'
    keys) and ``model.safetensors`` (its state dict, in its dtypes; the
    CLIP tower's under transformers' ``vision_model.`` prefix)."""
    from frameino_tpu_torch.models.clip_vision import CLIPVision
    os.makedirs(path, exist_ok=True)
    cj = dict(_class_entry(cfg, module), **dataclasses.asdict(cfg))
    if "use_frame_in" in cj:
        cj["use_FrameIn"] = cj.pop("use_frame_in")
    for key in ("per_layer_relative_bias", "gated_act"):
        cj.pop(key, None)               # implied by model_type, the FFN
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cj, f, indent=1)
    sd = module.state_dict()
    if isinstance(module, CLIPVision):
        sd = {f"vision_model.{k}": v for k, v in sd.items()}
    save_file(sd, os.path.join(path, "model.safetensors"),
              metadata={"format": "pt"})
