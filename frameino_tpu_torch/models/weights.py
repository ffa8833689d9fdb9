"""Weight bridge: JAX parameter trees (as numpy arrays) -> the port's
state dicts, under diffusers names (counterpart of
``frameino_tpu/models/weights.py``, which maps diffusers checkpoints into
the JAX trees), and ``load_safetensors_dir``, the checkpoint reader: the
port's modules take the released files' names as they are.

- JAX dense kernels [in, out] -> torch Linear weights [out, in]; the int8
  ``{kernel_q, scale}`` of ``frameino_tpu.models.quant.quantize_dit_int8``
  -> a ``QuantLinear``'s ``weight_q`` [out, in] and ``scale`` [out]
  (load them into a DiT on which ``models/quant.quantize_dit_int8`` ran);
- the DiTs' scanned ``blocks`` axis is unstacked into ``blocks.{i}``
  (Wan) or ``transformer_blocks.{i}`` (CogVideoX);
- the patch embeddings' dense rows -> Conv3d weight [D, C, pt, ph, pw]
  (Wan) or Conv2d weight [D, C, ph, pw] (CogVideoX);
- VAE conv kernels DHWIO -> OIDHW and HWIO -> OIHW, WanRMS_norm gammas
  [C] -> diffusers' [C, 1, 1(, 1)], 1x1 attention kernels -> Conv2d.

The VAEs' block structure is read from the config, never from the tree's
static ``Meta`` tags.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from frameino_tpu_torch.core.meshes import Mesh
from frameino_tpu_torch.models.cogvideox_dit import CogVideoXConfig
from frameino_tpu_torch.models.cogvideox_vae import CogVideoXVAEConfig
from frameino_tpu_torch.models.safetensors_io import load_file
from frameino_tpu_torch.models.wan_dit import WanDiTConfig
from frameino_tpu_torch.models.wan_vae import WanVAEConfig
from frameino_tpu_torch.ops.conv_int8 import kernel_weight
from frameino_tpu_torch.parallel.sharding import shard_state_dict

StateDict = Dict[str, torch.Tensor]


def load_safetensors_dir(path: str) -> StateDict:
    """Every tensor of one safetensors file, or of every ``*.safetensors``
    in a directory in sorted order (``frameino_tpu/models/weights.py:32``),
    as CPU views of the memory-mapped files."""
    if os.path.isfile(path):
        files = [path]
    else:
        files = [os.path.join(path, n) for n in sorted(os.listdir(path))
                 if n.endswith(".safetensors")]
    if not files:
        raise FileNotFoundError(f"no safetensors under {path}")
    out: StateDict = {}
    for f in files:
        out.update(load_file(f))
    return out


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))   # a writable copy


def _put_lin(sd: StateDict, name: str, p: Dict[str, Any]):
    if "kernel_q" in p:
        # int8 dense of ``quantize_dit_int8``: kernel_q [in, out], scale
        # [out] -> a QuantLinear's weight_q [out, in] and scale
        sd[f"{name}.weight_q"] = _t(np.asarray(p["kernel_q"]).T)
        sd[f"{name}.scale"] = _t(p["scale"])
    else:
        sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def wan_dit_from_jax(params_np: Dict[str, Any], cfg: WanDiTConfig,
                     mesh: Optional[Mesh] = None) -> StateDict:
    """JAX ``init_wan_dit``-layout tree, float or int8-quantized ->
    ``WanDiT`` state dict. With a dp x tp ``mesh``, this rank's slice of it
    (``parallel.sharding.shard_state_dict``), for ``WanDiT(cfg,
    mesh=mesh)``: the slice of the same tree that JAX's ``shard_pytree``
    places on the rank's device, with the qk-norm gains cut to its heads."""
    if mesh is not None:
        return shard_state_dict(wan_dit_from_jax(params_np, cfg), mesh)
    d = cfg.inner_dim
    sd: StateDict = {}
    pe = params_np["patch_embedding"]
    sd["patch_embedding.weight"] = _t(np.asarray(pe["kernel"]).T.reshape(
        d, cfg.in_channels, *cfg.patch_size))
    sd["patch_embedding.bias"] = _t(pe["bias"])
    ce = params_np["condition_embedder"]
    for sub in ("time_embedder", "text_embedder"):
        for lin in ("linear_1", "linear_2"):
            _put_lin(sd, f"condition_embedder.{sub}.{lin}", ce[sub][lin])
    _put_lin(sd, "condition_embedder.time_proj", ce["time_proj"])
    if "image_embedder" in ce:
        ie, n = ce["image_embedder"], "condition_embedder.image_embedder"
        for ln in ("norm1", "norm2"):
            sd[f"{n}.{ln}.weight"] = _t(ie[ln]["weight"])
            sd[f"{n}.{ln}.bias"] = _t(ie[ln]["bias"])
        _put_lin(sd, f"{n}.ff.net.0.proj", ie["ff"]["fc1"])
        _put_lin(sd, f"{n}.ff.net.2", ie["ff"]["fc2"])
        if "pos_embed" in ie:
            sd[f"{n}.pos_embed"] = _t(ie["pos_embed"])
    sd["scale_shift_table"] = _t(params_np["norm_out_table"])
    _put_lin(sd, "proj_out", params_np["proj_out"])

    blocks = params_np["blocks"]
    for i in range(cfg.num_layers):
        lp = _index_tree(blocks, i)
        b = f"blocks.{i}."
        sd[b + "scale_shift_table"] = _t(lp["scale_shift_table"])
        for an in ("attn1", "attn2"):
            a = lp[an]
            for proj in ("to_q", "to_k", "to_v"):
                _put_lin(sd, b + f"{an}.{proj}", a[proj])
            _put_lin(sd, b + f"{an}.to_out.0", a["to_out"])
            sd[b + f"{an}.norm_q.weight"] = _t(a["norm_q"]["weight"])
            sd[b + f"{an}.norm_k.weight"] = _t(a["norm_k"]["weight"])
        if "add_k_proj" in lp["attn2"]:
            a = lp["attn2"]
            _put_lin(sd, b + "attn2.add_k_proj", a["add_k_proj"])
            _put_lin(sd, b + "attn2.add_v_proj", a["add_v_proj"])
            sd[b + "attn2.norm_added_k.weight"] = _t(
                a["norm_added_k"]["weight"])
        _put_lin(sd, b + "ffn.net.0.proj", lp["ffn"]["fc1"])
        _put_lin(sd, b + "ffn.net.2", lp["ffn"]["fc2"])
        if cfg.cross_attn_norm:
            sd[b + "norm2.weight"] = _t(lp["norm2"]["weight"])
            sd[b + "norm2.bias"] = _t(lp["norm2"]["bias"])
    return sd


def clip_vision_from_jax(params_np: Dict[str, Any], cfg) -> StateDict:
    """``frameino_tpu.models.clip_vision`` tree -> the port's ``CLIPVision``
    state dict (transformers' ``CLIPVisionModel`` names without the
    ``vision_model.`` prefix): the patch kernel [C*p*p, D] -> Conv2d
    [D, C, p, p], the stacked ``layers`` unstacked into
    ``encoder.layers.{i}``."""
    sd: StateDict = {}
    d, p = cfg.hidden_size, cfg.patch_size
    sd["embeddings.class_embedding"] = _t(params_np["class_embedding"])
    sd["embeddings.patch_embedding.weight"] = _t(np.asarray(
        params_np["patch_embedding"]["kernel"]).T.reshape(
            d, cfg.num_channels, p, p))
    sd["embeddings.position_embedding.weight"] = _t(
        params_np["position_embedding"])
    for ln in ("pre_layrnorm", "post_layernorm"):
        sd[f"{ln}.weight"] = _t(params_np[ln]["weight"])
        sd[f"{ln}.bias"] = _t(params_np[ln]["bias"])
    for i in range(cfg.num_hidden_layers):
        lp = _index_tree(params_np["layers"], i)
        b = f"encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            sd[b + f"{ln}.weight"] = _t(lp[ln]["weight"])
            sd[b + f"{ln}.bias"] = _t(lp[ln]["bias"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _put_lin(sd, b + f"self_attn.{proj}", lp["attn"][proj])
        _put_lin(sd, b + "mlp.fc1", lp["mlp"]["fc1"])
        _put_lin(sd, b + "mlp.fc2", lp["mlp"]["fc2"])
    return sd


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


# ---------------------------------------------------------------------------
# Wan VAE
# ---------------------------------------------------------------------------

def _put_conv(sd: StateDict, name: str, p, axes):
    """A conv's kernel (DHWIO / HWIO, ``axes`` to torch's layout), or the
    int8 ``kernel_q`` with its ``scale`` (``quantize_wan_vae_int8``'s
    tree, into the port's ``weight_q`` in K14's layout and ``scale``), and
    its bias."""
    if "kernel_q" in p:
        sd[f"{name}.weight_q"] = kernel_weight(
            _t(np.asarray(p["kernel_q"]).transpose(axes)))
        sd[f"{name}.scale"] = _t(p["scale"])
    else:
        sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(axes))
    sd[f"{name}.bias"] = _t(p["bias"])


def _put_cconv(sd: StateDict, name: str, p):
    _put_conv(sd, name, p, (4, 3, 0, 1, 2))


def _put_conv2d(sd: StateDict, name: str, p):
    _put_conv(sd, name, p, (3, 2, 0, 1))


def _put_gamma(sd: StateDict, name: str, p, images: bool = False):
    g = np.asarray(p["gamma"])
    sd[f"{name}.gamma"] = _t(g.reshape(g.shape[0], *((1,) * (2 if images
                                                              else 3))))


def _put_res(sd: StateDict, name: str, p):
    _put_gamma(sd, f"{name}.norm1", p["norm1"])
    _put_cconv(sd, f"{name}.conv1", p["conv1"])
    _put_gamma(sd, f"{name}.norm2", p["norm2"])
    _put_cconv(sd, f"{name}.conv2", p["conv2"])
    if "conv_shortcut" in p:
        _put_cconv(sd, f"{name}.conv_shortcut", p["conv_shortcut"])


def _put_attn(sd: StateDict, name: str, p):
    _put_gamma(sd, f"{name}.norm", p["norm"], images=True)
    for proj in ("to_qkv", "proj"):
        k = np.asarray(p[proj]["kernel"])
        sd[f"{name}.{proj}.weight"] = _t(k.T[:, :, None, None])
        sd[f"{name}.{proj}.bias"] = _t(p[proj]["bias"])


def _put_resample(sd: StateDict, name: str, p, temporal: bool):
    _put_conv2d(sd, f"{name}.resample.1", p["conv"])
    if temporal:
        _put_cconv(sd, f"{name}.time_conv", p["time_conv"])


def _put_mid(sd: StateDict, name: str, p):
    _put_res(sd, f"{name}.resnets.0", p["res1"])
    _put_attn(sd, f"{name}.attentions.0", p["attn"])
    _put_res(sd, f"{name}.resnets.1", p["res2"])


def wan_vae_from_jax(params_np: Dict[str, Any],
                     cfg: WanVAEConfig) -> StateDict:
    """JAX ``init_wan_vae``-layout tree -> ``WanVAE`` state dict (the
    diffusers ``AutoencoderKLWan`` names), plain (2.1) or residual (2.2)
    block layout per ``cfg.is_residual``."""
    sd: StateDict = {}
    enc = params_np["encoder"]
    _put_cconv(sd, "encoder.conv_in", enc["conv_in"])
    n_levels = len(cfg.dim_mult)
    if cfg.is_residual:
        for i, blk in enumerate(enc["down_blocks"]):
            last = i == n_levels - 1
            temporal = (not last) and cfg.temperal_downsample[i]
            base = f"encoder.down_blocks.{i}"
            for j in range(cfg.num_res_blocks):
                _put_res(sd, f"{base}.resnets.{j}", blk["resnets"][j])
            if not last:
                _put_resample(sd, f"{base}.downsampler", blk["downsampler"],
                              temporal)
    else:
        # flat list: res (+attn) per block, then a resample per level
        li = 0
        scale = 1.0
        blocks = enc["down_blocks"]
        for i in range(n_levels):
            for _ in range(cfg.num_res_blocks):
                _put_res(sd, f"encoder.down_blocks.{li}", blocks[li])
                li += 1
                if scale in cfg.attn_scales:
                    _put_attn(sd, f"encoder.down_blocks.{li}", blocks[li])
                    li += 1
            if i != n_levels - 1:
                _put_resample(sd, f"encoder.down_blocks.{li}", blocks[li],
                              cfg.temperal_downsample[i])
                li += 1
                scale /= 2.0
    _put_mid(sd, "encoder.mid_block", enc["mid"])
    _put_gamma(sd, "encoder.norm_out", enc["norm_out"])
    _put_cconv(sd, "encoder.conv_out", enc["conv_out"])

    dec = params_np["decoder"]
    _put_cconv(sd, "decoder.conv_in", dec["conv_in"])
    _put_mid(sd, "decoder.mid_block", dec["mid"])
    for i, blk in enumerate(dec["up_blocks"]):
        base = f"decoder.up_blocks.{i}"
        for j in range(cfg.num_res_blocks + 1):
            _put_res(sd, f"{base}.resnets.{j}", blk["resnets"][j])
        if i != n_levels - 1:
            up = f"{base}.upsampler" if cfg.is_residual \
                else f"{base}.upsamplers.0"
            _put_resample(sd, up, blk["upsampler"], cfg.temperal_upsample[i])
    _put_gamma(sd, "decoder.norm_out", dec["norm_out"])
    _put_cconv(sd, "decoder.conv_out", dec["conv_out"])
    _put_cconv(sd, "quant_conv", params_np["quant_conv"])
    _put_cconv(sd, "post_quant_conv", params_np["post_quant_conv"])
    return sd


# ---------------------------------------------------------------------------
# CogVideoX DiT and VAE
# ---------------------------------------------------------------------------

def _put_norm(sd: StateDict, name: str, p):
    sd[f"{name}.weight"] = _t(p["weight"])
    sd[f"{name}.bias"] = _t(p["bias"])


def cogvideox_dit_from_jax(params_np: Dict[str, Any],
                           cfg: CogVideoXConfig,
                           mesh: Optional[Mesh] = None) -> StateDict:
    """JAX ``init_cogvideox_dit``-layout tree, float or int8-quantized ->
    ``CogVideoXDiT`` state dict (the names of
    ``weights.cogvideox_dit_to_state_dict``). With a dp x tp x sp ``mesh``,
    this rank's slice of it (``parallel.sharding.shard_state_dict``), for
    ``CogVideoXDiT(cfg, mesh=mesh)``."""
    if mesh is not None:
        return shard_state_dict(cogvideox_dit_from_jax(params_np, cfg), mesh)
    d, p = cfg.inner_dim, cfg.patch_size
    sd: StateDict = {}
    pe = params_np["patch_embed"]
    if cfg.patch_size_t is None:
        sd["patch_embed.proj.weight"] = _t(np.asarray(pe["proj"]["kernel"]).T
                                           .reshape(d, cfg.in_channels, p, p))
        sd["patch_embed.proj.bias"] = _t(pe["proj"]["bias"])
    else:                                # CogVideoX 1.5: a Linear
        _put_lin(sd, "patch_embed.proj", pe["proj"])
    _put_lin(sd, "patch_embed.text_proj", pe["text_proj"])
    if "pos_embedding" in pe:            # 5B and 2B; 1.5 has none
        sd["patch_embed.pos_embedding"] = _t(pe["pos_embedding"])
    for lin in ("linear_1", "linear_2"):
        _put_lin(sd, f"time_embedding.{lin}",
                 params_np["time_embedding"][lin])
        if "ofs_embedding" in params_np:
            _put_lin(sd, f"ofs_embedding.{lin}",
                     params_np["ofs_embedding"][lin])
    _put_norm(sd, "norm_final", params_np["norm_final"])
    _put_lin(sd, "norm_out.linear", params_np["norm_out"]["linear"])
    _put_norm(sd, "norm_out.norm", params_np["norm_out"]["norm"])
    _put_lin(sd, "proj_out", params_np["proj_out"])
    for i in range(cfg.num_layers):
        lp = _index_tree(params_np["blocks"], i)
        b = f"transformer_blocks.{i}."
        for nn_ in ("norm1", "norm2"):
            _put_lin(sd, b + f"{nn_}.linear", lp[nn_]["linear"])
            _put_norm(sd, b + f"{nn_}.norm", lp[nn_]["norm"])
        a = lp["attn1"]
        for proj in ("to_q", "to_k", "to_v"):
            _put_lin(sd, b + f"attn1.{proj}", a[proj])
        _put_lin(sd, b + "attn1.to_out.0", a["to_out"])
        _put_norm(sd, b + "attn1.norm_q", a["norm_q"])
        _put_norm(sd, b + "attn1.norm_k", a["norm_k"])
        _put_lin(sd, b + "ff.net.0.proj", lp["ff"]["fc1"])
        _put_lin(sd, b + "ff.net.2", lp["ff"]["fc2"])
    return sd


def _put_cog_cconv(sd: StateDict, name: str, p):
    """CogVideoXCausalConv3d wraps its Conv3d as ``.conv``."""
    _put_cconv(sd, f"{name}.conv", p)


def _put_cog_spatial_norm(sd: StateDict, name: str, p):
    _put_norm(sd, f"{name}.norm_layer", p["norm"])
    _put_cog_cconv(sd, f"{name}.conv_y", p["conv_y"])
    _put_cog_cconv(sd, f"{name}.conv_b", p["conv_b"])


def _put_cog_res(sd: StateDict, name: str, p, spatial_norm: bool):
    for n in ("norm1", "norm2"):
        if spatial_norm:
            _put_cog_spatial_norm(sd, f"{name}.{n}", p[n])
        else:
            _put_norm(sd, f"{name}.{n}", p[n])
    _put_cog_cconv(sd, f"{name}.conv1", p["conv1"])
    _put_cog_cconv(sd, f"{name}.conv2", p["conv2"])
    if "conv_shortcut" in p:
        # diffusers' default 1x1x1 shortcut is a plain (Safe)Conv3d
        _put_cconv(sd, f"{name}.conv_shortcut", p["conv_shortcut"])


def cogvideox_vae_from_jax(params_np: Dict[str, Any],
                           cfg: CogVideoXVAEConfig) -> StateDict:
    """JAX ``init_cogvideox_vae``-layout tree -> ``CogVideoXVAE`` state
    dict (diffusers ``AutoencoderKLCogVideoX`` names; the inverse of
    ``weights.cogvideox_vae_from_state_dict``)."""
    sd: StateDict = {}
    levels = len(cfg.block_out_channels)
    enc = params_np["encoder"]
    _put_cog_cconv(sd, "encoder.conv_in", enc["conv_in"])
    for i, blk in enumerate(enc["down_blocks"]):
        base = f"encoder.down_blocks.{i}"
        for j in range(cfg.layers_per_block):
            _put_cog_res(sd, f"{base}.resnets.{j}", blk["resnets"][j], False)
        if i < levels - 1:
            _put_conv2d(sd, f"{base}.downsamplers.0.conv",
                        blk["downsampler"])
    for j in range(2):
        _put_cog_res(sd, f"encoder.mid_block.resnets.{j}",
                     enc["mid"]["resnets"][j], False)
    _put_norm(sd, "encoder.norm_out", enc["norm_out"])
    _put_cog_cconv(sd, "encoder.conv_out", enc["conv_out"])

    dec = params_np["decoder"]
    _put_cog_cconv(sd, "decoder.conv_in", dec["conv_in"])
    for j in range(2):
        _put_cog_res(sd, f"decoder.mid_block.resnets.{j}",
                     dec["mid"]["resnets"][j], True)
    for i, blk in enumerate(dec["up_blocks"]):
        base = f"decoder.up_blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            _put_cog_res(sd, f"{base}.resnets.{j}", blk["resnets"][j], True)
        if i < levels - 1:
            _put_conv2d(sd, f"{base}.upsamplers.0.conv",
                        blk["upsampler"])
    _put_cog_spatial_norm(sd, "decoder.norm_out", dec["norm_out"])
    _put_cog_cconv(sd, "decoder.conv_out", dec["conv_out"])
    return sd


# ---------------------------------------------------------------------------
# Perception models (evaluation): released-checkpoint readers, and the JAX
# trees of frameino_tpu/models/{dinov2,cotracker,sam2}.py -> the port's
# state dicts (the inverses of the JAX packages' *_from_state_dict)
# ---------------------------------------------------------------------------

def read_checkpoint(path: str) -> StateDict:
    """A released perception checkpoint: ``.safetensors`` through the
    port's reader, else ``torch.load(weights_only=True)`` and its
    ``"model"`` dict where it has one."""
    if path.endswith(".safetensors") or os.path.isdir(path):
        return dict(load_safetensors_dir(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return dict(sd)


def dinov2_to_state_dict(params_np: Dict[str, Any], cfg) -> StateDict:
    """``frameino_tpu.models.dinov2`` tree -> upstream ``dinov2_vitb14``
    names (the patch rows back to the conv [D, 3, p, p], the stacked
    blocks unstacked, dense kernels transposed; a zero ``mask_token``)."""
    p = cfg.patch_size
    sd: StateDict = {
        "patch_embed.proj.weight": _t(np.asarray(params_np["patch_w"]).T
                                      .reshape(cfg.dim, 3, p, p)),
        "patch_embed.proj.bias": _t(params_np["patch_b"]),
        "cls_token": _t(params_np["cls_token"]),
        "pos_embed": _t(params_np["pos_embed"]),
        "mask_token": torch.zeros(1, cfg.dim),
        "norm.weight": _t(params_np["norm_w"]),
        "norm.bias": _t(params_np["norm_b"]),
    }
    names = {"n1w": "norm1.weight", "n1b": "norm1.bias",
             "qkv_w": "attn.qkv.weight", "qkv_b": "attn.qkv.bias",
             "proj_w": "attn.proj.weight", "proj_b": "attn.proj.bias",
             "ls1": "ls1.gamma", "n2w": "norm2.weight", "n2b": "norm2.bias",
             "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
             "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias",
             "ls2": "ls2.gamma"}
    for key, name in names.items():
        stacked = np.asarray(params_np["blocks"][key])
        for i in range(cfg.depth):
            a = stacked[i]
            sd[f"blocks.{i}.{name}"] = _t(a.T if key.endswith("_w") else a)
    return sd


def cotracker_to_state_dict(params_np: Dict[str, Any]) -> StateDict:
    """``frameino_tpu.models.cotracker`` tree (torch layouts already) ->
    the released checkpoint's names (a residual block's 1x1 shortcut is
    ``downsample.0``)."""
    sd: StateDict = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            name = "downsample.0" if k == "downsample" else k
            if isinstance(v, dict):
                walk(v, f"{prefix}{name}.")
            else:
                sd[prefix + name] = _t(v)
    walk(params_np, "")
    return sd


def _put_sam_lin(sd: StateDict, name: str, p):
    sd[name + ".weight"] = _t(np.asarray(p["w"]).T)
    sd[name + ".bias"] = _t(p["b"])


def _put_sam_conv(sd: StateDict, name: str, p):
    sd[name + ".weight"] = _t(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))
    sd[name + ".bias"] = _t(p["b"])


def _put_sam_convT(sd: StateDict, name: str, p):
    # JAX keeps torch's [Cin, Cout, kh, kw] flipped and transposed to HWIO
    w = np.transpose(np.asarray(p["w"]), (2, 3, 0, 1))[:, :, ::-1, ::-1]
    sd[name + ".weight"] = _t(w)
    sd[name + ".bias"] = _t(p["b"])


def _put_sam_ln(sd: StateDict, name: str, w, b):
    sd[name + ".weight"] = _t(w)
    sd[name + ".bias"] = _t(b)


def _put_sam_mlp(sd: StateDict, name: str, p):
    for i, lp in enumerate(p["layers"]):
        _put_sam_lin(sd, f"{name}.layers.{i}", lp)


def _put_sam_attn(sd: StateDict, name: str, p):
    for k in ("q", "k", "v", "out"):
        _put_sam_lin(sd, f"{name}.{k}_proj", p[k])


def sam2_to_state_dict(params_np: Dict[str, Any], cfg) -> StateDict:
    """``frameino_tpu.models.sam2`` tree -> the released SAM2.1 checkpoint's
    names (without the video API's unused ``mask_downsample``)."""
    sd: StateDict = {}
    t = "image_encoder.trunk."
    tr = params_np["trunk"]
    _put_sam_conv(sd, t + "patch_embed.proj", tr["patch_embed"])
    sd[t + "pos_embed"] = _t(tr["pos_embed"])
    sd[t + "pos_embed_window"] = _t(tr["pos_embed_window"])
    for i, blk in enumerate(tr["blocks"]):
        b = f"{t}blocks.{i}."
        _put_sam_ln(sd, b + "norm1", blk["n1w"], blk["n1b"])
        _put_sam_ln(sd, b + "norm2", blk["n2w"], blk["n2b"])
        _put_sam_lin(sd, b + "attn.qkv", blk["qkv"])
        _put_sam_lin(sd, b + "attn.proj", blk["attn_proj"])
        _put_sam_lin(sd, b + "mlp.layers.0", blk["mlp1"])
        _put_sam_lin(sd, b + "mlp.layers.1", blk["mlp2"])
        if "proj" in blk:
            _put_sam_lin(sd, b + "proj", blk["proj"])
    for i, c in enumerate(params_np["neck"]["convs"]):
        _put_sam_conv(sd, f"image_encoder.neck.convs.{i}.conv", c)

    pp = "sam_prompt_encoder."
    pr = params_np["prompt"]
    sd[pp + "pe_layer.positional_encoding_gaussian_matrix"] = _t(pr["gauss"])
    for i in range(4):
        sd[f"{pp}point_embeddings.{i}.weight"] = _t(
            np.asarray(pr["point_embed"])[i:i + 1])
    sd[pp + "not_a_point_embed.weight"] = _t(np.asarray(pr["not_a_point"])
                                             [None])
    sd[pp + "no_mask_embed.weight"] = _t(np.asarray(pr["no_mask"])[None])
    for i, c in zip((0, 3, 6), pr["mask_down"]):
        _put_sam_conv(sd, f"{pp}mask_downscaling.{i}", c)
    for i, (w, b) in zip((1, 4), pr["mask_down_ln"]):
        _put_sam_ln(sd, f"{pp}mask_downscaling.{i}", w, b)

    dp = "sam_mask_decoder."
    dec = params_np["decoder"]
    tf = dec["transformer"]
    for i, lp in enumerate(tf["layers"]):
        lpfx = f"{dp}transformer.layers.{i}."
        _put_sam_attn(sd, lpfx + "self_attn", lp["self_attn"])
        _put_sam_attn(sd, lpfx + "cross_attn_token_to_image", lp["t2i"])
        _put_sam_attn(sd, lpfx + "cross_attn_image_to_token", lp["i2t"])
        _put_sam_lin(sd, lpfx + "mlp.layers.0", lp["mlp1"])
        _put_sam_lin(sd, lpfx + "mlp.layers.1", lp["mlp2"])
        for n in range(1, 5):
            _put_sam_ln(sd, f"{lpfx}norm{n}", lp[f"n{n}w"], lp[f"n{n}b"])
    _put_sam_attn(sd, dp + "transformer.final_attn_token_to_image",
                  tf["final_t2i"])
    _put_sam_ln(sd, dp + "transformer.norm_final_attn", tf["nfw"], tf["nfb"])
    sd[dp + "iou_token.weight"] = _t(dec["iou_token"])
    sd[dp + "mask_tokens.weight"] = _t(dec["mask_tokens"])
    sd[dp + "obj_score_token.weight"] = _t(dec["obj_score_token"])
    _put_sam_convT(sd, dp + "output_upscaling.0", dec["up1"])
    _put_sam_ln(sd, dp + "output_upscaling.1", dec["up_ln_w"],
                dec["up_ln_b"])
    _put_sam_convT(sd, dp + "output_upscaling.3", dec["up2"])
    _put_sam_conv(sd, dp + "conv_s0", dec["conv_s0"])
    _put_sam_conv(sd, dp + "conv_s1", dec["conv_s1"])
    for i, m in enumerate(dec["hyper"]):
        _put_sam_mlp(sd, f"{dp}output_hypernetworks_mlps.{i}", m)
    _put_sam_mlp(sd, dp + "iou_prediction_head", dec["iou_head"])
    _put_sam_mlp(sd, dp + "pred_obj_score_head", dec["obj_score_head"])

    ma = "memory_attention."
    mat = params_np["memory_attention"]
    for i, lp in enumerate(mat["layers"]):
        lpfx = f"{ma}layers.{i}."
        _put_sam_attn(sd, lpfx + "self_attn", lp["self_attn"])
        _put_sam_attn(sd, lpfx + "cross_attn_image", lp["cross_attn"])
        _put_sam_lin(sd, lpfx + "linear1", lp["lin1"])
        _put_sam_lin(sd, lpfx + "linear2", lp["lin2"])
        for n in range(1, 4):
            _put_sam_ln(sd, f"{lpfx}norm{n}", lp[f"n{n}w"], lp[f"n{n}b"])
    _put_sam_ln(sd, ma + "norm", mat["nw"], mat["nb"])

    me = "memory_encoder."
    men = params_np["memory_encoder"]
    md = me + "mask_downsampler.encoder."
    for i, c in zip((0, 3, 6, 9, 12), men["mask_down"]):
        _put_sam_conv(sd, md + str(i), c)
    for i, (w, b) in zip((1, 4, 7, 10), men["mask_down_ln"]):
        _put_sam_ln(sd, md + str(i), w, b)
    _put_sam_conv(sd, me + "pix_feat_proj", men["pix_proj"])
    for i, f in enumerate(men["fuser"]):
        fp = f"{me}fuser.layers.{i}."
        _put_sam_conv(sd, fp + "dwconv", f["dwconv"])
        _put_sam_ln(sd, fp + "norm", f["nw"], f["nb"])
        _put_sam_lin(sd, fp + "pwconv1", f["pw1"])
        _put_sam_lin(sd, fp + "pwconv2", f["pw2"])
        sd[fp + "gamma"] = _t(f["gamma"])
    _put_sam_conv(sd, me + "out_proj", men["out_proj"])

    for k in ("maskmem_tpos_enc", "no_mem_embed", "no_mem_pos_enc",
              "no_obj_ptr", "no_obj_embed_spatial"):
        sd[k] = _t(params_np[k])
    _put_sam_mlp(sd, "obj_ptr_proj", params_np["obj_ptr_proj"])
    _put_sam_lin(sd, "obj_ptr_tpos_proj", params_np["obj_ptr_tpos_proj"])
    return sd


def _put_qwen_lin(sd: StateDict, name: str, p: Dict[str, Any], key: str,
                  bias: bool = True):
    """JAX's ``{key}_w`` [in, out] (or the int8 ``{key}_wq`` / ``{key}_ws``
    of ``quantize_qwen_int8``) and ``{key}_b`` -> ``name``'s Linear (or
    QuantLinear) tensors."""
    if key + "_wq" in p:
        sd[f"{name}.weight_q"] = _t(np.asarray(p[key + "_wq"]).T)
        sd[f"{name}.scale"] = _t(p[key + "_ws"])
    else:
        sd[f"{name}.weight"] = _t(np.asarray(p[key + "_w"]).T)
    if bias and key + "_b" in p:
        sd[f"{name}.bias"] = _t(p[key + "_b"])


def qwen_vl_from_jax(params_np: Dict[str, Any], cfg) -> StateDict:
    """``frameino_tpu.models.qwen_vl`` tree -> the port's ``QwenVL`` names
    (transformers' canonical ones): the patch rows back to the Conv3d
    [E, 3, tp, p, p], dense kernels transposed; an int8 tree's layers ->
    ``QuantLinear`` tensors (load those into a model on which
    ``quantize_qwen_int8`` ran)."""
    v = cfg.vision
    vis = params_np["visual"]
    pw = np.asarray(vis["patch_w"])
    vp = "model.visual."
    sd: StateDict = {
        vp + "patch_embed.proj.weight": _t(pw.T.reshape(
            pw.shape[1], 3, v.temporal_patch_size, v.patch_size,
            v.patch_size)),
        vp + "merger.ln_q.weight": _t(vis["merger_lnq_w"])}
    for i, n in ((0, "1"), (2, "2")):
        sd[f"{vp}merger.mlp.{i}.weight"] = _t(np.asarray(
            vis["merger_w" + n]).T)
        sd[f"{vp}merger.mlp.{i}.bias"] = _t(vis["merger_b" + n])
    for i, bp in enumerate(vis["blocks"]):
        b = f"{vp}blocks.{i}."
        sd[b + "norm1.weight"] = _t(bp["n1w"])
        sd[b + "norm2.weight"] = _t(bp["n2w"])
        _put_qwen_lin(sd, b + "attn.qkv", bp["attn"], "qkv")
        _put_qwen_lin(sd, b + "attn.proj", bp["attn"], "proj")
        for n in ("gate", "up", "down"):
            _put_qwen_lin(sd, f"{b}mlp.{n}_proj", bp["mlp"], n)
    lm = "model.language_model."
    for i, lp in enumerate(params_np["layers"]):
        b = f"{lm}layers.{i}."
        sd[b + "input_layernorm.weight"] = _t(lp["ln1"])
        sd[b + "post_attention_layernorm.weight"] = _t(lp["ln2"])
        for n in ("q", "k", "v", "o"):
            _put_qwen_lin(sd, f"{b}self_attn.{n}_proj", lp, n)
        for n in ("gate", "up", "down"):
            _put_qwen_lin(sd, f"{b}mlp.{n}_proj", lp["mlp"], n)
    sd[lm + "embed_tokens.weight"] = _t(params_np["embed_tokens"])
    sd[lm + "norm.weight"] = _t(params_np["norm_w"])
    sd["lm_head.weight"] = _t(np.asarray(params_np["lm_head"]).T)
    return sd
