"""VGGT4Track camera estimation, the curation step-5 3D camera tracker
(counterpart of ``frameino_tpu/models/vggt.py``; the reference's
``preprocess/SpaTrackV2_code/models/vggt4track/``, driven by
``preprocess/track_camera_pose_spatracker2.py:35-64``).

Inference graph (camera path only, as JAX):

  DINOv2 ViT-L/14-reg patch embed -> Aggregator: 24 alternating
  frame/global attention pairs over [camera; 4 registers; patches] tokens
  with per-head qk LayerNorm, LayerScale and 2D half-split RoPE (freq 100)
  -> CameraHead: 4-iteration AdaLN-modulated trunk refining a 9-dim
  absT_quaR_FoV encoding -> extrinsics/intrinsics -> camera-to-world poses.

The forward computes from a flat state dict under the released
VGGT4Track names (``aggregator.*``, ``camera_head.*``; the depth and track
heads are not read), listed by ``vggt_param_table``. Every attention
(24 ViT + 24 frame + 24 global + 16 camera-trunk calls a clip) goes through
``ops/attention.flash_attention_inference``, K3 on the card, which takes
bf16: ``_bf16_attention`` casts q, k and v to bf16 at that call and the
rest stays fp32, as in JAX (ROADMAP queue 3 records the difference).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from frameino_tpu_torch.models.param_table import ParamTable
from frameino_tpu_torch.ops.attention import flash_attention_inference
from frameino_tpu_torch.ops.resize import resize_antialiased


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24               # aggregator frame/global pairs
    num_heads: int = 16
    vit_depth: int = 24           # DINOv2 patch-embed ViT
    vit_heads: int = 16
    num_register_tokens: int = 4  # both the ViT's and the aggregator's
    mlp_ratio: float = 4.0
    rope_freq: float = 100.0
    cam_trunk_depth: int = 4
    cam_iterations: int = 4
    eps: float = 1e-6


VGGT_1B = VGGTConfig()


def tiny_vggt_config() -> VGGTConfig:
    return VGGTConfig(img_size=8, patch_size=2, embed_dim=16, depth=2,
                      num_heads=2, vit_depth=2, vit_heads=2,
                      num_register_tokens=1, cam_trunk_depth=2,
                      cam_iterations=2)


RESNET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
RESNET_STD = np.array([0.229, 0.224, 0.225], np.float32)
A = "aggregator"
CH = "camera_head"


def _block_table(t: ParamTable, name, path, C, heads, mlp_ratio, ls_init,
                 qk_norm):
    hidden = int(C * mlp_ratio)
    t.norm(f"{name}.norm1", C, (*path, "norm1"))
    t.linear(f"{name}.attn.qkv", C, 3 * C, (*path, "attn", "qkv"))
    t.linear(f"{name}.attn.proj", C, C, (*path, "attn", "proj"))
    if qk_norm:
        t.norm(f"{name}.attn.q_norm", C // heads, (*path, "attn", "q_norm"))
        t.norm(f"{name}.attn.k_norm", C // heads, (*path, "attn", "k_norm"))
    t.add(f"{name}.ls1.gamma", (C,), "const", (*path, "ls1"), scale=ls_init)
    t.norm(f"{name}.norm2", C, (*path, "norm2"))
    t.linear(f"{name}.mlp.fc1", C, hidden, (*path, "mlp", "fc1"))
    t.linear(f"{name}.mlp.fc2", hidden, C, (*path, "mlp", "fc2"))
    t.add(f"{name}.ls2.gamma", (C,), "const", (*path, "ls2"), scale=ls_init)


def vggt_param_table(cfg: VGGTConfig = VGGT_1B) -> ParamTable:
    """Every released name of the camera path, with its shape and its path
    in JAX's unstacked tree (``init_vggt``; ``vggt_from_jax`` unstacks the
    scanned form ``vggt_from_state_dict`` gives)."""
    t = ParamTable()
    C, ps = cfg.embed_dim, cfg.patch_size
    pe, vp = f"{A}.patch_embed", ("aggregator", "patch_embed")
    n_patches = (cfg.img_size // ps) ** 2
    t.add(f"{pe}.patch_embed.proj.weight", (C, 3, ps, ps), "normal",
          (*vp, "proj", "w"), "conv")
    t.add(f"{pe}.patch_embed.proj.bias", (C,), "zeros", (*vp, "proj", "b"))
    t.add(f"{pe}.cls_token", (1, 1, C), "normal", (*vp, "cls_token"),
          scale=1e-3)
    t.add(f"{pe}.pos_embed", (1, n_patches + 1, C), "normal",
          (*vp, "pos_embed"), scale=0.02)
    t.add(f"{pe}.register_tokens", (1, cfg.num_register_tokens, C),
          "normal", (*vp, "register_tokens"), scale=1e-3)
    for i in range(cfg.vit_depth):
        _block_table(t, f"{pe}.blocks.{i}", (*vp, f"block{i}"), C,
                     cfg.vit_heads, cfg.mlp_ratio, 1.0, False)
    t.norm(f"{pe}.norm", C, (*vp, "norm"))
    t.add(f"{A}.camera_token", (1, 2, 1, C), "normal",
          ("aggregator", "camera_token"), scale=1e-3)
    t.add(f"{A}.register_token", (1, 2, cfg.num_register_tokens, C),
          "normal", ("aggregator", "register_token"), scale=1e-3)
    for i in range(cfg.depth):
        _block_table(t, f"{A}.frame_blocks.{i}", ("aggregator", f"frame{i}"),
                     C, cfg.num_heads, cfg.mlp_ratio, 0.01, True)
        _block_table(t, f"{A}.global_blocks.{i}",
                     ("aggregator", f"global{i}"), C, cfg.num_heads,
                     cfg.mlp_ratio, 0.01, True)
    C2, cp = 2 * C, ("camera_head",)
    t.norm(f"{CH}.token_norm", C2, (*cp, "token_norm"))
    t.norm(f"{CH}.trunk_norm", C2, (*cp, "trunk_norm"))
    t.add(f"{CH}.empty_pose_tokens", (1, 1, 9), "zeros",
          (*cp, "empty_pose_tokens"))
    t.linear(f"{CH}.embed_pose", 9, C2, (*cp, "embed_pose"))
    t.linear(f"{CH}.poseLN_modulation.1", C2, 3 * C2,
             (*cp, "poseLN_modulation"))
    t.linear(f"{CH}.pose_branch.fc1", C2, C2 // 2, (*cp, "pose_branch", "fc1"))
    t.linear(f"{CH}.pose_branch.fc2", C2 // 2, 9, (*cp, "pose_branch", "fc2"))
    for i in range(cfg.cam_trunk_depth):
        _block_table(t, f"{CH}.trunk.{i}", (*cp, f"trunk{i}"), C2,
                     cfg.num_heads, cfg.mlp_ratio, 0.01, False)
    return t


def vggt_from_jax(params, cfg: VGGTConfig = VGGT_1B):
    """A JAX VGGT tree, unstacked (``init_vggt``) or with the aggregator's
    leading pairs stacked for ``lax.scan`` (``vggt_from_state_dict``) ->
    the released state dict."""
    agg = dict(params["aggregator"])
    for kind in ("frame", "global"):
        stack = agg.pop(f"{kind}_stack", None)
        if stack is None:
            continue
        for i in range(cfg.depth - 1):
            agg[f"{kind}{i}"] = _index_tree(stack, i)
    return vggt_param_table(cfg).from_jax(dict(params, aggregator=agg))


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def init_vggt(cfg: VGGTConfig, generator: torch.Generator,
              dtype: torch.dtype = torch.float32):
    """Seeded random weights under the released names on the generator's
    device, at JAX's ``init_vggt`` scales."""
    return vggt_param_table(cfg).draw(generator, dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _ln(sd, name, x, eps=1e-6):
    w = None if name is None else sd[f"{name}.weight"]
    b = None if name is None else sd[f"{name}.bias"]
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def _lin(sd, name, x):
    return F.linear(x, sd[f"{name}.weight"], sd[f"{name}.bias"])


def _mlp(sd, name, x):
    return _lin(sd, f"{name}.fc2", F.gelu(_lin(sd, f"{name}.fc1", x)))


def _bf16_attention(q, k, v):
    """K3 on q, k, v cast to bf16 (the kernel's only type); the output
    back in q's type."""
    bf16 = torch.bfloat16
    return flash_attention_inference(q.to(bf16), k.to(bf16),
                                     v.to(bf16)).to(q.dtype)


def _attention(sd, name, x, nheads: int, rope=None, eps=1e-6,
               qk_norm: bool = False):
    """timm/DINOv2 Attention (``layers/attention.py:20-86``). x: [B, N, C];
    rope: (cos, sin) [N, head_dim/2] or None. The product is
    ``_bf16_attention``."""
    B, N, C = x.shape
    d = C // nheads
    qkv = _lin(sd, f"{name}.qkv", x).reshape(B, N, 3, nheads, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    if qk_norm:
        q = _ln(sd, f"{name}.q_norm", q, eps)
        k = _ln(sd, f"{name}.k_norm", k, eps)
    if rope is not None:
        q = _rope2d_apply(q, *rope)
        k = _rope2d_apply(k, *rope)
    o = _bf16_attention(q, k, v)
    return _lin(sd, f"{name}.proj", o.transpose(1, 2).reshape(B, N, C))


def _block(sd, name, x, nheads: int, rope=None, qk_norm=False, eps=1e-6):
    """Pre-norm block with LayerScale (``layers/block.py:27-110``)."""
    h = _attention(sd, f"{name}.attn", _ln(sd, f"{name}.norm1", x, eps),
                   nheads, rope=rope, eps=eps, qk_norm=qk_norm)
    x = x + h * sd[f"{name}.ls1.gamma"]
    h = _mlp(sd, f"{name}.mlp", _ln(sd, f"{name}.norm2", x, eps))
    return x + h * sd[f"{name}.ls2.gamma"]


# ---------------------------------------------------------------------------
# 2D RoPE (``layers/rope.py``): half-split rotation per spatial axis,
# vertical on the first feature half, horizontal on the second
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def rope2d_tables(head_dim: int, gh: int, gw: int, n_special: int,
                  freq: float = 100.0) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin [n_special + gh*gw, head_dim/2] for the token layout
    [special (pos 0); patches (pos 1..)]; each axis uses head_dim/2 dims
    with angles duplicated (``rope.py:100-117``)."""
    dim = head_dim // 2
    exponents = np.arange(0, dim, 2, dtype=np.float64) / dim
    inv_freq = 1.0 / (freq ** exponents)
    ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    pos_y = np.concatenate([np.zeros(n_special), ys.ravel() + 1])
    pos_x = np.concatenate([np.zeros(n_special), xs.ravel() + 1])

    def tab(pos):
        ang = pos[:, None] * inv_freq[None, :]
        ang = np.concatenate([ang, ang], axis=-1)
        return np.cos(ang), np.sin(ang)

    (cy, sy), (cx, sx) = tab(pos_y), tab(pos_x)
    return (np.concatenate([cy, cx], -1).astype(np.float32),
            np.concatenate([sy, sx], -1).astype(np.float32))


def _rotate_half(x):
    d = x.shape[-1]
    return torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)


def _rope2d_apply(x, cos, sin):
    """x: [B, H, N, D]; cos/sin [N, D/2] laid out [vertical half,
    horizontal half] as the features are split."""
    D = x.shape[-1]
    half = cos.shape[-1] // 2
    xf = x.float()
    xv, xh = xf[..., :D // 2], xf[..., D // 2:]
    ov = xv * cos[:, :half] + _rotate_half(xv) * sin[:, :half]
    oh = xh * cos[:, half:] + _rotate_half(xh) * sin[:, half:]
    return torch.cat([ov, oh], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# DINOv2 patch embed ViT
# ---------------------------------------------------------------------------

def _interp_pos_embed(pos_embed, gh: int, gw: int):
    """Keys-cubic pos-embed resize with ``jax.image.resize``'s antialias
    (``vision_transformer.py:183-215``, as JAX resizes it)."""
    n = pos_embed.shape[1] - 1
    m = int(math.sqrt(n))
    if gh == gw == m:
        return pos_embed
    patch = pos_embed[:, 1:].reshape(1, m, m, -1)
    patch = resize_antialiased(patch, (1, gh, gw, patch.shape[-1]), "cubic")
    return torch.cat([pos_embed[:, :1], patch.reshape(1, gh * gw, -1)], 1)


def dino_vit_forward(cfg: VGGTConfig, sd, images):
    """images: [N, H, W, 3] (resnet-normalized). Returns
    x_norm_patchtokens [N, gh*gw, C]
    (``layers/vision_transformer.py:217-261``)."""
    N = images.shape[0]
    pe = f"{A}.patch_embed"
    x = F.conv2d(images.permute(0, 3, 1, 2),
                 sd[f"{pe}.patch_embed.proj.weight"],
                 sd[f"{pe}.patch_embed.proj.bias"], stride=cfg.patch_size)
    gh, gw = x.shape[2], x.shape[3]
    x = x.flatten(2).transpose(1, 2)
    cls = sd[f"{pe}.cls_token"].expand(N, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    x = x + _interp_pos_embed(sd[f"{pe}.pos_embed"], gh, gw)
    if cfg.num_register_tokens:
        reg = sd[f"{pe}.register_tokens"].expand(
            N, cfg.num_register_tokens, cfg.embed_dim)
        x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)
    for i in range(cfg.vit_depth):
        x = _block(sd, f"{pe}.blocks.{i}", x, cfg.vit_heads)
    x = _ln(sd, f"{pe}.norm", x)
    return x[:, cfg.num_register_tokens + 1:]


# ---------------------------------------------------------------------------
# Aggregator
# ---------------------------------------------------------------------------

def _slice_expand(token, S):
    """(1, 2, X, C) -> (S, X, C): the first-frame variant at index 0, the
    rest-frames variant for frames 1..S-1 (``aggregator.py:316-337``)."""
    return torch.cat([token[:, 0], token[:, 1].expand(S - 1,
                                                      *token.shape[2:])], 0)


def aggregator_forward(cfg: VGGTConfig, sd, images):
    """images: [B, S, H, W, 3] in [0, 1]. Returns the camera head's input:
    cat([frame_out, global_out], -1)[..., token 0, :] of the LAST pair,
    [B, S, 2C] (``aggregator.py:188-290``)."""
    B, S, H, W, _ = images.shape
    dev = images.device
    mean = torch.from_numpy(RESNET_MEAN).to(dev)
    std = torch.from_numpy(RESNET_STD).to(dev)
    x = (images - mean) / std
    patch_tokens = dino_vit_forward(cfg, sd, x.reshape(B * S, H, W, 3))
    C = cfg.embed_dim
    special = torch.cat([_slice_expand(sd[f"{A}.camera_token"], S),
                         _slice_expand(sd[f"{A}.register_token"], S)], 1)
    special = special[None].expand(B, *special.shape).reshape(B * S, -1, C)
    tokens = torch.cat([special, patch_tokens], dim=1)
    P = tokens.shape[1]
    n_special = 1 + cfg.num_register_tokens
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    cos_np, sin_np = rope2d_tables(C // cfg.num_heads, gh, gw, n_special,
                                   cfg.rope_freq)
    cos, sin = (torch.from_numpy(a).to(dev) for a in (cos_np, sin_np))
    rope_g = (cos.repeat(S, 1), sin.repeat(S, 1))
    tokens = tokens.reshape(B, S, P, C)
    for i in range(cfg.depth):
        t = _block(sd, f"{A}.frame_blocks.{i}", tokens.reshape(B * S, P, C),
                   cfg.num_heads, rope=(cos, sin), qk_norm=True, eps=cfg.eps)
        frame_out = t.reshape(B, S, P, C)
        t = _block(sd, f"{A}.global_blocks.{i}",
                   frame_out.reshape(B, S * P, C), cfg.num_heads,
                   rope=rope_g, qk_norm=True, eps=cfg.eps)
        tokens = t.reshape(B, S, P, C)
    # the camera head reads the last pair's frame and global outputs
    return torch.cat([frame_out[:, :, 0], tokens[:, :, 0]], dim=-1)


# ---------------------------------------------------------------------------
# Camera head
# ---------------------------------------------------------------------------

def camera_head_forward(cfg: VGGTConfig, sd, pose_tokens):
    """pose_tokens: [B, S, 2C]. Returns the activated pose encoding
    [B, S, 9] (``heads/camera_head.py:85-160``)."""
    t = _ln(sd, f"{CH}.token_norm", pose_tokens, 1e-5)
    pred = None
    for _ in range(cfg.cam_iterations):
        inp = (sd[f"{CH}.empty_pose_tokens"].expand(*t.shape[:2], 9)
               if pred is None else pred)
        mod = _lin(sd, f"{CH}.poseLN_modulation.1",
                   F.silu(_lin(sd, f"{CH}.embed_pose", inp)))
        shift, scale, gate = mod.chunk(3, dim=-1)
        h = gate * (_ln(sd, None, t, 1e-6) * (1 + scale) + shift) + t
        for i in range(cfg.cam_trunk_depth):
            h = _block(sd, f"{CH}.trunk.{i}", h, cfg.num_heads, eps=1e-6)
        delta = _lin(sd, f"{CH}.pose_branch.fc2", F.gelu(
            _lin(sd, f"{CH}.pose_branch.fc1",
                 _ln(sd, f"{CH}.trunk_norm", h, 1e-5))))
        pred = delta if pred is None else pred + delta
    # activate_pose: trans/quat linear, fov relu (``head_act.py``)
    return torch.cat([pred[..., :7], F.relu(pred[..., 7:])], dim=-1)


def quat_to_mat(q):
    """XYZW (scalar-last) quaternion -> rotation matrix
    (``utils/rotation.py:14-44``)."""
    i, j, k, r = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / (q * q).sum(-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j)], dim=-1)
    return o.reshape(q.shape[:-1] + (3, 3))


def pose_encoding_to_extri_intri(pose_enc, hw):
    """[..., 9] absT_quaR_FoV -> (extrinsics [..., 3, 4] camera-from-world,
    intrinsics [..., 3, 3]) (``utils/pose_enc.py:65-130``)."""
    T = pose_enc[..., :3]
    R = quat_to_mat(pose_enc[..., 3:7])
    fov_h, fov_w = pose_enc[..., 7], pose_enc[..., 8]
    extr = torch.cat([R, T[..., None]], dim=-1)
    H, W = hw
    fy = (H / 2.0) / torch.tan(fov_h / 2.0)
    fx = (W / 2.0) / torch.tan(fov_w / 2.0)
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    intr = torch.stack([
        torch.stack([fx, z, torch.full_like(fx, W / 2.0)], -1),
        torch.stack([z, fy, torch.full_like(fy, H / 2.0)], -1),
        torch.stack([z, z, o], -1)], dim=-2)
    return extr, intr


@torch.no_grad()
def vggt_camera_forward(cfg: VGGTConfig, sd, images):
    """images: [B, S, H, W, 3] in [0, 1] (preprocessed to /14 dims).
    Returns (poses_c2w [B, S, 4, 4], intrinsics [B, S, 3, 3])
    (``vggt_moe.py:90-96``)."""
    pose_tokens = aggregator_forward(cfg, sd, images)
    pose_enc = camera_head_forward(cfg, sd, pose_tokens)
    extr, intr = pose_encoding_to_extri_intri(pose_enc, images.shape[2:4])
    B, S = extr.shape[:2]
    bottom = torch.tensor([0.0, 0, 0, 1], device=images.device).expand(
        B, S, 1, 4)
    w2c = torch.cat([extr, bottom], dim=-2)
    return torch.linalg.inv(w2c), intr


# ---------------------------------------------------------------------------
# Curation adapter
# ---------------------------------------------------------------------------

def preprocess_frames(frames: np.ndarray, target: int = 518) -> np.ndarray:
    """uint8 [T, H, W, 3] -> float [T, H', W', 3] in [0, 1], crop mode:
    width -> target (x14), height scaled (x14) then center-cropped to
    <= target (``utils/load_fn.py:148-220``)."""
    import cv2
    T, H, W = frames.shape[:3]
    new_w = target
    new_h = round(H * (new_w / W) / 14) * 14
    out = np.stack([cv2.resize(f, (new_w, new_h),
                               interpolation=cv2.INTER_CUBIC)
                    for f in frames])
    if new_h > target:
        start = (new_h - target) // 2
        out = out[:, start:start + target]
    return out.astype(np.float32) / 255.0


def make_camera_estimator(cfg: VGGTConfig, sd):
    """``estimate(frames_uint8 [T, H, W, 3]) -> camera_info``, the
    SpaTrackV2 dict (rotation / translation / focal_x / focal_y) that
    ``preprocess.camera_pose.calculate_camera_motion`` scores, on the
    device of ``sd``."""
    dev = next(iter(sd.values())).device

    def estimate(frames: np.ndarray) -> Dict:
        imgs = torch.from_numpy(preprocess_frames(frames)[None]).to(dev)
        poses, intrs = vggt_camera_forward(cfg, sd, imgs)
        poses = poses[0].cpu().numpy()
        intrs = intrs[0].cpu().numpy()
        return {"rotation": poses[:, :3, :3].tolist(),
                "translation": poses[:, :3, 3].tolist(),
                "focal_x": intrs[:, 0, 0].tolist(),
                "focal_y": intrs[:, 1, 1].tolist()}

    return estimate


def load_vggt_camera(checkpoint_path: str, cfg: VGGTConfig = VGGT_1B,
                     device: str = "cuda"):
    """Released VGGT4Track weights (``.pt``, with or without a ``model`` /
    ``state_dict`` wrapper, or ``.safetensors``) on ``device`` -> the
    ``camera_estimator(frames_uint8) -> camera_info`` callable
    (``track_camera_pose_spatracker2.py:46-70``). Keys of other heads are
    ignored; a missing camera-path key raises."""
    import os
    if not os.path.exists(checkpoint_path):
        raise FileNotFoundError(f"no VGGT checkpoint at {checkpoint_path}")
    if checkpoint_path.endswith(".safetensors"):
        from frameino_tpu_torch.models.weights import load_safetensors_dir
        sd = load_safetensors_dir(checkpoint_path)
    else:
        sd = torch.load(checkpoint_path, map_location="cpu",
                        weights_only=True)
        for key in ("model", "state_dict"):
            if isinstance(sd, dict) and key in sd:
                sd = sd[key]
                break
    sd = vggt_param_table(cfg).take(sd, "VGGT")
    sd = {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}
    return make_camera_estimator(cfg, sd)
