"""SAM2.1 video propagation: the memory machinery and the predictor
(counterpart of ``frameino_tpu/models/sam2_video.py``).

The reference's protocol (``evaluation/evaluate_INO_VSeg_MAE.py:160-196``):
point prompts on frame 0, then ``propagate_in_video`` over the clip.

- **RoPE memory attention** (4 layers, single head): the frame's stride-16
  tokens self-attend (axial 2D RoPE) and cross-attend to the memory bank,
  up to ``num_maskmem`` spatial memories (64-d, RoPE tiled per memory) and
  up to 16 object pointers (256-d, each split into four 64-d tokens, sine
  time-position encoded, without RoPE).
- **Memory encoder**: the 16x mask downsampler fused with the projected
  pixel features through two ConvNeXt blocks, projected to 64-d, with the
  2.1 ``no_obj_embed_spatial`` blend on frames without the object.
- **SAM heads** (``forward_sam_heads``): NO_OBJ_SCORE masking, best-IoU
  multimask selection, the object pointer with the no-object blend.
- **Predictor**: the conditioning frame's binarized-mask memory, then
  forward propagation with the reference's memory rule (the conditioning
  frame, the previous ``num_maskmem - 1`` frames, past object pointers).

JAX keeps a fixed-capacity bank (7 slots, 64 pointer tokens) with -1e30
key masking, so that two XLA programs serve every frame; here the bank
holds only the memories that exist, which is the same softmax (a masked
key contributes exp(-1e30) = 0). Resizes are ``F.interpolate(bilinear,
align_corners=False)``, which the JAX module reproduces.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from frameino_tpu_torch.models.sam2 import (SAM21_HIERA_LARGE, LayerNorm2d,
                                            Sam2, Sam2Config, conv_nhwc,
                                            ln2d, sine_pos_embed)

NO_OBJ_SCORE = -1024.0


def bilinear_resize(x, out_hw: Tuple[int, int]):
    """x [B, C, H, W] -> [B, C, out_h, out_w], torch bilinear without
    antialiasing (JAX's ``bilinear_resize_torch``)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


# ---------------------------------------------------------------------------
# Axial 2D RoPE (sam2 compute_axial_cis / apply_rotary_enc)
# ---------------------------------------------------------------------------

def axial_rope_tables(dim: int, end_x: int, end_y: int,
                      theta: float) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) [L, dim // 2]: the first dim // 4 pairs rotate by the x
    coordinate's angles, the next dim // 4 by y (t_x = t % end_x)."""
    n4 = dim // 4
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4,
                                       dtype=np.float32)[:n4] / dim))
    t = np.arange(end_x * end_y, dtype=np.float32)
    fx = np.outer(t % end_x, freqs)
    fy = np.outer(np.floor(t / end_x), freqs)
    ang = np.concatenate([fx, fy], axis=-1)
    return np.cos(ang), np.sin(ang)


def _apply_rope(x, cos, sin):
    """x [..., L, D] with consecutive (even, odd) pairs."""
    e, o = x[..., 0::2], x[..., 1::2]
    return torch.stack([e * cos - o * sin, e * sin + o * cos],
                       dim=-1).reshape(x.shape)


class RoPEAttention(nn.Module):
    """Separate projections; RoPE on q and on the first ``k_cos.shape[0]``
    keys (the spatial memories; the pointer tokens after them pass)."""

    def __init__(self, dim: int, kv_dim: int, **kw):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim, **kw)
        self.k_proj = nn.Linear(kv_dim, dim, **kw)
        self.v_proj = nn.Linear(kv_dim, dim, **kw)
        self.out_proj = nn.Linear(dim, dim, **kw)

    def forward(self, q, k, v, q_cs, k_cs):
        q = _apply_rope(self.q_proj(q)[:, None], *q_cs)
        k = self.k_proj(k)[:, None]
        n = k_cs[0].shape[0]
        k = torch.cat([_apply_rope(k[:, :, :n], *k_cs), k[:, :, n:]], dim=2)
        o = F.scaled_dot_product_attention(q, k, self.v_proj(v)[:, None])
        return self.out_proj(o[:, 0])


class _MemLayer(nn.Module):
    def __init__(self, cfg: Sam2Config, **kw):
        super().__init__()
        C = cfg.d_model
        self.self_attn = RoPEAttention(C, C, **kw)
        self.cross_attn_image = RoPEAttention(C, cfg.mem_dim, **kw)
        self.linear1 = nn.Linear(C, cfg.mem_ffn_dim, **kw)
        self.linear2 = nn.Linear(cfg.mem_ffn_dim, C, **kw)
        for i in range(1, 4):
            setattr(self, f"norm{i}", nn.LayerNorm(C, eps=1e-5, **kw))


class MemoryAttention(nn.Module):
    def __init__(self, cfg: Sam2Config, **kw):
        super().__init__()
        self.layers = nn.ModuleList(_MemLayer(cfg, **kw)
                                    for _ in range(cfg.mem_attn_layers))
        self.norm = nn.LayerNorm(cfg.d_model, eps=1e-5, **kw)

    def forward(self, curr, curr_pos, memory, memory_pos, rope_q, rope_k):
        """curr [B, HW, C]; memory [B, S, mem_dim] (the spatial memories
        first, then the pointer tokens; ``rope_k`` covers the spatial
        ones)."""
        out = curr + 0.1 * curr_pos
        for lp in self.layers:
            t2 = lp.norm1(out)
            out = out + lp.self_attn(t2, t2, t2, rope_q, rope_q)
            t2 = lp.norm2(out)
            out = out + lp.cross_attn_image(t2, memory + memory_pos, memory,
                                            rope_q, rope_k)
            t2 = lp.norm3(out)
            out = out + lp.linear2(F.relu(lp.linear1(t2)))
        return self.norm(out)


# ---------------------------------------------------------------------------
# Memory encoder
# ---------------------------------------------------------------------------

class _MaskDownsampler(nn.Module):
    def __init__(self, cfg: Sam2Config, **kw):
        super().__init__()
        ch = [1, 4, 16, 64, 256]
        layers = []
        for i in range(4):
            layers += [nn.Conv2d(ch[i], ch[i + 1], 3, stride=2, padding=1,
                                 **kw), LayerNorm2d(ch[i + 1], **kw),
                       nn.GELU()]
        layers.append(nn.Conv2d(256, cfg.d_model, 1, **kw))
        self.encoder = nn.Sequential(*layers)


class _CXBlock(nn.Module):
    def __init__(self, C: int, **kw):
        super().__init__()
        self.dwconv = nn.Conv2d(C, C, 7, padding=3, groups=C, **kw)
        self.norm = LayerNorm2d(C, **kw)
        self.pwconv1 = nn.Linear(C, 4 * C, **kw)
        self.pwconv2 = nn.Linear(4 * C, C, **kw)
        self.gamma = nn.Parameter(torch.empty(C, **kw))

    def forward(self, x):
        h = ln2d(conv_nhwc(self.dwconv, x, padding=3), self.norm)
        return x + self.pwconv2(F.gelu(self.pwconv1(h))) * self.gamma


class _Fuser(nn.Module):
    def __init__(self, C: int, **kw):
        super().__init__()
        self.layers = nn.ModuleList(_CXBlock(C, **kw) for _ in range(2))


class MemoryEncoder(nn.Module):
    def __init__(self, cfg: Sam2Config, **kw):
        super().__init__()
        C = cfg.d_model
        self.mask_downsampler = _MaskDownsampler(cfg, **kw)
        self.pix_feat_proj = nn.Conv2d(C, C, 1, **kw)
        self.fuser = _Fuser(C, **kw)
        self.out_proj = nn.Conv2d(C, cfg.mem_dim, 1, **kw)

    def forward(self, pix_feat, mask_for_mem):
        """pix_feat [B, h, w, C] (stride 16, before memory); mask_for_mem
        [B, S, S, 1] (sigmoid or binarized, scaled and biased) -> memory
        features [B, h, w, mem_dim]."""
        enc = self.mask_downsampler.encoder
        x = mask_for_mem
        for i in range(4):
            x = conv_nhwc(enc[3 * i], x, stride=2, padding=1)
            x = F.gelu(ln2d(x, enc[3 * i + 1]))
        x = conv_nhwc(enc[12], x)
        x = conv_nhwc(self.pix_feat_proj, pix_feat) + x
        for blk in self.fuser.layers:
            x = blk(x)
        return conv_nhwc(self.out_proj, x)


def get_1d_sine_pe(pos: np.ndarray, dim: int,
                   temperature: float = 10000.0) -> np.ndarray:
    """sam2_utils.get_1d_sine_pe: [N] -> [N, dim]."""
    half = dim // 2
    dim_t = np.arange(half, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / half)
    pe = np.asarray(pos, np.float32)[..., None] / dim_t
    return np.concatenate([np.sin(pe), np.cos(pe)], axis=-1)


# ---------------------------------------------------------------------------
# SAM heads and new memories (SAM2Base)
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward_sam_heads(model: Sam2, pix_feat_with_mem, high_res_feats,
                      points, labels, multimask_output: bool):
    """pix_feat_with_mem [B, h, w, C]; points [B, N, 2] (image-scale x, y),
    labels [B, N] (-1 = no point). Returns (low_res_masks [B, 1, 4h, 4w],
    high_res_masks [B, 1, S, S], obj_ptr [B, C], object_score_logits
    [B, 1])."""
    cfg = model.cfg
    B, h, w, C = pix_feat_with_mem.shape
    pe = model.sam_prompt_encoder
    sparse = pe.points(points, labels)
    dense = pe.no_mask_embed.weight[0]
    masks, ious, toks, obj_score = model.sam_mask_decoder(
        pix_feat_with_mem + dense, pe.dense_pe(h), sparse, high_res_feats,
        multimask_output)
    is_obj = obj_score > 0                                    # [B, 1]
    masks = torch.where(is_obj[..., None, None], masks,
                        torch.full_like(masks, NO_OBJ_SCORE))
    if multimask_output:
        best = ious.argmax(-1)
        bidx = torch.arange(B, device=masks.device)
        masks = masks[bidx, best][:, None]
        tok = toks[bidx, best]
    else:
        tok = toks[:, 0]
    high_res = bilinear_resize(masks, (cfg.image_size, cfg.image_size))
    obj_ptr = model.obj_ptr_proj(tok)
    lam = is_obj.to(obj_ptr.dtype)
    obj_ptr = lam * obj_ptr + (1.0 - lam) * model.no_obj_ptr
    return masks, high_res, obj_ptr, obj_score


@torch.no_grad()
def encode_new_memory(model: Sam2, pix_feat, high_res_masks,
                      object_score_logits, binarize: bool):
    """SAM2Base._encode_new_memory: high_res_masks [B, 1, S, S] logits ->
    memory features [B, h, w, mem_dim]; ``binarize`` on the point-prompted
    conditioning frame (2.1), sigmoid elsewhere."""
    cfg = model.cfg
    m = high_res_masks.permute(0, 2, 3, 1)
    m = (m > 0).to(m.dtype) if binarize else torch.sigmoid(m)
    m = m * cfg.sigmoid_scale_for_mem_enc + cfg.sigmoid_bias_for_mem_enc
    mem = model.memory_encoder(pix_feat, m)
    is_obj = (object_score_logits > 0).to(mem.dtype)          # [B, 1]
    return mem + (1.0 - is_obj[:, :, None, None]) \
        * model.no_obj_embed_spatial[None]


# ---------------------------------------------------------------------------
# Video predictor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _FrameOutput:
    mem: torch.Tensor           # [HW, mem_dim] spatial memory
    obj_ptr: torch.Tensor       # [C]
    low_res_mask: torch.Tensor  # [1, hq, wq] logits


class Sam2VideoPredictor:
    """Single-object propagation with the reference's protocol:
    ``init_state`` -> ``add_new_points(frame 0)`` -> ``propagate_in_video``
    (video-resolution mask logits per frame, the conditioning frame
    included)."""

    IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
    IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

    def __init__(self, model: Sam2):
        cfg = model.cfg
        self.model = model
        self.cfg = cfg
        p = model.no_mem_embed
        self.device, self.dtype = p.device, p.dtype
        g = cfg.image_size // 16
        self.grid = g
        self.hw = g * g
        self.ptr_split = cfg.d_model // cfg.mem_dim

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device).to(self.dtype)
        self.curr_pos = t(sine_pos_embed(g, g, cfg.d_model)).reshape(
            1, self.hw, cfg.d_model)
        self.maskmem_pos = t(sine_pos_embed(g, g, cfg.mem_dim)).reshape(
            self.hw, cfg.mem_dim)
        cos, sin = axial_rope_tables(cfg.d_model, g, g, cfg.rope_theta)
        self.rope = (t(cos), t(sin))
        trunk_grid = cfg.image_size // 4
        with torch.no_grad():
            self.hiera_pe = model.image_encoder.trunk.pos_embed_for(
                (trunk_grid, trunk_grid))

    def init_state(self, frames: np.ndarray) -> Dict:
        """frames [T, H, W, 3] uint8 RGB."""
        import cv2
        T, H, W = frames.shape[:3]
        s = self.cfg.image_size
        imgs = np.stack([cv2.resize(f, (s, s),
                                    interpolation=cv2.INTER_LINEAR)
                         for f in frames])
        imgs = (imgs.astype(np.float32) / 255.0 - self.IMAGENET_MEAN) \
            / self.IMAGENET_STD
        return {"imgs": torch.from_numpy(imgs).permute(0, 3, 1, 2),
                "orig_hw": (H, W), "num_frames": T, "cond": {},
                "non_cond": {}}

    def _features(self, state, t):
        img = state["imgs"][t][None].to(self.device, self.dtype)
        feats, _ = self.model.encode_image(img, self.hiera_pe)
        return feats

    def _record(self, state, kind, t, s2, low, high, ptr, score,
                binarize: bool):
        mem = encode_new_memory(self.model, s2, high, score, binarize)
        state[kind][t] = _FrameOutput(
            mem=mem.reshape(self.hw, self.cfg.mem_dim), obj_ptr=ptr[0],
            low_res_mask=low[0])

    @torch.no_grad()
    def add_new_points(self, state: Dict, frame_idx: int,
                       points: np.ndarray, labels: np.ndarray):
        """points [N, 2] (x, y) in video pixels; labels [N] {1 pos, 0 neg}.
        Returns the video-resolution mask logits [H, W]."""
        H, W = state["orig_hw"]
        s = self.cfg.image_size
        pts = np.asarray(points, np.float32) * np.asarray([s / W, s / H],
                                                          np.float32)
        s0, s1, s2 = self._features(state, frame_idx)
        B = s2.shape[0]
        pix = s2 + self.model.no_mem_embed.reshape(1, 1, 1, -1)
        low, high, ptr, score = forward_sam_heads(
            self.model, pix.reshape(B, self.grid, self.grid, -1), (s0, s1),
            torch.from_numpy(pts[None]).to(self.device, self.dtype),
            torch.as_tensor(np.asarray(labels, np.int64)[None],
                            device=self.device), multimask_output=True)
        self._record(state, "cond", frame_idx, s2, low, high, ptr, score,
                     binarize=True)
        return bilinear_resize(high, (H, W))[0, 0]

    def _build_memory(self, state: Dict, t: int):
        """The reference's memory rule (stride 1): the conditioning frame
        and up to num_maskmem - 1 previous frames, then the past object
        pointers. Returns (memory, memory_pos [1, S, mem_dim], number of
        spatial memories)."""
        cfg = self.cfg
        n_slots = cfg.num_maskmem
        tpos = self.model.maskmem_tpos_enc[:, 0, 0, :]     # [slots, M]
        entries = [(0, out) for ct, out in state["cond"].items() if ct <= t]
        for t_pos in range(1, n_slots):
            out = state["non_cond"].get(t - (n_slots - t_pos))
            if out is not None:
                entries.append((t_pos, out))
        mem = [out.mem for _, out in entries]
        pos = [self.maskmem_pos + tpos[n_slots - t_pos - 1]
               for t_pos, _ in entries]
        ptrs, t_diffs = [], []
        max_ptrs = min(state["num_frames"], cfg.max_obj_ptrs_in_encoder)
        for ct, out in state["cond"].items():
            if ct <= t:
                ptrs.append(out.obj_ptr)
                t_diffs.append(t - ct)
        for t_diff in range(1, max_ptrs):
            prev = t - t_diff
            if prev < 0:
                break
            out = state["non_cond"].get(prev)
            if out is not None:
                ptrs.append(out.obj_ptr)
                t_diffs.append(t_diff)
        if ptrs:
            pe = get_1d_sine_pe(np.asarray(t_diffs, np.float32)
                                / max(max_ptrs - 1, 1), cfg.d_model)
            pe = self.model.obj_ptr_tpos_proj(
                torch.from_numpy(pe).to(self.device, self.dtype))
            mem.append(torch.stack(ptrs).reshape(
                len(ptrs) * self.ptr_split, cfg.mem_dim))
            pos.append(pe.repeat_interleave(self.ptr_split, dim=0))
        return (torch.cat(mem)[None], torch.cat(pos)[None], len(entries))

    @torch.no_grad()
    def _propagate_step(self, state, t):
        cfg = self.cfg
        s0, s1, s2 = self._features(state, t)
        B = s2.shape[0]
        memory, memory_pos, n_spatial = self._build_memory(state, t)
        rope_k = tuple(r.repeat(n_spatial, 1) for r in self.rope)
        out = self.model.memory_attention(
            s2.reshape(B, self.hw, cfg.d_model), self.curr_pos, memory,
            memory_pos, self.rope, rope_k)
        pts = torch.zeros((B, 1, 2), device=self.device, dtype=self.dtype)
        lbl = -torch.ones((B, 1), device=self.device, dtype=torch.int64)
        low, high, ptr, score = forward_sam_heads(
            self.model, out.reshape(B, self.grid, self.grid, cfg.d_model),
            (s0, s1), pts, lbl, multimask_output=True)
        self._record(state, "non_cond", t, s2, low, high, ptr, score,
                     binarize=False)
        return high

    @torch.no_grad()
    def propagate_in_video(self, state: Dict, start_frame_idx: int = 0
                           ) -> Iterator[Tuple[int, torch.Tensor]]:
        """Yields (frame_idx, video-resolution mask logits [H, W]) for every
        frame from the conditioning frame on."""
        H, W = state["orig_hw"]
        assert state["cond"], "add_new_points first"
        s = self.cfg.image_size
        for t in range(max(start_frame_idx, min(state["cond"])),
                       state["num_frames"]):
            if t in state["cond"]:
                high = bilinear_resize(state["cond"][t].low_res_mask[None],
                                       (s, s))
            else:
                high = self._propagate_step(state, t)
            yield t, bilinear_resize(high, (H, W))[0, 0]


def load_sam2_torch(checkpoint_path: str, cfg: Sam2Config = None,
                    device: str = "cuda"):
    """The released SAM2.1 weights (``.pt``, its ``model`` dict, or
    ``.safetensors``) as the ``segment(frames, queries)`` adapter. The
    checkpoint's ``mask_downsample`` (a conv the video API does not run) is
    ignored, as in JAX; any other key must match."""
    from frameino_tpu_torch.models.weights import read_checkpoint
    cfg = cfg or SAM21_HIERA_LARGE
    sd = read_checkpoint(checkpoint_path)
    for k in ("mask_downsample.weight", "mask_downsample.bias"):
        sd.pop(k, None)
    m = Sam2(cfg, device="meta")
    m.load_state_dict(sd, strict=True, assign=True)
    return make_segmenter_adapter(m.to(device).eval())


def make_segmenter_adapter(model: Sam2):
    """``segment(frames [T, H, W, 3] uint8, queries [N, 2] xy on frame 0)
    -> [T, H, W] uint8 {0, 1}`` masks (logits thresholded at 0, as the
    reference's ``evaluate_INO_VSeg_MAE.py``)."""
    predictor = Sam2VideoPredictor(model)

    def segment(frames: np.ndarray, queries: np.ndarray) -> np.ndarray:
        state = predictor.init_state(frames)
        pts = np.asarray(queries, np.float32)
        predictor.add_new_points(state, 0, pts,
                                 np.ones((len(pts),), np.int32))
        masks = {t: (m > 0).to(torch.uint8).cpu().numpy()
                 for t, m in predictor.propagate_in_video(state)}
        blank = np.zeros(frames.shape[1:3], np.uint8)
        return np.stack([masks.get(t, blank)
                         for t in range(frames.shape[0])])

    return segment
