"""OneFormer (COCO-133 panoptic, Swin-L), the curation segmenter
(counterpart of ``frameino_tpu/models/oneformer.py``; the reference runs it
in ``preprocess/filter_panoptic_multi.py:133-218`` as the step-4 panoptic
model).

Inference graph (``oneformer_model.py:247-320``):
  Swin backbone (``models/swin.py``) -> MSDeformAttn pixel decoder
  (6-layer deformable encoder over res3/4/5 + FPN lateral to res2 ->
  mask_features) -> task-conditioned transformer decoder (2-layer DETR
  "class" transformer seeding 149 queries from the task token + 9
  masked-attention layers) -> class logits [Q, 134] + mask logits
  [Q, H/4, W/4] -> panoptic fusion (host-side numpy).

The forward computes from a flat state dict under the released detectron2
names (``backbone.*``, ``sem_seg_head.pixel_decoder.*``,
``sem_seg_head.predictor.*``, ``task_mlp.layers.{0,1}.*``), so a released
checkpoint's ``"model"`` dict is the model; ``oneformer_param_table`` lists
those names with their shapes and the JAX tree's paths (the bridge both
ways with JAX's ``oneformer_from_state_dict``). The deformable sampling of
the six encoder layers is K13 (``ops/ms_deform_attn``, CUDA C++ on the
card); the rest is plain torch, as it is XLA in JAX. Downsampling resizes
go through ``ops/resize``, ``jax.image.resize``'s antialiased weights.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from frameino_tpu_torch.models.param_table import ParamTable
from frameino_tpu_torch.models.swin import (SWIN_L, SwinConfig,
                                            swin_forward, swin_param_table)
from frameino_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from frameino_tpu_torch.ops.resize import resize_antialiased


@dataclasses.dataclass(frozen=True)
class OneFormerConfig:
    swin: SwinConfig = SWIN_L
    num_classes: int = 133
    hidden_dim: int = 256
    num_queries: int = 150
    nheads: int = 8
    dim_feedforward: int = 2048
    enc_ffn_dim: int = 1024        # deformable encoder FFN
    enc_layers: int = 6
    dec_layers: int = 9            # DEC_LAYERS 10 - 1
    class_dec_layers: int = 2
    enc_points: int = 4
    mask_dim: int = 256
    task_seq_len: int = 77
    size_divisibility: int = 32
    layer_norm_eps: float = 1e-5


ONEFORMER_COCO_SWIN_L = OneFormerConfig()

# CLIP-BPE ids of the three task strings (sot ... eot; zero-padded to
# task_seq_len): constants, the strings are fixed ("The task is {x}")
TASK_TOKEN_IDS = {
    "panoptic": [49406, 518, 10549, 533, 1072, 24755, 49407],
    "instance": [49406, 518, 10549, 533, 34572, 49407],
    "semantic": [49406, 518, 10549, 533, 29119, 1550, 49407],
}

PD = "sem_seg_head.pixel_decoder"
PRED = "sem_seg_head.predictor"


def task_tokens(task: str, seq_len: int = 77) -> np.ndarray:
    ids = TASK_TOKEN_IDS[task]
    out = np.zeros((seq_len,), np.float32)
    out[:len(ids)] = ids
    return out


def oneformer_param_table(cfg: OneFormerConfig = ONEFORMER_COCO_SWIN_L
                          ) -> ParamTable:
    """Every released name the inference graph reads, with its shape and
    its path in JAX's tree (``oneformer_from_state_dict``, ``:517``)."""
    t = swin_param_table(cfg.swin, "backbone.", ("backbone",))
    C = cfg.hidden_dim
    L, P, nh = 3, cfg.enc_points, cfg.nheads
    pd = ("pixel_decoder",)
    t.add(f"{PD}.transformer.level_embed", (3, C), "normal",
          (*pd, "level_embed"))
    t.conv(f"{PD}.mask_features", C, cfg.mask_dim, 1, (*pd, "mask_features"))
    swin_dims = [cfg.swin.embed_dim * 2 ** i for i in range(4)]
    t.conv(f"{PD}.adapter_1", swin_dims[0], C, 1, (*pd, "adapter1", "conv"),
           bias=False)
    t.norm(f"{PD}.adapter_1.norm", C, (*pd, "adapter1", "gn"))
    t.conv(f"{PD}.layer_1", C, C, 3, (*pd, "layer1", "conv"), bias=False)
    t.norm(f"{PD}.layer_1.norm", C, (*pd, "layer1", "gn"))
    for i, d in enumerate([swin_dims[3], swin_dims[2], swin_dims[1]]):
        t.conv(f"{PD}.input_proj.{i}.0", d, C, 1,
               (*pd, f"input_proj{i}", "conv"))
        t.norm(f"{PD}.input_proj.{i}.1", C, (*pd, f"input_proj{i}", "gn"))
    for i in range(cfg.enc_layers):
        b = f"{PD}.transformer.encoder.layers.{i}"
        p = (*pd, f"enc_layer{i}")
        t.linear(f"{b}.self_attn.sampling_offsets", C, nh * L * P * 2,
                 (*p, "sampling_offsets"))
        t.linear(f"{b}.self_attn.attention_weights", C, nh * L * P,
                 (*p, "attention_weights"))
        t.linear(f"{b}.self_attn.value_proj", C, C, (*p, "value_proj"))
        t.linear(f"{b}.self_attn.output_proj", C, C, (*p, "output_proj"))
        t.norm(f"{b}.norm1", C, (*p, "norm1"))
        t.linear(f"{b}.linear1", C, cfg.enc_ffn_dim, (*p, "linear1"))
        t.linear(f"{b}.linear2", cfg.enc_ffn_dim, C, (*p, "linear2"))
        t.norm(f"{b}.norm2", C, (*p, "norm2"))

    pr = ("predictor",)

    def mha(name, path):
        t.add(f"{name}.in_proj_weight", (3 * C, C), "normal", (*path, "in_w"),
              "linear")
        t.add(f"{name}.in_proj_bias", (3 * C,), "zeros", (*path, "in_b"))
        t.linear(f"{name}.out_proj", C, C, (*path, "out"))

    t.add(f"{PRED}.query_embed.weight", (cfg.num_queries, C), "normal",
          (*pr, "query_embed"))
    t.add(f"{PRED}.level_embed.weight", (3, C), "normal",
          (*pr, "level_embed"))
    t.conv(f"{PRED}.class_input_proj", C, C, 1, (*pr, "class_input_proj"))
    t.norm(f"{PRED}.decoder_norm", C, (*pr, "decoder_norm"))
    t.norm(f"{PRED}.class_transformer.decoder.norm", C,
           (*pr, "class_dec_norm"))
    t.linear(f"{PRED}.class_embed", C, cfg.num_classes + 1,
             (*pr, "class_embed"))
    for i in range(3):
        t.linear(f"{PRED}.mask_embed.layers.{i}", C, C,
                 (*pr, "mask_embed", f"l{i}"))
    for i in range(cfg.class_dec_layers):
        b = f"{PRED}.class_transformer.decoder.layers.{i}"
        p = (*pr, f"class_dec{i}")
        mha(f"{b}.self_attn", (*p, "self_attn"))
        mha(f"{b}.multihead_attn", (*p, "multihead_attn"))
        t.linear(f"{b}.linear1", C, cfg.dim_feedforward, (*p, "linear1"))
        t.linear(f"{b}.linear2", cfg.dim_feedforward, C, (*p, "linear2"))
        for n in (1, 2, 3):
            t.norm(f"{b}.norm{n}", C, (*p, f"norm{n}"))
    for i in range(cfg.dec_layers):
        p = (*pr, f"dec_layer{i}")
        c = f"{PRED}.transformer_cross_attention_layers.{i}"
        s = f"{PRED}.transformer_self_attention_layers.{i}"
        f = f"{PRED}.transformer_ffn_layers.{i}"
        mha(f"{c}.multihead_attn", (*p, "cross_attn"))
        t.norm(f"{c}.norm", C, (*p, "cross_norm"))
        mha(f"{s}.self_attn", (*p, "self_attn"))
        t.norm(f"{s}.norm", C, (*p, "self_norm"))
        t.linear(f"{f}.linear1", C, cfg.dim_feedforward, (*p, "linear1"))
        t.linear(f"{f}.linear2", cfg.dim_feedforward, C, (*p, "linear2"))
        t.norm(f"{f}.norm", C, (*p, "ffn_norm"))
    t.linear("task_mlp.layers.0", cfg.task_seq_len, C, ("task_mlp", "l0"))
    t.linear("task_mlp.layers.1", C, C, ("task_mlp", "l1"))
    return t


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def _linear(sd, name, x):
    return F.linear(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"))


def _ln(sd, name, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"],
                        sd[f"{name}.bias"], eps)


def _group_norm(sd, name, x, groups=32, eps=1e-5):
    """x: [B, H, W, C]; torch GroupNorm on NCHW."""
    y = F.group_norm(x.permute(0, 3, 1, 2), groups, sd[f"{name}.weight"],
                     sd[f"{name}.bias"], eps)
    return y.permute(0, 2, 3, 1)


def _conv(sd, name, x):
    """NHWC in and out; stride 1, "SAME" padding (odd kernels)."""
    w = sd[f"{name}.weight"]
    y = F.conv2d(x.permute(0, 3, 1, 2), w, sd.get(f"{name}.bias"),
                 padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def _mha(sd, name, q, k, v, nheads: int, mask=None):
    """torch nn.MultiheadAttention semantics (packed in_proj). q/k/v:
    [B, L, C]; mask: bool [B*h, Lq, Lk] (True = blocked) or None."""
    B, Lq, C = q.shape
    d = C // nheads
    w = sd[f"{name}.in_proj_weight"]
    b = sd[f"{name}.in_proj_bias"]

    def heads(x, i):
        return F.linear(x, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C]) \
            .reshape(B, -1, nheads, d).transpose(1, 2)

    qh, kh, vh = heads(q, 0), heads(k, 1), heads(v, 2)
    attn = (qh * (d ** -0.5)) @ kh.transpose(-1, -2)
    if mask is not None:
        m = mask.reshape(B, nheads, Lq, -1)
        attn = attn.masked_fill(m, float("-inf"))
        # a fully-masked row would give NaNs: the decoder pre-clears such
        # rows, but the softmax stays safe regardless
        attn = torch.where(torch.isneginf(attn).all(-1, keepdim=True),
                           torch.zeros_like(attn), attn)
    attn = torch.softmax(attn, dim=-1)
    out = (attn @ vh).transpose(1, 2).reshape(B, Lq, C)
    return _linear(sd, f"{name}.out_proj", out)


@functools.lru_cache(maxsize=None)
def position_embedding_sine(H: int, W: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0) -> np.ndarray:
    """[H, W, 2*num_pos_feats] (y-part then x-part), normalize=True
    (``transformer_decoder/position_encoding.py:15-56``)."""
    scale = 2 * math.pi
    eps = 1e-6
    y = (np.arange(1, H + 1, dtype=np.float64)[:, None] / (H + eps)
         * scale) * np.ones((1, W))
    x = (np.arange(1, W + 1, dtype=np.float64)[None, :] / (W + eps)
         * scale) * np.ones((H, 1))
    dim_t = temperature ** (2 * (np.arange(num_pos_feats) // 2)
                            / num_pos_feats)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[..., 0::2]), np.cos(px[..., 1::2])],
                  axis=-1).reshape(H, W, -1)
    py = np.stack([np.sin(py[..., 0::2]), np.cos(py[..., 1::2])],
                  axis=-1).reshape(H, W, -1)
    return np.concatenate([py, px], axis=-1).astype(np.float32)


def _pos(h, w, C, dev):
    return torch.from_numpy(position_embedding_sine(h, w, C // 2).reshape(
        h * w, C)).to(dev)


def _resize(x, out_hw):
    """NHWC bilinear resize as ``jax.image.resize(..., "linear")``."""
    return resize_antialiased(x, (x.shape[0], *out_hw, x.shape[-1]),
                              "linear")


def _mlp(sd, name, x, layers: int):
    for i in range(layers):
        x = _linear(sd, f"{name}.layers.{i}", x)
        if i < layers - 1:
            x = F.relu(x)
    return x


# ---------------------------------------------------------------------------
# Pixel decoder
# ---------------------------------------------------------------------------

def _deform_layer(sd, name, src, pos, ref_points, shapes,
                  cfg: OneFormerConfig):
    """One MSDeformAttnTransformerEncoderLayer (``msdeformattn.py:92-131``);
    the sampling is K13."""
    B, S, C = src.shape
    H, L, P = cfg.nheads, len(shapes), cfg.enc_points
    a = f"{name}.self_attn"
    query = src + pos
    value = _linear(sd, f"{a}.value_proj", src).reshape(B, S, H, C // H)
    offsets = _linear(sd, f"{a}.sampling_offsets", query).reshape(
        B, S, H, L, P, 2)
    weights = _linear(sd, f"{a}.attention_weights", query).reshape(
        B, S, H, L * P)
    weights = torch.softmax(weights, dim=-1).reshape(B, S, H, L, P)
    normalizer = torch.tensor([[w, h] for h, w in shapes],
                              dtype=torch.float32, device=src.device)
    loc = ref_points[:, :, None, :, None, :] \
        + offsets / normalizer[None, None, None, :, None, :]
    attn = ms_deform_attn(value.contiguous(), shapes, loc.contiguous(),
                          weights.contiguous())
    attn = _linear(sd, f"{a}.output_proj", attn)
    src = _ln(sd, f"{name}.norm1", src + attn)
    h = _linear(sd, f"{name}.linear2",
                F.relu(_linear(sd, f"{name}.linear1", src)))
    return _ln(sd, f"{name}.norm2", src + h)


@functools.lru_cache(maxsize=None)
def _encoder_reference_points(shapes) -> np.ndarray:
    """[S, L, 2] normalized centers (valid_ratios = 1; ``:141-153``)."""
    pts = []
    for (H, W) in shapes:
        ry, rx = np.meshgrid(
            (np.arange(H, dtype=np.float64) + 0.5) / H,
            (np.arange(W, dtype=np.float64) + 0.5) / W, indexing="ij")
        pts.append(np.stack([rx.ravel(), ry.ravel()], -1))
    pts = np.concatenate(pts, 0)
    return np.tile(pts[:, None], (1, len(shapes), 1)).astype(np.float32)


def pixel_decoder_forward(cfg: OneFormerConfig, sd, feats):
    """feats: NHWC {res2..res5}. Returns (mask_features [B, h4, w4, 256],
    multi_scale [res5, res4, res3] each [B, h, w, 256])
    (``msdeformattn.py:316-358``)."""
    B = feats["res2"].shape[0]
    C = cfg.hidden_dim
    dev = feats["res2"].device
    level_embed = sd[f"{PD}.transformer.level_embed"]
    srcs, poss, shapes = [], [], []
    for i, name in enumerate(["res5", "res4", "res3"]):     # top-down
        x = feats[name]
        proj = _group_norm(sd, f"{PD}.input_proj.{i}.1",
                           _conv(sd, f"{PD}.input_proj.{i}.0", x))
        h, w = x.shape[1:3]
        shapes.append((h, w))
        srcs.append(proj.reshape(B, h * w, C))
        poss.append(_pos(h, w, C, dev)[None] + level_embed[i][None, None])
    src = torch.cat(srcs, dim=1)
    pos = torch.cat(poss, dim=1)
    ref = torch.from_numpy(_encoder_reference_points(tuple(shapes))).to(
        dev)[None]
    for i in range(cfg.enc_layers):
        src = _deform_layer(sd, f"{PD}.transformer.encoder.layers.{i}", src,
                            pos, ref, shapes, cfg)
    sizes = [h * w for h, w in shapes]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    out = [src[:, offs[i]:offs[i + 1]].reshape(B, *shapes[i], C)
           for i in range(len(shapes))]
    # FPN: lateral res2 + the upsampled res3-level output
    lat = _group_norm(sd, f"{PD}.adapter_1.norm",
                      _conv(sd, f"{PD}.adapter_1", feats["res2"]))
    y = lat + _resize(out[-1], lat.shape[1:3])
    y = F.relu(_group_norm(sd, f"{PD}.layer_1.norm",
                           _conv(sd, f"{PD}.layer_1", y)))
    mask_features = _conv(sd, f"{PD}.mask_features", y)
    return mask_features, out            # out = [res5, res4, res3]


# ---------------------------------------------------------------------------
# Transformer decoder
# ---------------------------------------------------------------------------

def _detr_decoder_layer(sd, name, tgt, memory, pos, query_pos, nheads: int,
                        eps: float):
    """Post-norm DETR TransformerDecoderLayer: self-attn, cross-attn, FFN,
    each residual + LayerNorm."""
    q = k = tgt + query_pos
    tgt = _ln(sd, f"{name}.norm1",
              tgt + _mha(sd, f"{name}.self_attn", q, k, tgt, nheads), eps)
    tgt = _ln(sd, f"{name}.norm2",
              tgt + _mha(sd, f"{name}.multihead_attn", tgt + query_pos,
                         memory + pos, memory, nheads), eps)
    h = _linear(sd, f"{name}.linear2",
                F.relu(_linear(sd, f"{name}.linear1", tgt)))
    return _ln(sd, f"{name}.norm3", tgt + h, eps)


def _prediction_heads(cfg: OneFormerConfig, sd, output, mask_features,
                      target_hw):
    """output: [Q, B, C]; mask_features: [B, h4, w4, 256]. Returns class
    logits, mask logits, bool attn mask [B*h, Q, target h*w]
    (``oneformer_transformer_decoder.py:495-520``)."""
    dec = _ln(sd, f"{PRED}.decoder_norm", output).transpose(0, 1)
    outputs_class = _linear(sd, f"{PRED}.class_embed", dec)   # [B, Q, K+1]
    mask_embed = _mlp(sd, f"{PRED}.mask_embed", dec, 3)       # [B, Q, 256]
    outputs_mask = torch.einsum("bqc,bhwc->bqhw", mask_embed, mask_features)
    B, Q = outputs_mask.shape[:2]
    am = _resize(outputs_mask.permute(0, 2, 3, 1), target_hw)
    am = torch.sigmoid(am.permute(0, 3, 1, 2).reshape(B, Q, -1)) < 0.5
    # un-mask rows that would see nothing (``:459``)
    am = am & ~am.all(-1, keepdim=True)
    am = am[:, None].expand(B, cfg.nheads, Q, am.shape[-1]).reshape(
        B * cfg.nheads, Q, -1)
    return outputs_class, outputs_mask, am


def transformer_decoder_forward(cfg: OneFormerConfig, sd,
                                multi_scale: List[torch.Tensor],
                                mask_features, task):
    """multi_scale: [res5, res4, res3] NHWC; task: [B, C]. Returns
    (pred_logits [B, Q, K+1], pred_masks [B, Q, h4, w4])
    (``oneformer_transformer_decoder.py:405-493``)."""
    B = mask_features.shape[0]
    C = cfg.hidden_dim
    eps = cfg.layer_norm_eps
    dev = mask_features.device
    level_embed = sd[f"{PRED}.level_embed.weight"]
    src, pos, size_list = [], [], []
    for i in range(3):
        x = multi_scale[i]
        h, w = x.shape[1:3]
        size_list.append((h, w))
        pos.append(_pos(h, w, C, dev)[None].expand(B, h * w, C))
        src.append(x.reshape(B, h * w, C) + level_embed[i][None, None])

    query_embed = sd[f"{PRED}.query_embed.weight"][None].expand(B, -1, -1)
    tasks = _ln(sd, f"{PRED}.decoder_norm", task, eps)[:, None]  # [B,1,C]

    # the 2-layer DETR "class" transformer seeds the 149 object queries
    # from the task token (``:430-440``); the reference's argument swap:
    # src = sine PE of mask_features, pos = projected mask_features
    h4, w4 = mask_features.shape[1:3]
    memory = _pos(h4, w4, C, dev)[None].expand(B, h4 * w4, C)
    cls_pos = _conv(sd, f"{PRED}.class_input_proj", mask_features).reshape(
        B, h4 * w4, C)
    qe = sd[f"{PRED}.query_embed.weight"][:-1][None].expand(B, -1, -1)
    tgt = tasks.expand(B, qe.shape[1], C)
    for i in range(cfg.class_dec_layers):
        tgt = _detr_decoder_layer(
            sd, f"{PRED}.class_transformer.decoder.layers.{i}", tgt, memory,
            cls_pos, qe, cfg.nheads, eps)
    out_t = _ln(sd, f"{PRED}.class_transformer.decoder.norm", tgt, eps)

    output = torch.cat([out_t, tasks], dim=1).transpose(0, 1)   # [Q, B, C]
    _, _, attn_mask = _prediction_heads(cfg, sd, output, mask_features,
                                        size_list[0])
    for i in range(cfg.dec_layers):
        lvl = i % 3
        c = f"{PRED}.transformer_cross_attention_layers.{i}"
        s = f"{PRED}.transformer_self_attention_layers.{i}"
        f = f"{PRED}.transformer_ffn_layers.{i}"
        # masked cross-attention first (``:461-470``)
        o = output.transpose(0, 1)
        o = _ln(sd, f"{c}.norm",
                o + _mha(sd, f"{c}.multihead_attn", o + query_embed,
                         src[lvl] + pos[lvl], src[lvl], cfg.nheads,
                         mask=attn_mask), eps)
        q = k = o + query_embed
        o = _ln(sd, f"{s}.norm",
                o + _mha(sd, f"{s}.self_attn", q, k, o, cfg.nheads), eps)
        h = _linear(sd, f"{f}.linear2",
                    F.relu(_linear(sd, f"{f}.linear1", o)))
        o = _ln(sd, f"{f}.norm", o + h, eps)
        output = o.transpose(0, 1)
        _, _, attn_mask = _prediction_heads(cfg, sd, output, mask_features,
                                            size_list[(i + 1) % 3])
    outputs_class, outputs_mask, _ = _prediction_heads(
        cfg, sd, output, mask_features, size_list[0])
    return outputs_class, outputs_mask


@torch.no_grad()
def oneformer_forward(cfg: OneFormerConfig, sd, image, task):
    """image: [B, H, W, 3] normalized + padded; task: [B, task_seq_len]
    float token ids. Returns (pred_logits [B, Q, K+1], pred_masks
    [B, Q, H/4, W/4])."""
    feats = swin_forward(cfg.swin, sd, image, prefix="backbone.")
    mask_features, multi_scale = pixel_decoder_forward(cfg, sd, feats)
    task_emb = _mlp(sd, "task_mlp", task, 2)
    return transformer_decoder_forward(cfg, sd, multi_scale, mask_features,
                                       task_emb)


# ---------------------------------------------------------------------------
# Panoptic fusion (host-side numpy; ``oneformer_model.py:378-434``)
# ---------------------------------------------------------------------------

def panoptic_inference(mask_cls: np.ndarray, mask_pred: np.ndarray,
                       thing_ids: Sequence[int],
                       object_mask_threshold: float = 0.8,
                       overlap_threshold: float = 0.8):
    """mask_cls: [Q, K+1] logits; mask_pred: [Q, H, W] logits (already
    upsampled to the output size). Returns (panoptic_seg [H, W] int32,
    segments_info list of {id, isthing, category_id})."""
    num_classes = mask_cls.shape[-1] - 1
    prob = _softmax_np(mask_cls)
    scores = prob.max(-1)
    labels = prob.argmax(-1)
    sig = 1.0 / (1.0 + np.exp(-mask_pred))
    keep = (labels != num_classes) & (scores > object_mask_threshold)
    cur_scores = scores[keep]
    cur_classes = labels[keep]
    cur_masks = sig[keep]
    H, W = mask_pred.shape[-2:]
    panoptic_seg = np.zeros((H, W), np.int32)
    segments_info = []
    if cur_masks.shape[0] == 0:
        return panoptic_seg, segments_info
    cur_prob_masks = cur_scores[:, None, None] * cur_masks
    cur_mask_ids = cur_prob_masks.argmax(0)
    stuff_memory = {}
    segment_id = 0
    thing_set = set(int(t) for t in thing_ids)
    for k in range(cur_classes.shape[0]):
        pred_class = int(cur_classes[k])
        isthing = pred_class in thing_set
        mask_area = int((cur_mask_ids == k).sum())
        original_area = int((cur_masks[k] >= 0.5).sum())
        mask = (cur_mask_ids == k) & (cur_masks[k] >= 0.5)
        if mask_area > 0 and original_area > 0 and mask.sum() > 0:
            if mask_area / original_area < overlap_threshold:
                continue
            if not isthing:
                if pred_class in stuff_memory:
                    panoptic_seg[mask] = stuff_memory[pred_class]
                    continue
                stuff_memory[pred_class] = segment_id + 1
            segment_id += 1
            panoptic_seg[mask] = segment_id
            segments_info.append({"id": segment_id,
                                  "isthing": bool(isthing),
                                  "category_id": pred_class})
    return panoptic_seg, segments_info


def _softmax_np(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def init_oneformer(cfg: OneFormerConfig, generator: torch.Generator,
                   dtype: torch.dtype = torch.float32):
    """Seeded random weights under the released names on the generator's
    device, at JAX's ``init_oneformer`` scales."""
    return oneformer_param_table(cfg).draw(generator, dtype)
