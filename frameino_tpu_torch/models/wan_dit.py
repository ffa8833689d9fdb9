"""Wan 2.1 / 2.2 video DiT denoiser (counterpart of
``frameino_tpu/models/wan_dit.py``).

``WanDiT`` is an ``nn.Module`` with diffusers ``WanTransformer3DModel``
parameter names, so a diffusers state dict and the weight bridge
(``models/weights.py``) both load through ``load_state_dict``. The math
follows the JAX forward: fp32 AdaLN modulation and residual sums around
attention and FFN, qk RMS-norm across heads, interleaved 3-axis RoPE,
patchify-as-dense, the two-level per-token timestep form of the Wan2.2
expand path, and per-block text K/V computed once per clip.

Wan2.1 I2V (``image_dim`` / ``added_kv_proj_dim`` set) adds the image-KV
branch: ``condition_embedder.image_embedder`` (FP32 LayerNorm at eps
1e-5, an exact-GELU MLP, FP32 LayerNorm; with ``pos_embed_seq_len`` the
first- and last-frame embeds of a sample are joined and a learned table
added) maps the CLIP penultimate states, and every block's cross-attention
adds a second attention against their keys (``add_k_proj`` with its own
RMS-norm across heads, ``add_v_proj``): two softmaxes summed, one over the
text keys and one over the image keys, never one over both.

The forward runs in the weights' dtype (bf16 at full width): it casts its
input to that dtype and returns fp32. The serving forward runs without
autograd: on CUDA tensors self-attention goes through the fused K2 -> K1
kernels and cross-attention through K3 (``ops/attention.py``); on the CPU
both take the plain reference path. The training forward
(``differentiable=True``, the JAX signature's flag) keeps the graph: the
qk RMS-norm and RoPE run as plain ops, every attention goes through K6
(``flash_attention_train``), the text K/V are projected inside the graph,
and ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``).

Under a dp x fsdp x tp x sp ``mesh`` (``core/meshes.py``), one process
runs per rank and ``WanDiT(cfg, mesh=mesh)`` holds layers of the rank's
width (``parallel/sharding.py``): each tp rank computes its contiguous slice of
the heads and of the FFN hidden width, the qk RMS statistic across heads
is completed by an all-reduce of the fp32 sum of squares, each
row-parallel output is all-reduced in fp32 before its bias is added once,
and each rank runs its slice of the batch, cut over (dp, fsdp), the
output being gathered over them. Under fsdp each rank holds its slice of
the fsdp-cut tensors: a block's slices are gathered just before the block
runs and dropped after it (and gathered again when ``remat`` recomputes
it), the top level's (patch embed, text embedder, head) for the whole
forward. With sp = 1 self-attention takes K5 then K1
(``fused_qk_flash_attention_sharded``). With sp > 1 (JAX's route, which
leaves the fused path there) each sp rank runs its contiguous slice of the
tokens, cut after the patch embed and the position tables (RoPE rows, the
per-token timestep rows) and gathered over sp before the head: the RMS
norm and RoPE run as plain ops on the rank's rows, then
``ops/attention.dispatch_attention``, K3 over the keys and values gathered
over sp or the fp32 ring (``DEFAULT_SP_METHOD``). A sequence that sp does
not divide runs whole on every sp rank (K3, no sp collective), as JAX
falls back to unsharded attention. Cross-attention (plain norm, then K3)
runs each rank's queries against the replicated text K/V. Every rank is
called with the same full-batch arguments and returns the same
full-batch output.

The training forward runs under a dp x fsdp x tp mesh (sp = 1) on the
rank's own examples (the trainer cuts the batch): the fsdp gathers are
``parallel/collectives.gather_fsdp``, whose backward reduce-scatters the
gradients; a column-parallel layer's replicated input passes through
``copy_to_tp`` (its gradient summed over tp), a row-parallel output
through ``reduce_from_tp``, the qk statistic through ``all_reduce_sum``;
attention is K6 on the rank's heads
(``ops/attention.dispatch_attention(differentiable=True)``).

Not ported: the pp mesh path, training under sp > 1 and the image-KV
branch under a mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn.functional import gelu
from torch.utils.checkpoint import checkpoint

from frameino_tpu_torch.core.meshes import Mesh, check_supported
from frameino_tpu_torch.models.quant import linear as _lin
from frameino_tpu_torch.ops import attention as attn_ops
from frameino_tpu_torch.ops.embeddings import (pixart_text_projection,
                                               sinusoidal_timestep_embedding,
                                               timestep_embedding_mlp)
from frameino_tpu_torch.ops.linear import dense, gelu_tanh, silu
from frameino_tpu_torch.ops.norms import layer_norm, rms_norm
from frameino_tpu_torch.ops.rope import apply_rope_interleaved, wan_rope_table
from frameino_tpu_torch.parallel.collectives import copy_to_tp
from frameino_tpu_torch.parallel.sharding import (gathered, mesh_cuts,
                                                 row_parallel, run_dp,
                                                 shard_model)

IMAGE_BRANCH_MESH_NOT_PORTED = (
    "the Wan2.1 image-KV branch under a mesh is not ported: ROADMAP.md "
    "queue 1, item 12.7")


@dataclasses.dataclass(frozen=True)
class WanDiTConfig:
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_attention_heads: int = 24
    attention_head_dim: int = 128
    in_channels: int = 48
    out_channels: int = 48
    text_dim: int = 4096
    freq_dim: int = 256
    ffn_dim: int = 14336
    num_layers: int = 30
    cross_attn_norm: bool = True
    eps: float = 1e-6
    image_dim: Optional[int] = None
    added_kv_proj_dim: Optional[int] = None
    rope_max_seq_len: int = 1024
    pos_embed_seq_len: Optional[int] = None

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


# Wan2.2-TI2V-5B: dim 3072 = 24 x 128, 30 layers, ffn 14336, z=48.
WAN22_TI2V_5B = WanDiTConfig()
# FrameINO motion models: +48 trajectory-latent input channels.
WAN22_TI2V_5B_MOTION = dataclasses.replace(WAN22_TI2V_5B, in_channels=96)

# Wan2.1-I2V-14B: dim 5120 = 40 x 128, 40 layers, CLIP image-KV branch,
# 36 input channels (16 noisy + 4 mask + 16 image latents).
WAN21_I2V_14B = WanDiTConfig(
    num_attention_heads=40, attention_head_dim=128, in_channels=36,
    out_channels=16, ffn_dim=13824, num_layers=40,
    image_dim=1280, added_kv_proj_dim=5120)
# Wan2.1-T2V-1.3B: dim 1536 = 12 x 128, 30 layers.
WAN21_T2V_1_3B = WanDiTConfig(
    num_attention_heads=12, attention_head_dim=128, in_channels=16,
    out_channels=16, ffn_dim=8960, num_layers=30)


def tiny_config(**kw) -> WanDiTConfig:
    base = dict(num_attention_heads=2, attention_head_dim=24, in_channels=8,
                out_channels=8, text_dim=16, freq_dim=32, ffn_dim=64,
                num_layers=2)
    base.update(kw)
    return WanDiTConfig(**base)


# ---------------------------------------------------------------------------
# Modules (diffusers names)
# ---------------------------------------------------------------------------

class _TwoLinear(nn.Module):
    """TimestepEmbedding / PixArtAlphaTextProjection parameter holder."""

    def __init__(self, d_in, d_out, **kw):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d_out, **kw)
        self.linear_2 = nn.Linear(d_out, d_out, **kw)


class _ImageEmbedder(nn.Module):
    """WanImageEmbedding: FP32 LayerNorm -> FeedForward(mult 1, exact
    GELU) -> FP32 LayerNorm, an optional learned ``pos_embed``."""

    def __init__(self, image_dim, d, pos_embed_seq_len=None, **kw):
        super().__init__()
        self.norm1 = nn.LayerNorm(image_dim, eps=1e-5, **kw)
        self.ff = _FeedForward(image_dim, image_dim, d_out=d, **kw)
        self.norm2 = nn.LayerNorm(d, eps=1e-5, **kw)
        if pos_embed_seq_len is not None:
            self.pos_embed = nn.Parameter(
                torch.empty(1, pos_embed_seq_len, image_dim, **kw))

    def forward(self, img, out_dtype):
        """img [B, S, image_dim] (the CLIP states; with ``pos_embed``, each
        sample's first- and last-frame embeds in turn) -> [B', S', D] in
        ``out_dtype``. Runs in img's dtype, as the JAX function does."""
        if hasattr(self, "pos_embed"):
            B, S, D = img.shape
            img = img.reshape(-1, 2 * S, D) + self.pos_embed
        h = layer_norm(img, self.norm1.weight, self.norm1.bias,
                       eps=1e-5).to(img.dtype)
        h = gelu(_lin(h, self.ff.net[0].proj))
        h = _lin(h, self.ff.net[2])
        return layer_norm(h, self.norm2.weight, self.norm2.bias,
                          eps=1e-5).to(out_dtype)


class _ConditionEmbedder(nn.Module):
    def __init__(self, cfg: WanDiTConfig, **kw):
        super().__init__()
        d = cfg.inner_dim
        self.time_embedder = _TwoLinear(cfg.freq_dim, d, **kw)
        self.time_proj = nn.Linear(d, 6 * d, **kw)
        self.text_embedder = _TwoLinear(cfg.text_dim, d, **kw)
        if cfg.image_dim is not None:
            self.image_embedder = _ImageEmbedder(
                cfg.image_dim, d, cfg.pos_embed_seq_len, **kw)


class _Attention(nn.Module):
    """q/k/v column-parallel and to_out row-parallel over ``tp`` ranks: a
    rank holds d/tp of their heads (and of the norm gains)."""

    def __init__(self, d, eps, tp=1, added_kv_proj_dim=None, **kw):
        super().__init__()
        d_l = d // tp
        self.to_q = nn.Linear(d, d_l, **kw)
        self.to_k = nn.Linear(d, d_l, **kw)
        self.to_v = nn.Linear(d, d_l, **kw)
        self.to_out = nn.ModuleList([nn.Linear(d_l, d, **kw),
                                     nn.Dropout(0.0)])
        self.norm_q = nn.RMSNorm(d_l, eps=eps, **kw)
        self.norm_k = nn.RMSNorm(d_l, eps=eps, **kw)
        if added_kv_proj_dim is not None:
            # the Wan2.1 I2V image keys and values (cross-attention only)
            self.add_k_proj = nn.Linear(added_kv_proj_dim, d_l, **kw)
            self.add_v_proj = nn.Linear(added_kv_proj_dim, d_l, **kw)
            self.norm_added_k = nn.RMSNorm(d_l, eps=eps, **kw)


class _GeluProj(nn.Module):
    def __init__(self, d_in, d_out, **kw):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out, **kw)


class _FeedForward(nn.Module):
    def __init__(self, d, ffn_dim, tp=1, d_out=None, **kw):
        super().__init__()
        self.net = nn.ModuleList([_GeluProj(d, ffn_dim // tp, **kw),
                                  nn.Dropout(0.0),
                                  nn.Linear(ffn_dim // tp, d_out or d, **kw)])


def _split_heads(x, num_heads):
    B, S, D = x.shape
    return x.reshape(B, S, num_heads, D // num_heads).permute(0, 2, 1, 3)


def _merge_heads(x):
    B, H, S, Dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, S, H * Dh)


class WanBlock(nn.Module):
    """WanTransformerBlock (reference transformer_wan.py:308-350)."""

    def __init__(self, cfg: WanDiTConfig, mesh: Optional[Mesh] = None, **kw):
        super().__init__()
        d = cfg.inner_dim
        tp = 1 if mesh is None else mesh.tp
        self.cfg = cfg
        self.mesh = mesh
        self.tp = tp
        self.sp = 1 if mesh is None else mesh.sp
        # the tp group of the row-parallel sums and the qk statistics
        self.tp_group = mesh.tp_group if tp > 1 else None
        self.heads = cfg.num_attention_heads // tp        # this rank's
        self.scale_shift_table = nn.Parameter(torch.empty(1, 6, d, **kw))
        self.attn1 = _Attention(d, cfg.eps, tp, **kw)
        self.attn2 = _Attention(d, cfg.eps, tp, cfg.added_kv_proj_dim, **kw)
        if cfg.cross_attn_norm:
            self.norm2 = nn.LayerNorm(d, eps=cfg.eps, **kw)
        self.ffn = _FeedForward(d, cfg.ffn_dim, tp, **kw)

    def text_kv(self, context, context_img=None) -> Tuple[torch.Tensor, ...]:
        """Cross-attention K/V [B, H, L, Dh] for a fixed text context (this
        rank's H/tp heads under tp); with ``context_img`` (the image
        embedder's output) and an image branch, the image K/V follow:
        (k, v, k_img, v_img)."""
        a = self.attn2
        k = rms_norm(_lin(context, a.to_k), a.norm_k.weight, self.cfg.eps,
                     group=self.tp_group)
        v = _lin(context, a.to_v)
        kv = (_split_heads(k, self.heads).contiguous(),
              _split_heads(v, self.heads).contiguous())
        if context_img is None or not hasattr(a, "add_k_proj"):
            return kv
        k_img = rms_norm(_lin(context_img, a.add_k_proj),
                         a.norm_added_k.weight, self.cfg.eps)
        v_img = _lin(context_img, a.add_v_proj)
        return kv + (_split_heads(k_img, self.heads).contiguous(),
                     _split_heads(v_img, self.heads).contiguous())

    def _self_attention(self, x, cos, sin, differentiable, seq_mesh=None):
        cfg, a = self.cfg, self.attn1
        H = self.heads
        q, k, v = _lin(x, a.to_q), _lin(x, a.to_k), _lin(x, a.to_v)
        if differentiable:
            # the norm across heads (statistic all-reduced over tp), RoPE,
            # then K6 on the rank's heads
            q = _split_heads(rms_norm(q, a.norm_q.weight, cfg.eps,
                                      group=self.tp_group), H)
            k = _split_heads(rms_norm(k, a.norm_k.weight, cfg.eps,
                                      group=self.tp_group), H)
            o = attn_ops.dispatch_attention(
                apply_rope_interleaved(q, cos, sin).contiguous(),
                apply_rope_interleaved(k, cos, sin).contiguous(),
                _split_heads(v, H).contiguous(), mesh=self.mesh,
                differentiable=True)
        elif self.sp > 1:
            # the norm across heads (statistic all-reduced over tp), RoPE
            # on the rank's rows, then K3 over the gathered keys or the
            # ring (seq_mesh None: the whole sequence here, K3 alone)
            q = _split_heads(rms_norm(q, a.norm_q.weight, cfg.eps,
                                      group=self.tp_group), H)
            k = _split_heads(rms_norm(k, a.norm_k.weight, cfg.eps,
                                      group=self.tp_group), H)
            o = attn_ops.dispatch_attention(
                apply_rope_interleaved(q, cos, sin),
                apply_rope_interleaved(k, cos, sin), _split_heads(v, H),
                mesh=seq_mesh)
        elif self.tp > 1:
            # the across-heads statistic all-reduced -> K5 -> bound -> K1
            o = attn_ops.fused_qk_flash_attention_sharded(
                q, k, _split_heads(v, H).contiguous(), a.norm_q.weight,
                a.norm_k.weight, cos, sin, self.mesh,
                num_heads=cfg.num_attention_heads, eps=cfg.eps)
        elif x.is_cuda:
            # K2 (norm + RoPE producer) -> bound -> K1
            o = attn_ops.fused_qk_flash_attention(
                q, k, _split_heads(v, H).contiguous(), a.norm_q.weight,
                a.norm_k.weight, cos, sin, num_heads=H, eps=cfg.eps)
        else:
            q = _split_heads(rms_norm(q, a.norm_q.weight, cfg.eps), H)
            k = _split_heads(rms_norm(k, a.norm_k.weight, cfg.eps), H)
            q = apply_rope_interleaved(q, cos, sin)
            k = apply_rope_interleaved(k, cos, sin)
            o = attn_ops.attention_ref(q, k, _split_heads(v, H))
        return row_parallel(_merge_heads(o), a.to_out[0], self.tp_group)

    def _cross_attention(self, x, context, context_img, kv, differentiable):
        cfg, a = self.cfg, self.attn2
        q = rms_norm(_lin(x, a.to_q), a.norm_q.weight, cfg.eps,
                     group=self.tp_group)
        qh = _split_heads(q, self.heads)
        if kv is None:
            kv = self.text_kv(context, context_img)

        def attend(kh, vh):
            if differentiable:
                return attn_ops.flash_attention_train(qh.contiguous(), kh,
                                                      vh)            # K6
            if qh.is_cuda:
                return attn_ops.flash_attention_inference(qh, kh, vh)  # K3
            return attn_ops.attention_ref(qh, kh, vh)

        o = attend(kv[0], kv[1])
        if len(kv) == 4:
            # the image keys: a softmax of their own, added
            o = o + attend(kv[2], kv[3])
        return row_parallel(_merge_heads(o), a.to_out[0], self.tp_group)

    def forward(self, x, context, timestep_proj, cos, sin, kv=None,
                differentiable=False, context_img=None, seq_mesh=None):
        """x: [B, S, D] compute dtype; timestep_proj fp32 [B, S|1, 6, D] or
        the two-level pair ([B, 2, 6, D], selector [B, S, 1]); kv: the
        block's ``text_kv`` (2 or 4 tensors), or None to project
        ``context`` (and ``context_img``) here. ``seq_mesh``: the mesh when
        x, cos, sin and the per-token rows are the rank's sequence shard
        (sp > 1), else None."""
        eps = self.cfg.eps
        table = self.scale_shift_table.float()               # [1, 6, D]
        if isinstance(timestep_proj, tuple):
            # two distinct per-token timesteps: select between two rows
            pair, sel = timestep_proj
            mod = table[None] + pair                          # [B, 2, 6, D]
            hi_mask = sel > 0.5
            shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = [
                torch.where(hi_mask, mod[:, 1, i][:, None], mod[:, 0, i][:, None])
                for i in range(6)]
        else:
            mod = table[None] + timestep_proj                 # [B, S|1, 6, D]
            shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = \
                mod.unbind(dim=2)

        # each column-parallel layer's replicated input passes through
        # copy_to_tp: under autograd its gradient is summed over tp
        tp = self.tp_group
        norm_x = layer_norm(x, eps=eps) * (1 + scale_msa) + shift_msa
        attn_out = self._self_attention(copy_to_tp(norm_x.to(x.dtype), tp),
                                        cos, sin, differentiable, seq_mesh)
        x = (x.float() + attn_out.float() * gate_msa).to(x.dtype)

        if self.cfg.cross_attn_norm:
            norm_x = layer_norm(x, self.norm2.weight, self.norm2.bias,
                                eps=eps).to(x.dtype)
        else:
            norm_x = x
        x = x + self._cross_attention(copy_to_tp(norm_x, tp), context,
                                      context_img, kv, differentiable)

        norm_x = layer_norm(x, eps=eps) * (1 + c_scale) + c_shift
        h = _lin(copy_to_tp(norm_x.to(x.dtype), tp), self.ffn.net[0].proj)
        h = row_parallel(gelu_tanh(h), self.ffn.net[2], self.tp_group)
        return (x.float() + h.float() * c_gate).to(x.dtype)


def _patchify_tokens(x, patch):
    """[B, C, F, H, W] -> [B, tokens, C*pt*ph*pw], patch vector layout
    (C, pt, ph, pw) as the Conv3d weight flattens."""
    B, C, F, H, W = x.shape
    pt, ph, pw = patch
    x = x.reshape(B, C, F // pt, pt, H // ph, ph, W // pw, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(B, (F // pt) * (H // ph) * (W // pw), C * pt * ph * pw)


def _unpatchify_tokens(x, grid, patch, out_ch):
    """[B, S, out_ch*pt*ph*pw] -> [B, out_ch, F, H, W]."""
    B = x.shape[0]
    f, h, w = grid
    pt, ph, pw = patch
    x = x.reshape(B, f, h, w, pt, ph, pw, out_ch)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(B, out_ch, f * pt, h * ph, w * pw)


class WanDiT(nn.Module):
    """WanTransformer3DModel.

    Build with ``device="meta"`` and then ``to_empty`` + ``init_random_``
    or ``load_state_dict(..., assign=True)`` to skip torch's default init.
    With a ``mesh`` the block layers have this rank's width and the
    fsdp-cut tensors this rank's slice (``cuts``): load
    ``parallel.sharding.shard_state_dict`` of a full state dict.
    """

    def __init__(self, cfg: WanDiTConfig, device=None, dtype=None,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.inner_dim
        if mesh is not None:
            check_supported(mesh.cfg)
            if cfg.num_attention_heads % mesh.tp or cfg.ffn_dim % mesh.tp:
                raise ValueError(f"{cfg.num_attention_heads} heads and FFN "
                                 f"width {cfg.ffn_dim} must divide over "
                                 f"tp={mesh.tp}")
            if cfg.image_dim is not None or cfg.added_kv_proj_dim is not None:
                raise NotImplementedError(IMAGE_BRANCH_MESH_NOT_PORTED)
        self.cfg = cfg
        self.mesh = mesh
        self.patch_embedding = nn.Conv3d(cfg.in_channels, d, cfg.patch_size,
                                         stride=cfg.patch_size, **kw)
        self.condition_embedder = _ConditionEmbedder(cfg, **kw)
        self.blocks = nn.ModuleList([WanBlock(cfg, mesh, **kw)
                                     for _ in range(cfg.num_layers)])
        self.scale_shift_table = nn.Parameter(torch.empty(1, 2, d, **kw))
        self.proj_out = nn.Linear(
            d, cfg.out_channels * math.prod(cfg.patch_size), **kw)
        self.cuts, self._fsdp = mesh_cuts(self, mesh)

    @property
    def dtype(self) -> torch.dtype:
        return self.proj_out.weight.dtype

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Seeded init mirroring ``init_wan_dit``: uniform(+-1/sqrt(fan_in))
        for dense and patch weights and biases, unit norm gains, zero norm
        biases, N(0, 1/d) AdaLN tables, a zero image ``pos_embed``. Draws
        in fp32 on ``generator``'s device, then casts into each
        parameter."""
        d = self.cfg.inner_dim

        def fill_uniform(p, fan_in):
            bound = fan_in ** -0.5
            r = torch.rand(p.shape, generator=generator,
                           device=generator.device, dtype=torch.float32)
            p.copy_(r.mul_(2 * bound).sub_(bound))

        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv3d)):
                fan_in = mod.weight[0].numel()
                fill_uniform(mod.weight, fan_in)
                fill_uniform(mod.bias, fan_in)
            elif isinstance(mod, (nn.RMSNorm, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
        for name, p in self.named_parameters():
            if name.endswith("scale_shift_table"):
                r = torch.randn(p.shape, generator=generator,
                                device=generator.device, dtype=torch.float32)
                p.copy_(r / d ** 0.5)
            elif name.endswith("pos_embed"):
                p.zero_()
        return self

    def _image_context(self, encoder_hidden_states_image, dtype):
        """The image embedder's output [B, 257, D] in ``dtype`` for CLIP
        states [B, 257, image_dim], or None (no states, or no branch)."""
        ce = self.condition_embedder
        if encoder_hidden_states_image is None \
                or not hasattr(ce, "image_embedder"):
            return None
        return ce.image_embedder(encoder_hidden_states_image.to(
            self.proj_out.weight.device), dtype)

    def _gathered(self, module, prefix):
        """A context in which ``module`` (the DiT itself for prefix "",
        or block ``prefix``) holds its fsdp-cut tensors whole."""
        return gathered(module, self._fsdp.get(prefix), self.mesh)

    def _block(self, i, *args):
        with self._gathered(self.blocks[i], f"blocks.{i}."):
            return self.blocks[i](*args)

    @torch.no_grad()
    def precompute_text_kv(self, encoder_hidden_states, image=None,
                           dtype: Optional[torch.dtype] = None
                           ) -> List[Tuple[torch.Tensor, ...]]:
        """Per-block cross-attention K/V for a fixed text context (constant
        across denoise steps): one (k, v) pair [B, H, L, Dh] per block;
        with ``image`` (CLIP states [B, 257, image_dim]) and an image
        branch, (k, v, k_img, v_img)."""
        dtype = dtype or self.dtype
        te = self.condition_embedder.text_embedder
        with self._gathered(self, ""):
            context = pixart_text_projection(
                encoder_hidden_states, te.linear_1, te.linear_2,
                out_dtype=dtype)
            context_img = self._image_context(image, dtype)
        out = []
        for i, blk in enumerate(self.blocks):
            with self._gathered(blk, f"blocks.{i}."):
                out.append(blk.text_kv(context, context_img))
        return out

    def forward(self, hidden_states, timestep, encoder_hidden_states=None,
                encoder_hidden_states_image=None, *, timestep_mask=None,
                text_kv=None, differentiable=False, remat=False):
        """hidden_states [B, C, F, H, W] (latent + condition channels);
        timestep [B] or per-token [B, S]; ``timestep_mask`` [B, S] 0/1
        selects per token between timestep 0 and ``timestep`` (the
        two-level expand path; needs timestep [B]);
        encoder_hidden_states [B, L, text_dim] and
        encoder_hidden_states_image [B, 257, image_dim] (Wan2.1 I2V, the
        CLIP penultimate states), both unused when ``text_kv`` (from
        ``precompute_text_kv``) is given. Returns fp32
        [B, out_channels, F, H, W].

        ``differentiable``: the training forward, under autograd, through
        K6 (no ``text_kv``: the text K/V are projected in the graph).
        ``remat``: with ``differentiable``, recompute each block in the
        backward instead of keeping its activations.

        Under a mesh with dp x fsdp > 1 each rank runs its slice of the
        batch (``parallel.sharding.batch_slice``; of every argument,
        ``text_kv`` included) and the output is gathered over the ranks.
        The differentiable forward under a mesh (sp = 1) takes the rank's
        own examples and returns its own output: the train step cuts the
        batch."""
        if not differentiable:
            with torch.no_grad():
                if self.mesh is None or self.mesh.batch == 1:
                    return self._forward(hidden_states, timestep,
                                         encoder_hidden_states,
                                         encoder_hidden_states_image,
                                         timestep_mask, text_kv, False, False)
                return self._forward_dp(hidden_states, timestep,
                                        encoder_hidden_states, timestep_mask,
                                        text_kv)
        if self.mesh is not None and self.mesh.sp > 1:
            raise NotImplementedError(attn_ops.SP_TRAINING_NOT_PORTED)
        if text_kv is not None:
            raise ValueError("the differentiable forward projects the text "
                             "K/V in the graph; pass encoder_hidden_states")
        return self._forward(hidden_states, timestep, encoder_hidden_states,
                             encoder_hidden_states_image, timestep_mask, None,
                             True, remat)

    def _forward_dp(self, hidden_states, timestep, encoder_hidden_states,
                    timestep_mask, text_kv):
        """The dp rank's batch slice through ``_forward``, then the slices
        of every dp rank gathered into the full batch."""
        def run(sl):
            def cut(t):
                return None if t is None else t[sl]

            kv = (None if text_kv is None
                  else [(k[sl], v[sl]) for k, v in text_kv])
            return self._forward(hidden_states[sl], cut(timestep),
                                 cut(encoder_hidden_states), None,
                                 cut(timestep_mask), kv, False, False)
        return run_dp(self.mesh, hidden_states.shape[0], run)

    def _forward(self, hidden_states, timestep, encoder_hidden_states,
                 encoder_hidden_states_image, timestep_mask, text_kv,
                 differentiable, remat):
        with self._gathered(self, ""):
            return self._forward_gathered(
                hidden_states, timestep, encoder_hidden_states,
                encoder_hidden_states_image, timestep_mask, text_kv,
                differentiable, remat)

    def _forward_gathered(self, hidden_states, timestep,
                          encoder_hidden_states, encoder_hidden_states_image,
                          timestep_mask, text_kv, differentiable, remat):
        cfg = self.cfg
        d = cfg.inner_dim
        x = hidden_states.to(self.dtype)
        B, _, F, H, W = x.shape
        pt, ph, pw = cfg.patch_size
        grid = (F // pt, H // ph, W // pw)
        cos_np, sin_np = wan_rope_table(cfg.attention_head_dim, *grid,
                                        max_seq_len=cfg.rope_max_seq_len)
        cos = torch.from_numpy(cos_np).to(x.device)
        sin = torch.from_numpy(sin_np).to(x.device)

        pe = self.patch_embedding
        x = dense(_patchify_tokens(x, cfg.patch_size), pe.weight.reshape(d, -1),
                  pe.bias)

        ce = self.condition_embedder
        two_level = timestep_mask is not None
        if two_level:
            if timestep.ndim != 1:
                raise ValueError("timestep_mask requires timestep of shape [B]")
            timestep = torch.stack([torch.zeros_like(timestep), timestep], 1)
        t_freq = sinusoidal_timestep_embedding(timestep.float(), cfg.freq_dim)
        temb = timestep_embedding_mlp(t_freq, ce.time_embedder.linear_1,
                                      ce.time_embedder.linear_2)
        timestep_proj = _lin(silu(temb), ce.time_proj, out_dtype=torch.float32)
        per_token = timestep.ndim == 2 and not two_level
        if two_level:
            sel = timestep_mask.float()[:, :, None]             # [B, S, 1]
            timestep_proj = (timestep_proj.reshape(B, 2, 6, d), sel)
        else:
            timestep_proj = timestep_proj.reshape(B, -1 if per_token else 1,
                                                  6, d)

        context = context_img = None
        if text_kv is None:
            context = pixart_text_projection(
                encoder_hidden_states, ce.text_embedder.linear_1,
                ce.text_embedder.linear_2, out_dtype=x.dtype)
            context_img = self._image_context(encoder_hidden_states_image,
                                              x.dtype)
            # the text K/V's column-parallel projections take it replicated
            context = copy_to_tp(context, None if self.mesh is None
                                 or self.mesh.tp == 1 else self.mesh.tp_group)
        # under sp, the blocks run the rank's rows of the tokens and of
        # every per-token table
        seq_mesh, cut = attn_ops.sequence_cut(
            self.mesh, cfg.num_attention_heads, x.shape[1])
        xb, cos, sin = cut(x, 1), cut(cos), cut(sin)
        if two_level:
            proj_b = (timestep_proj[0], cut(sel, 1))
        else:
            proj_b = (cut(timestep_proj, 1) if per_token else timestep_proj)
        for i in range(len(self.blocks)):
            kv = None if text_kv is None else text_kv[i]
            args = (xb, context, proj_b, cos, sin, kv, differentiable,
                    context_img, seq_mesh)
            if remat:
                # under fsdp the recompute gathers the block's slices again
                xb = checkpoint(self._block, i, *args, use_reentrant=False)
            else:
                xb = self._block(i, *args)
        x = (xb if seq_mesh is None
             else attn_ops.gather_sequence(xb, seq_mesh, dim=1))

        # output AdaLN + projection
        table = self.scale_shift_table.float()                   # [1, 2, D]
        if two_level:
            mod = table[None] + temb[:, :, None, :]              # [B, 2, 2, D]
            hi_mask = sel > 0.5
            shift = torch.where(hi_mask, mod[:, 1, 0][:, None],
                                mod[:, 0, 0][:, None])
            scale = torch.where(hi_mask, mod[:, 1, 1][:, None],
                                mod[:, 0, 1][:, None])
        elif per_token:
            mod = table[None] + temb.reshape(B, -1, 1, d)
            shift, scale = mod[:, :, 0], mod[:, :, 1]
        else:
            mod = table + temb[:, None, :]                       # [B, 2, D]
            shift, scale = mod[:, :1], mod[:, 1:2]
        x = (layer_norm(x, eps=cfg.eps) * (1 + scale) + shift).to(x.dtype)
        x = _lin(x, self.proj_out)
        return _unpatchify_tokens(x, grid, cfg.patch_size,
                                  cfg.out_channels).float()


def init_wan_dit(cfg: WanDiTConfig, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32,
                 mesh: Optional[Mesh] = None) -> WanDiT:
    """Seeded random WanDiT on ``generator``'s device. With a ``mesh``, the
    rank's slice of the same full model (built whole, cut, and freed)."""
    model = WanDiT(cfg, device="meta", dtype=dtype)
    model.to_empty(device=generator.device)
    model.init_random_(generator)
    if mesh is None:
        return model.eval()
    return shard_model(model.eval(), mesh)
