"""CogVideoX video DiT over the joint [text; video] sequence (counterpart of
``frameino_tpu/models/cogvideox_dit.py``).

``CogVideoXDiT`` is an ``nn.Module`` with diffusers
``CogVideoXTransformer3DModel`` parameter names, so a diffusers state dict
and the weight bridge (``models/weights.py``) both load through
``load_state_dict``. The math follows the JAX forward:

- the patch embed projects the text tokens and puts them BEFORE the video
  tokens (a Conv2d patchify, or CogVideoX 1.5's linear one over
  ``patch_size_t`` frames, layout (pt, ph, pw, C)), then adds the joint
  position table when the config has one (the 5B's learned table, the
  2B's fixed sincos; 1.5, RoPE without learned positions, has none); with
  ``use_frame_in`` one more frame of position embeddings is appended,
  sliced at the actual text length (the reference's quirk), and the video
  part is resized to the patch grid with JAX's antialiased trilinear
  filter;
- AdaLN-Zero on the joint sequence as a per-token select over a video
  mask (text and video rows get their own shift/scale/gate);
- the time embedding, plus the ``ofs`` embedding (CogVideoX 1.5's
  ``ofs_embed_dim``) when ``ofs`` is passed;
- joint self-attention with per-head LayerNorm on q/k and RoPE whose
  tables are identity over the text prefix. On CUDA tensors it runs K4
  (LayerNorm + RoPE producer) -> bound -> K1 at head_dim 64
  (``ops/attention.fused_ln_qk_flash_attention``); the 2B (no RoPE) runs
  K3 over the LayerNormed q/k (``ops/attention.
  flash_attention_inference``, JAX's ``dispatch_attention`` ->
  ``_flash_fwd``). On the CPU: the plain path, or the same kernels' plain
  versions with ``attn_impl="fused"``. The training forward
  (``differentiable=True``) takes JAX's route instead, which refuses the
  fused producer under autograd: the plain per-head LayerNorm and RoPE,
  then K6
  (``ops/attention.flash_attention_train``; its plain version on the CPU);
- gelu_tanh FFN, ``norm_final`` over the joint sequence (the 2B: over the
  video tokens only), ``norm_out``, ``proj_out`` and the unpatchify (over
  ``patch_size_t`` frames too in 1.5).

The forward runs in the weights' dtype (bf16 at full width): it casts its
inputs to that dtype and returns fp32. It runs under ``torch.no_grad``
unless ``differentiable``; ``remat`` then recomputes each block in the
backward (``torch.utils.checkpoint``, the counterpart of
``jax.checkpoint``). Layout is the JAX package's, frame-first:
hidden_states [B, F, C, H, W].

Where the JAX forward raises, the port takes the intended value: JAX
sizes the appended ``use_frame_in`` slice as (table tokens) // (F - 1),
which is one frame only when F is the table's frame count + 1, and adds
the table without slicing when the sample grid matches; the port appends
one table frame (ph * pw tokens) and always slices to the sequence. Both
equal JAX wherever JAX runs (ROADMAP queue 3).

Under a dp x fsdp x tp x sp ``mesh`` (``core/meshes.py``), one process
runs per rank and ``CogVideoXDiT(cfg, mesh=mesh)`` holds blocks of the
rank's width (``parallel/sharding.py``): H/tp heads of to_q/to_k/to_v and 4 D/tp of
the FFN's hidden width; the row-parallel to_out and ff.net.2 all-reduce
their fp32 partial products over tp and add their bias once. Each rank
runs its slice of the batch, cut over (dp, fsdp), the output gathered
over them; under fsdp the fsdp-cut tensors are gathered as the Wan DiT
gathers them (``models/wan_dit.py``), a block's around the block, the
top level's (patch embed and position table, time and final layers)
around the forward. The routes are
JAX's: on an sp = 1 mesh the 5B and 1.5 take K4 -> bound -> K1 on the
rank's heads (``ops/attention.fused_ln_qk_flash_attention`` with the
rank's head count, the body of JAX's sharded function: the per-head
LayerNorm needs no collective); the 2B the per-head LayerNorm,
then ``dispatch_attention`` (K3 on the rank's heads). With sp > 1 each sp
rank runs its contiguous slice of the joint tokens, cut after the patch
embed and the position table (with the identity-padded RoPE rows and the
video mask) and gathered over sp before ``norm_final``: the per-head
LayerNorm and RoPE as plain ops, then ``dispatch_attention`` (K3 over the
keys and values gathered over sp, or the fp32 ring); a sequence that sp
does not divide runs whole on every sp rank (K3, no sp collective). Every
rank is called with the same full-batch arguments and returns the same
full-batch output.

The training forward runs under a dp x fsdp x tp mesh (sp = 1) on the
rank's own examples, as the Wan DiT's does: K6 at D = 64 on the rank's
heads; the per-head LayerNorm, replicated over tp and applied to the
rank's heads only, takes its weights through ``copy_to_tp``, so that
their gradients are summed over tp.

Not ported (ROADMAP queue 1 item 12): the pp path and training under
sp > 1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from frameino_tpu_torch.core.meshes import Mesh, check_supported
from frameino_tpu_torch.models.quant import linear as _lin
from frameino_tpu_torch.ops import attention as attn_ops
from frameino_tpu_torch.ops.embeddings import (cogvideox_3d_sincos_pos_embed,
                                               sinusoidal_timestep_embedding,
                                               timestep_embedding_mlp)
from frameino_tpu_torch.ops.linear import dense, gelu_tanh, silu
from frameino_tpu_torch.ops.norms import layer_norm
from frameino_tpu_torch.ops.resize import resize_antialiased
from frameino_tpu_torch.ops.rope import (apply_rope_interleaved,
                                         cogvideox_rope_table)
from frameino_tpu_torch.parallel.collectives import copy_to_tp
from frameino_tpu_torch.parallel.sharding import (gathered, mesh_cuts,
                                                 row_parallel, run_dp,
                                                 shard_model)

@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    num_attention_heads: int = 48
    attention_head_dim: int = 64
    in_channels: int = 32
    out_channels: int = 16
    time_embed_dim: int = 512
    ofs_embed_dim: Optional[int] = None
    text_embed_dim: int = 4096
    num_layers: int = 42
    attention_bias: bool = True
    sample_width: int = 90
    sample_height: int = 60
    sample_frames: int = 49
    patch_size: int = 2
    patch_size_t: Optional[int] = None
    temporal_compression_ratio: int = 4
    max_text_seq_length: int = 226
    norm_eps: float = 1e-5
    qk_norm_eps: float = 1e-6
    spatial_interpolation_scale: float = 1.875
    temporal_interpolation_scale: float = 1.0
    use_rotary_positional_embeddings: bool = True
    use_learned_positional_embeddings: bool = True
    use_frame_in: bool = False
    freq_shift: int = 0

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def has_pos_embedding(self) -> bool:
        """The joint position table: learned (5B) or the 2B's fixed sincos;
        CogVideoX 1.5 (RoPE, no learned positions) has none."""
        return (not self.use_rotary_positional_embeddings
                or self.use_learned_positional_embeddings)


# CogVideoX-5B-I2V; motion (Stage 1): in_channels 48 = 16 noisy + 16 image
# + 16 trajectory latent channels; FrameINO (Stage 2): also one extra ID
# frame of positions
COGVIDEOX_5B_I2V = CogVideoXConfig()
COGVIDEOX_5B_I2V_MOTION = dataclasses.replace(COGVIDEOX_5B_I2V,
                                              in_channels=48)
COGVIDEOX_5B_I2V_FRAMEINO = dataclasses.replace(COGVIDEOX_5B_I2V,
                                                in_channels=48,
                                                use_frame_in=True)


def tiny_config(**kw) -> CogVideoXConfig:
    base = dict(num_attention_heads=2, attention_head_dim=16, in_channels=12,
                out_channels=4, time_embed_dim=16, text_embed_dim=16,
                num_layers=2, sample_width=8, sample_height=8,
                sample_frames=9, max_text_seq_length=8)
    base.update(kw)
    return CogVideoXConfig(**base)


# ---------------------------------------------------------------------------
# Modules (diffusers names)
# ---------------------------------------------------------------------------

class _TwoLinear(nn.Module):
    """TimestepEmbedding parameter holder."""

    def __init__(self, d_in, d_out, **kw):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d_out, **kw)
        self.linear_2 = nn.Linear(d_out, d_out, **kw)


class _PatchEmbed(nn.Module):
    """CogVideoXPatchEmbed: Conv2d patchify (1.5: a Linear over
    ``patch_size_t`` frames), text projection, the joint table if any."""

    def __init__(self, cfg: CogVideoXConfig, **kw):
        super().__init__()
        d, p = cfg.inner_dim, cfg.patch_size
        if cfg.patch_size_t is None:
            self.proj = nn.Conv2d(cfg.in_channels, d, p, stride=p, **kw)
        else:
            self.proj = nn.Linear(cfg.in_channels * p * p * cfg.patch_size_t,
                                  d, **kw)
        self.text_proj = nn.Linear(cfg.text_embed_dim, d, **kw)
        ph, pw = cfg.sample_height // p, cfg.sample_width // p
        pf = (cfg.sample_frames - 1) // cfg.temporal_compression_ratio + 1
        self.register_buffer("pos_embedding", torch.empty(
            1, cfg.max_text_seq_length + pf * ph * pw, d, **kw)
            if cfg.has_pos_embedding else None)

    def default_pos_embedding(self, cfg: CogVideoXConfig) -> torch.Tensor:
        """Zeros over the text slots, 3D sincos over the sample patch
        grid (diffusers ``_get_positional_embeddings``)."""
        p = cfg.patch_size
        ph, pw = cfg.sample_height // p, cfg.sample_width // p
        pf = (cfg.sample_frames - 1) // cfg.temporal_compression_ratio + 1
        pos = cogvideox_3d_sincos_pos_embed(
            cfg.inner_dim, ph, pw, pf, cfg.spatial_interpolation_scale,
            cfg.temporal_interpolation_scale).reshape(pf * ph * pw, -1)
        joint = np.zeros((1, cfg.max_text_seq_length + pos.shape[0],
                          cfg.inner_dim), np.float32)
        joint[:, cfg.max_text_seq_length:] = pos
        return torch.from_numpy(joint)


class _LayerNormZero(nn.Module):
    """CogVideoXLayerNormZero / AdaLayerNorm parameter holder."""

    def __init__(self, temb_dim, d, n_chunks, eps, **kw):
        super().__init__()
        self.linear = nn.Linear(temb_dim, n_chunks * d, **kw)
        self.norm = nn.LayerNorm(d, eps=eps, **kw)


class _Attention(nn.Module):
    """q/k/v column-parallel and to_out row-parallel over ``tp`` ranks: a
    rank holds d/tp of their heads; the per-head LayerNorm is shared."""

    def __init__(self, cfg: CogVideoXConfig, tp: int = 1, **kw):
        super().__init__()
        d, hd = cfg.inner_dim, cfg.attention_head_dim
        d_l = d // tp
        bias = cfg.attention_bias
        self.to_q = nn.Linear(d, d_l, bias=bias, **kw)
        self.to_k = nn.Linear(d, d_l, bias=bias, **kw)
        self.to_v = nn.Linear(d, d_l, bias=bias, **kw)
        self.to_out = nn.ModuleList([nn.Linear(d_l, d, **kw),
                                     nn.Dropout(0.0)])
        self.norm_q = nn.LayerNorm(hd, eps=cfg.qk_norm_eps, **kw)
        self.norm_k = nn.LayerNorm(hd, eps=cfg.qk_norm_eps, **kw)


class _GeluProj(nn.Module):
    def __init__(self, d_in, d_out, **kw):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out, **kw)


class _FeedForward(nn.Module):
    def __init__(self, d, tp: int = 1, **kw):
        super().__init__()
        self.net = nn.ModuleList([_GeluProj(d, 4 * d // tp, **kw),
                                  nn.Dropout(0.0),
                                  nn.Linear(4 * d // tp, d, **kw)])


def _split_heads(x, num_heads):
    B, S, D = x.shape
    return x.reshape(B, S, num_heads, D // num_heads).permute(0, 2, 1, 3)


def _merge_heads(x):
    B, H, S, Dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, S, H * Dh)


def _adaln_zero(norm: _LayerNormZero, x, temb, eps, video_mask):
    """CogVideoXLayerNormZero on the joint sequence: both streams are
    per-token affine, so a per-token select over ``video_mask`` [1, S, 1]
    (0 text, 1 video) replaces the reference's split and concat. Returns
    (normed x in x's dtype, fp32 gate)."""
    mod = _lin(silu(temb.float()), norm.linear, out_dtype=torch.float32)
    shift, scale, gate, e_shift, e_scale, e_gate = mod.chunk(6, dim=-1)
    m = video_mask

    def sel(v, e):
        return e[:, None] + (v[:, None] - e[:, None]) * m

    nx = layer_norm(x, norm.norm.weight, norm.norm.bias, eps=eps) \
        * (1 + sel(scale, e_scale)) + sel(shift, e_shift)
    return nx.to(x.dtype), sel(gate, e_gate)


class CogVideoXBlock(nn.Module):
    """CogVideoXBlock on the joint [text; video] sequence (this rank's
    width under a mesh)."""

    def __init__(self, cfg: CogVideoXConfig, mesh: Optional[Mesh] = None,
                 **kw):
        super().__init__()
        d = cfg.inner_dim
        tp = 1 if mesh is None else mesh.tp
        self.cfg = cfg
        self.mesh = mesh
        self.tp_group = mesh.tp_group if tp > 1 else None
        self.heads = cfg.num_attention_heads // tp        # this rank's
        self.norm1 = _LayerNormZero(cfg.time_embed_dim, d, 6, cfg.norm_eps,
                                    **kw)
        self.attn1 = _Attention(cfg, tp, **kw)
        self.norm2 = _LayerNormZero(cfg.time_embed_dim, d, 6, cfg.norm_eps,
                                    **kw)
        self.ff = _FeedForward(d, tp, **kw)

    def _attention(self, x, cos_j, sin_j, kernels: bool,
                   differentiable: bool, seq_mesh=None):
        cfg, a = self.cfg, self.attn1
        H = self.heads
        q, k = _lin(x, a.to_q), _lin(x, a.to_k)
        v = _split_heads(_lin(x, a.to_v), H)
        if kernels and cos_j is not None and not differentiable and (
                self.mesh is None or attn_ops.fused_sharded_supported(
                    self.mesh, x.shape[0] * self.mesh.dp,
                    cfg.num_attention_heads)):
            # K4 (LayerNorm + RoPE producer) -> bound -> K1, on the rank's
            # heads under a mesh
            args = (q, k, v.contiguous(), a.norm_q.weight, a.norm_q.bias,
                    a.norm_k.weight, a.norm_k.bias, cos_j, sin_j)
            o = attn_ops.fused_ln_qk_flash_attention(
                *args, num_heads=H, eps=cfg.qk_norm_eps)
        else:
            tp = self.tp_group

            def head_norm(t, norm):
                # the weights replicated over tp on the rank's heads: under
                # autograd their gradients are summed over tp
                return layer_norm(_split_heads(t, H),
                                  copy_to_tp(norm.weight, tp),
                                  copy_to_tp(norm.bias, tp),
                                  eps=cfg.qk_norm_eps).to(t.dtype)

            q, k = head_norm(q, a.norm_q), head_norm(k, a.norm_k)
            if cos_j is not None:
                q = apply_rope_interleaved(q, cos_j, sin_j)
                k = apply_rope_interleaved(k, cos_j, sin_j)
            if differentiable:
                o = attn_ops.dispatch_attention(                # K6
                    q.contiguous(), k.contiguous(), v.contiguous(),
                    mesh=self.mesh, differentiable=True)
            elif self.mesh is not None:
                # K3 on the rank's heads: over the keys gathered over sp (or
                # the ring) where seq_mesh cuts the sequence
                o = attn_ops.dispatch_attention(q, k, v, mesh=seq_mesh)
            elif kernels:
                o = attn_ops.flash_attention_inference(q, k, v)  # K3
            else:
                o = attn_ops.attention_ref(q, k, v)
        return row_parallel(_merge_heads(o), a.to_out[0], self.tp_group)

    def forward(self, x, temb, cos_j, sin_j, video_mask, kernels: bool,
                differentiable: bool = False, seq_mesh=None):
        """``seq_mesh``: the mesh when x, the tables and the mask are the
        rank's sequence shard (sp > 1), else None."""
        eps, tp = self.cfg.norm_eps, self.tp_group
        # each column-parallel layer's replicated input passes through
        # copy_to_tp: under autograd its gradient is summed over tp
        nx, gate = _adaln_zero(self.norm1, x, temb, eps, video_mask)
        a = self._attention(copy_to_tp(nx, tp), cos_j, sin_j, kernels,
                            differentiable, seq_mesh)
        x = x + (gate * a.float()).to(x.dtype)
        nx, gate_ff = _adaln_zero(self.norm2, x, temb, eps, video_mask)
        f = row_parallel(gelu_tanh(_lin(copy_to_tp(nx, tp),
                                        self.ff.net[0].proj)),
                         self.ff.net[2], self.tp_group)
        return x + (gate_ff * f.float()).to(x.dtype)


class CogVideoXDiT(nn.Module):
    """CogVideoXTransformer3DModel: the 5B (RoPE + learned positions), 1.5
    (``patch_size_t``, ``ofs_embed_dim``, RoPE alone) and 2B (sincos
    positions, no RoPE) layouts.

    Build with ``device="meta"`` and then ``to_empty`` + ``init_random_``
    or ``load_state_dict(..., assign=True)`` to skip torch's default init.
    With a ``mesh`` the block layers have this rank's width and the
    fsdp-cut tensors this rank's slice (``cuts``): load
    ``parallel.sharding.shard_state_dict`` of a full state dict.
    """

    def __init__(self, cfg: CogVideoXConfig, device=None, dtype=None,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.inner_dim
        p = cfg.patch_size
        if mesh is not None:
            check_supported(mesh.cfg)
            if cfg.num_attention_heads % mesh.tp or 4 * d % mesh.tp:
                raise ValueError(f"{cfg.num_attention_heads} heads and FFN "
                                 f"width {4 * d} must divide over "
                                 f"tp={mesh.tp}")
        self.cfg = cfg
        self.mesh = mesh
        self.patch_embed = _PatchEmbed(cfg, **kw)
        self.time_embedding = _TwoLinear(d, cfg.time_embed_dim, **kw)
        if cfg.ofs_embed_dim:
            self.ofs_embedding = _TwoLinear(cfg.ofs_embed_dim,
                                            cfg.ofs_embed_dim, **kw)
        self.transformer_blocks = nn.ModuleList(
            [CogVideoXBlock(cfg, mesh, **kw) for _ in range(cfg.num_layers)])
        self.norm_final = nn.LayerNorm(d, eps=cfg.norm_eps, **kw)
        self.norm_out = _LayerNormZero(cfg.time_embed_dim, d, 2, cfg.norm_eps,
                                       **kw)
        self.proj_out = nn.Linear(
            d, cfg.out_channels * p * p * (cfg.patch_size_t or 1), **kw)
        self.cuts, self._fsdp = mesh_cuts(self, mesh)

    @property
    def dtype(self) -> torch.dtype:
        return self.proj_out.weight.dtype

    def _gathered(self, module, prefix):
        """A context in which ``module`` (the DiT itself for prefix "",
        or block ``prefix``) holds its fsdp-cut tensors whole."""
        return gathered(module, self._fsdp.get(prefix), self.mesh)

    def _block(self, i, *args):
        blk = self.transformer_blocks[i]
        with self._gathered(blk, f"transformer_blocks.{i}."):
            return blk(*args)

    def trained_buffers(self):
        """{name: buffer} of the buffers that training updates: the joint
        position table. diffusers keeps it a buffer that no optimizer sees;
        the JAX package holds it in the parameter tree, so its train step
        differentiates and updates it, and so does the port's. Empty
        without a table (1.5)."""
        if self.patch_embed.pos_embedding is None:
            return {}
        return {"patch_embed.pos_embedding": self.patch_embed.pos_embedding}

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Seeded init mirroring ``init_cogvideox_dit``: uniform(+-1/
        sqrt(fan_in)) for dense and patch weights and biases, unit norm
        gains, zero norm biases, the sincos position table. Draws in fp32 on
        ``generator``'s device, then casts into each parameter."""
        def fill_uniform(p, fan_in):
            bound = fan_in ** -0.5
            r = torch.rand(p.shape, generator=generator,
                           device=generator.device, dtype=torch.float32)
            p.copy_(r.mul_(2 * bound).sub_(bound))

        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                fill_uniform(mod.weight, fan_in)
                if mod.bias is not None:
                    fill_uniform(mod.bias, fan_in)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        pe = self.patch_embed
        if pe.pos_embedding is not None:
            pe.pos_embedding.copy_(pe.default_pos_embedding(self.cfg))
        return self

    def _patch_embed(self, text, video):
        """text [B, L, text_dim]; video [B, F, C, H, W] -> [B, L+S, D]."""
        cfg, pe = self.cfg, self.patch_embed
        d, ps = cfg.inner_dim, cfg.patch_size
        B, F, C, H, W = video.shape
        text = _lin(text, pe.text_proj)
        L = text.shape[1]
        pt = cfg.patch_size_t
        if pt is None:
            v = video.reshape(B, F, C, H // ps, ps, W // ps, ps)
            v = v.permute(0, 1, 3, 5, 2, 4, 6).reshape(
                B, F * (H // ps) * (W // ps), C * ps * ps)
        else:
            # CogVideoX 1.5's linear patchify: layout (pt, ph, pw, C)
            if F % pt:
                raise ValueError(f"CogVideoX 1.5 takes a multiple of "
                                 f"patch_size_t={pt} latent frames, got {F}")
            v = video.permute(0, 1, 3, 4, 2).reshape(
                B, F // pt, pt, H // ps, ps, W // ps, ps, C)
            v = v.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
                B, (F // pt) * (H // ps) * (W // ps), pt * ps * ps * C)
        v = dense(v, pe.proj.weight.reshape(d, -1), pe.proj.bias)
        embeds = torch.cat([text, v], dim=1)

        pos = pe.pos_embedding
        if pos is None:
            return embeds
        ph, pw = cfg.sample_height // ps, cfg.sample_width // ps
        post_t = (cfg.sample_frames - 1) // cfg.temporal_compression_ratio + 1
        if cfg.use_frame_in:
            # one more frame, sliced at the ACTUAL text length L (the
            # reference's quirk; L == max_text_seq_length in practice)
            pos = torch.cat([pos, pos[:, L:L + ph * pw]], dim=1)
            post_t += 1
        pre_t_frames = (F - 1) * cfg.temporal_compression_ratio + 1
        seq_length = H * W * F // (ps * ps)
        if (cfg.sample_height != H or cfg.sample_width != W
                or cfg.sample_frames != pre_t_frames):
            if L != cfg.max_text_seq_length:
                # the resized table starts at L: only a full-length prompt
                # leaves exactly the video slots after it (JAX fails too)
                raise ValueError(
                    f"CogVideoX takes prompt embeddings of "
                    f"{cfg.max_text_seq_length} tokens off the sample grid, "
                    f"got {L}")
            pv = pos[:, L:].reshape(1, post_t, ph, pw, d).float()
            pv = resize_antialiased(pv, (1, F, H // ps, W // ps, d))
            pos = torch.cat([pos[:, :L], pv.reshape(1, -1, d).to(pos.dtype)],
                            dim=1)
        return embeds + pos[:, :L + seq_length].to(embeds.dtype)

    def forward(self, hidden_states, encoder_hidden_states, timestep,
                image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]],
                ofs=None, *, attn_impl: Optional[str] = None,
                differentiable: bool = False, remat: bool = False):
        """hidden_states [B, F, C, H, W]; encoder_hidden_states
        [B, L, text_dim]; timestep [B]; image_rotary_emb: the (cos, sin)
        [F/pt*h*w, head_dim/2] tables of the video tokens (None for the
        2B, which has no RoPE); ``ofs`` [B]: 1.5's ofs embedding input.
        ``attn_impl``: None takes the kernels on CUDA and the plain path
        on the CPU; "fused" takes ``fused_ln_qk_flash_attention`` (the
        2B: K3; on the CPU their plain versions); "xla" the plain path,
        CPU only. Returns fp32 [B, F, out_channels, H, W].

        ``differentiable``: the training forward under autograd, through
        K6 (no fused producer, whatever ``attn_impl``). ``remat``: with
        ``differentiable``, recompute each block in the backward instead
        of keeping its activations.

        Under a mesh the kernels run (their plain versions on the CPU;
        ``attn_impl`` "xla" is refused), and with dp x fsdp > 1 each rank
        runs its slice of the batch (of every argument;
        ``parallel.sharding.batch_slice``), the output gathered over the
        ranks. The differentiable forward under a mesh (sp = 1) takes the
        rank's own examples and returns its own output: the train step
        cuts the batch."""
        if attn_impl not in (None, "fused", "xla"):
            raise ValueError(f"attn_impl must be None, 'fused' or 'xla', got "
                             f"{attn_impl!r}")
        if attn_impl == "xla" and (hidden_states.is_cuda
                                   or self.mesh is not None):
            raise ValueError("attn_impl='xla' is the CPU plain path without "
                             "a mesh; CUDA tensors and meshes run the "
                             "kernels")
        if not differentiable:
            with torch.no_grad():
                if self.mesh is not None and self.mesh.batch > 1:
                    return self._forward_dp(hidden_states,
                                            encoder_hidden_states, timestep,
                                            image_rotary_emb, ofs, attn_impl)
                return self._forward(hidden_states, encoder_hidden_states,
                                     timestep, image_rotary_emb, ofs,
                                     attn_impl, False, False)
        if self.mesh is not None and self.mesh.sp > 1:
            raise NotImplementedError(attn_ops.SP_TRAINING_NOT_PORTED)
        return self._forward(hidden_states, encoder_hidden_states, timestep,
                             image_rotary_emb, ofs, attn_impl, True, remat)

    def _forward_dp(self, hidden_states, encoder_hidden_states, timestep,
                    image_rotary_emb, ofs, attn_impl):
        """The dp rank's batch slice through ``_forward``, then the slices
        of every dp rank gathered into the full batch."""
        return run_dp(self.mesh, hidden_states.shape[0], lambda sl: (
            self._forward(hidden_states[sl], encoder_hidden_states[sl],
                          timestep[sl], image_rotary_emb,
                          None if ofs is None else ofs[sl], attn_impl,
                          False, False)))

    def _forward(self, hidden_states, encoder_hidden_states, timestep,
                 image_rotary_emb, ofs, attn_impl, differentiable, remat):
        with self._gathered(self, ""):
            return self._forward_gathered(
                hidden_states, encoder_hidden_states, timestep,
                image_rotary_emb, ofs, attn_impl, differentiable, remat)

    def _forward_gathered(self, hidden_states, encoder_hidden_states,
                          timestep, image_rotary_emb, ofs, attn_impl,
                          differentiable, remat):
        cfg = self.cfg
        x = hidden_states.to(self.dtype)
        B, F, C, H, W = x.shape
        kernels = not differentiable and (
            self.mesh is not None or attn_impl == "fused"
            or (attn_impl is None and x.is_cuda))

        te = self.time_embedding
        t_freq = sinusoidal_timestep_embedding(
            timestep.float().to(x.device), cfg.inner_dim,
            downscale_freq_shift=float(cfg.freq_shift))
        emb = timestep_embedding_mlp(t_freq, te.linear_1, te.linear_2)
        if cfg.ofs_embed_dim and ofs is not None:
            oe = self.ofs_embedding
            ofs_freq = sinusoidal_timestep_embedding(
                ofs.float().to(x.device), cfg.ofs_embed_dim)
            emb = emb + timestep_embedding_mlp(ofs_freq, oe.linear_1,
                                               oe.linear_2)

        x = self._patch_embed(encoder_hidden_states.to(x.device, self.dtype),
                              x)
        L = encoder_hidden_states.shape[1]
        S = x.shape[1]
        video_mask = torch.cat([torch.zeros(L, device=x.device),
                                torch.ones(S - L, device=x.device)]
                               )[None, :, None]
        cos_j = sin_j = None
        if image_rotary_emb is not None:
            cos, sin = (t.float().to(x.device) for t in image_rotary_emb)
            half = cos.shape[-1]
            cos_j = torch.cat([torch.ones(L, half, device=x.device), cos])
            sin_j = torch.cat([torch.zeros(L, half, device=x.device), sin])
        # under sp, the blocks run the rank's rows of the joint tokens, of
        # the RoPE tables and of the video mask
        seq_mesh, cut = attn_ops.sequence_cut(
            self.mesh, cfg.num_attention_heads, S)
        xb, video_mask = cut(x, 1), cut(video_mask, 1)
        if cos_j is not None:
            cos_j, sin_j = cut(cos_j), cut(sin_j)
        for i in range(len(self.transformer_blocks)):
            args = (xb, emb, cos_j, sin_j, video_mask, kernels,
                    differentiable, seq_mesh)
            if remat:
                # under fsdp the recompute gathers the block's slices again
                xb = checkpoint(self._block, i, *args, use_reentrant=False)
            else:
                xb = self._block(i, *args)
        # the whole sequence again before norm_final (the 2B's slice at L
        # may straddle a rank's rows)
        x = (xb if seq_mesh is None
             else attn_ops.gather_sequence(xb, seq_mesh, dim=1))

        if not cfg.use_rotary_positional_embeddings:
            # 2B: norm over the video stream only
            h = layer_norm(x[:, L:], self.norm_final.weight,
                           self.norm_final.bias, eps=cfg.norm_eps).to(x.dtype)
        else:
            # 5B and 1.5: norm over the joint sequence, then the video span
            h = layer_norm(x, self.norm_final.weight, self.norm_final.bias,
                           eps=cfg.norm_eps).to(x.dtype)[:, L:]
        no = self.norm_out
        mod = _lin(silu(emb.float()), no.linear, out_dtype=torch.float32)
        shift, scale = mod.chunk(2, dim=-1)
        h = layer_norm(h, no.norm.weight, no.norm.bias, eps=cfg.norm_eps)
        h = (h * (1 + scale[:, None]) + shift[:, None]).to(x.dtype)
        h = _lin(h, self.proj_out)
        p, pt = cfg.patch_size, cfg.patch_size_t
        if pt is None:
            out = h.reshape(B, F, H // p, W // p, -1, p, p)
            out = out.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, F, -1, H, W)
        else:
            out = h.reshape(B, F // pt, H // p, W // p, -1, pt, p, p)
            out = out.permute(0, 1, 5, 4, 2, 6, 3, 7).reshape(B, F, -1, H, W)
        return out.float()


def cogvideox_rope(cfg: CogVideoXConfig, F: int, H: int, W: int,
                   duplicate_first_frame_for_id: bool = False, device=None):
    """RoPE (cos, sin) tables of the latent patch grid F x H/p x W/p, as
    copies of the cached numpy tables."""
    cos, sin = cogvideox_rope_table(
        cfg.attention_head_dim, F, H // cfg.patch_size, W // cfg.patch_size,
        base_h=cfg.sample_height // cfg.patch_size,
        base_w=cfg.sample_width // cfg.patch_size,
        duplicate_first_frame_for_id=duplicate_first_frame_for_id)
    return (torch.tensor(cos, device=device),
            torch.tensor(sin, device=device))


def init_cogvideox_dit(cfg: CogVideoXConfig, generator: torch.Generator,
                       dtype: torch.dtype = torch.float32,
                       mesh: Optional[Mesh] = None) -> CogVideoXDiT:
    """Seeded random CogVideoXDiT on ``generator``'s device. With a
    ``mesh``, the rank's slice of the same full model (built whole, cut,
    and freed)."""
    model = CogVideoXDiT(cfg, device="meta", dtype=dtype)
    model.to_empty(device=generator.device)
    model.init_random_(generator)
    if mesh is None:
        return model.eval()
    return shard_model(model.eval(), mesh)
